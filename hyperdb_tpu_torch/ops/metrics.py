"""Dense similarity metrics as plain tensor code.

Every metric maps a ``(B, d)`` query block and an ``(N, d)`` corpus block
to a ``(B, N)`` similarity matrix (the materialising route). Scores always
accumulate in float32: low-precision operands are upcast first, which is
exact for the products (a bf16 x bf16 or f16 x f16 product fits f32), and
float32 matmuls run in true f32 because the package disables TF32 at import.

Semantics (reference ranking_algorithm.py:24-147):

- all metrics are "higher is better": euclidean and manhattan distances
  become ``1/(1+dist)``, hamming becomes ``d - dist``;
- jaccard/hamming binarize with ``x > 0`` without mutating the inputs;
- pearson is NaN whenever the query or a row is constant, jaccard of two
  all-zero vectors is 0/0 = NaN; the rankers turn NaN into -inf;
- zero-norm vectors normalize with their norm taken as 1.

The JAX package's dot-precision rule (``dot_precision``: true f32 whenever
an operand is f32, native precision only for f16/bf16 pairs) holds here as
follows: every product on this route is f32 over upcast operands, which is
exact for low-precision inputs, and only bf16 pairs reach the bf16 stage-1
kernels (``ops/gmax.supported``).
"""

from __future__ import annotations

import numpy as np
import torch


def pearson_center_normalize(x: np.ndarray) -> np.ndarray:
    """IN PLACE: center + unit-normalize rows of an OWNED float32 array.

    The host-side transform behind the pearson-as-dot plane and query block
    (``store.pearson_view``, the engine's pearson branch): pearson(q, v) ==
    dot(T(q), T(v)) for T = this function. Constant rows divide 0/0 -> NaN
    ON PURPOSE — every ranking route scrubs NaN -> -inf after its product,
    which is the reference's constant-vector contract
    (ranking_algorithm.py:107-111). In place so the full-corpus plane build
    needs exactly one (n_pad, d) f32 temp; callers pass an array they own,
    never user data.
    """
    x -= x.mean(axis=1, keepdims=True)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        x /= norms  # constant rows -> NaN rows (intended)
    return x


# Canonical query-metric names (reference hyperdb.py:1449).
METRICS = (
    "dot_product",
    "cosine_similarity",
    "euclidean_metric",
    "manhattan_distance",
    "jaccard_similarity",
    "pearson_correlation",
    "hamming_distance",
)

LOW_PRECISION = (torch.float16, torch.bfloat16)

# Row tile of the manhattan scan: bounds the (B, tile, d) difference block.
_MANHATTAN_TILE = 2048


def normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2-normalize along ``dim`` in float32; zero norms are treated as 1.

    The result is float32 whatever the input dtype, as in the JAX package
    (a low-precision array divided by its f32 norm promotes to f32)."""
    x32 = x.float()
    n = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    n = torch.where(n == 0, torch.ones_like(n), n)
    return x32 / n


def _match_low_precision(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cast a (small) query block to the corpus dtype when the corpus is
    f16/bf16, so the scan runs on low-precision operands instead of
    promoting the corpus to f32. Covers f32 queries AND mismatched
    low-precision wires (an f16 query against the bf16 plane)."""
    if (
        v.dtype in LOW_PRECISION
        and q.dtype in (torch.float32, torch.float16, torch.bfloat16)
        and q.dtype != v.dtype
    ):
        return q.to(v.dtype)
    return q


def qv_dot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, d) x (N, d) -> (B, N) inner products, f32 accumulation."""
    return q.float() @ v.float().T


def dot_f32(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, d) x (R, d) -> (B, R) inner products with f32 accumulation and
    f32 output. On the card a bf16/f16 pair multiplies as it is and only the
    output is f32, so the corpus block is not upcast; elsewhere both sides
    are upcast first. Either way the products are exact in f32."""
    if q.is_cuda and q.dtype == v.dtype and q.dtype in LOW_PRECISION:
        return torch.mm(q, v.T, out_dtype=torch.float32)
    return q.float() @ v.float().T


def dot_scores(q, v):
    """Raw inner products (ranking_algorithm.py:24-30)."""
    return qv_dot(q, v)


def cosine_scores(q, v):
    """Cosine similarity (ranking_algorithm.py:32-42)."""
    # normalize() returns f32, so both sides score in f32 (as in JAX, where
    # the normalized corpus is promoted to f32 before the match)
    return qv_dot(normalize(q), normalize(v))


def cosine_scores_prenormalized(q, v_normalized):
    """Cosine against a corpus whose rows are already unit-norm."""
    return qv_dot(_match_low_precision(normalize(q), v_normalized), v_normalized)


def euclidean_scores(q, v):
    """1/(1 + L2 distance) (ranking_algorithm.py:44-52), expanded as
    |v|^2 - 2 q.v + |q|^2 so the work is one matmul.

    The expansion runs in float64 and only the score is rounded to f32: in
    f32 the three terms of a row's distance to itself (or to a near copy)
    cancel to a residue of a few ulps of |v|^2, which the square root
    turns into a score gap of ~3e-3 (a self-match at 0.9972 instead of
    1.0). The f64 products of f32 (or narrower) operands are exact, so the
    residue drops below 1e-15 and the score agrees with the reference's
    difference form ``sqrt(sum((q - v)^2))``."""
    q64, v64 = q.double(), v.double()
    d2 = (
        torch.sum(v64 * v64, dim=-1)[None, :]
        - 2.0 * (q64 @ v64.T)
        + torch.sum(q64 * q64, dim=-1)[:, None]
    )
    return (1.0 / (1.0 + torch.sqrt(torch.clamp(d2, min=0.0)))).float()


def manhattan_scores(q, v):
    """1/(1 + L1 distance) (ranking_algorithm.py:54-61), over row tiles so
    the (B, tile, d) difference block stays bounded."""
    q32 = q.float()
    parts = [
        torch.sum(torch.abs(v[a : a + _MANHATTAN_TILE].float()[None] - q32[:, None]), dim=-1)
        for a in range(0, v.shape[0], _MANHATTAN_TILE)
    ]
    return 1.0 / (1.0 + torch.cat(parts, dim=1))


def _binarize(x):
    return (x > 0).float()


def jaccard_scores(q, v):
    """Jaccard over binarized vectors (ranking_algorithm.py:63-75); an
    all-zero pair gives 0/0 = NaN."""
    qb, vb = _binarize(q), _binarize(v)
    inter = qv_dot(qb, vb)
    union = vb.sum(dim=-1)[None, :] + qb.sum(dim=-1)[:, None] - inter
    return inter / union


def hamming_scores(q, v):
    """d - hamming distance over binarized vectors (ranking_algorithm.py:128-147)."""
    qb, vb = _binarize(q), _binarize(v)
    inter = qv_dot(qb, vb)
    dist = vb.sum(dim=-1)[None, :] + qb.sum(dim=-1)[:, None] - 2.0 * inter
    return float(v.shape[-1]) - dist


def pearson_scores(q, v):
    """Pearson correlation (ranking_algorithm.py:77-113); NaN whenever
    either side is constant."""
    q32, v32 = q.float(), v.float()
    qc = q32 - q32.mean(dim=-1, keepdim=True)
    vc = v32 - v32.mean(dim=-1, keepdim=True)
    num = qc @ vc.T
    den = torch.sqrt(torch.sum(qc * qc, dim=-1))[:, None] * torch.sqrt(
        torch.sum(vc * vc, dim=-1)
    )[None, :]
    r = num / torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.full_like(r, float("nan")), r)


_METRIC_FNS = {
    "dot_product": dot_scores,
    "cosine_similarity": cosine_scores,
    "euclidean_metric": euclidean_scores,
    "manhattan_distance": manhattan_scores,
    "jaccard_similarity": jaccard_scores,
    "pearson_correlation": pearson_scores,
    "hamming_distance": hamming_scores,
}


def scores(q: torch.Tensor, v: torch.Tensor, metric: str) -> torch.Tensor:
    """Dispatch to a metric: (B, d) x (N, d) -> (B, N) similarities."""
    try:
        fn = _METRIC_FNS[metric]
    except KeyError:
        raise ValueError(f"Unknown metric: {metric}") from None
    return fn(q, v)
