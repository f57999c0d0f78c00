"""Scoring + recency + mask + exact top-k, as tensor code around the kernels.

Counterpart of ``hyperdb_tpu/ops/ranking.py`` for the routes of this slice:
the router :func:`rank_top_k`, the plain grouped form
:func:`rank_top_k_grouped`, and the materialising fallback over the seven
metrics. Batches at or above ``CONFIG.pallas_gmax_f_min_batch`` over a bf16
plane go to the stage-1 kernels (``ops/gmax.py``).

Semantics kept from the reference ranker (ranking_algorithm.py:149-204):
NaN scores become -inf before recency is added; masks act as an additive
-inf; ties go to the lower position, which is ``lax.top_k``'s order and the
one the grouped routes rely on (see :func:`exact_top_k`).
"""

from __future__ import annotations

import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.ops import metrics as _metrics
from hyperdb_tpu_torch.ops.metrics import LOW_PRECISION, scores

NEG_INF = float("-inf")

_LOW32 = (1 << 32) - 1


def exact_top_k(s: torch.Tensor, k: int):
    """Exact top-k along the last axis, ties to the LOWER position.

    ``torch.topk`` promises no order among equal values, and the grouped
    routes depend on ``lax.top_k``'s (the earlier entry wins). So each
    score becomes a unique int64 key: its f32 bit pattern mapped onto an
    order-preserving signed integer in the high 32 bits, the complemented
    position in the low 32 bits. The top-k of the keys is then the top-k
    of the scores with ties broken toward the lower position.

    Returns (values, int64 positions), values in descending order.
    """
    bits = s.float().contiguous().view(torch.int32).long()
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    pos = torch.arange(s.shape[-1], device=s.device)
    keys = ordered * (1 << 32) + (_LOW32 - pos)
    top, _ = torch.topk(keys, k, dim=-1)
    idx = _LOW32 - (top & _LOW32)
    return torch.gather(s, -1, idx), idx


def exact_top_k_grouped(s: torch.Tensor, k: int, group: int = 1024):
    """Exact top-k via group-max pre-selection (no wide selection).

    1. per-group max; 2. top-k groups; 3. gather the k winning groups'
    scores; 4. final top-k over the (k * group) candidates. Every row with
    score >= the true k-th score lives in a group whose max >= that score,
    and at most k groups qualify (ties at the k-th value aside)."""
    n = s.shape[-1]
    if n <= k * group or n <= group:
        return exact_top_k(s, k)
    pad = (-n) % group
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    g = s.shape[-1] // group
    lead = s.shape[:-1]
    s3 = s.reshape(*lead, g, group)
    _, gidx = exact_top_k(s3.amax(-1), k)  # (..., k)
    cand = torch.gather(s3, -2, gidx[..., None].expand(*lead, k, group))
    vals, pos = exact_top_k(cand.reshape(*lead, k * group), k)
    winner = torch.gather(gidx, -1, pos // group)
    return vals, winner * group + pos % group


def _auto_group(batch: int) -> int:
    """Group width of the grouped routes (the JAX package's rule)."""
    return 128 if batch >= 128 else 256


def _scrub(s, row_mask=None, recency=None):
    """NaN -> -inf, then + recency, then masked rows -> -inf."""
    s = s.masked_fill(torch.isnan(s), NEG_INF)
    if recency is not None:
        s = s + recency[None, :]
    if row_mask is not None:
        s = s.masked_fill(~row_mask[None, :], NEG_INF)
    return s


def rank_top_k_grouped(
    queries, vectors, k: int, row_mask=None, recency=None, group: int = 128
):
    """Exact dot-metric top-k via group-max selection — the plain grouped
    route (``ranking.rank_top_k_grouped`` in the JAX package).

    Scores are f32 throughout (operands upcast, TF32 off), materialised as
    one (B, N) matrix; the JAX form rescores the winning groups instead of
    gathering them, which selects the same rows."""
    n = vectors.shape[0]
    s = _scrub(_metrics.qv_dot(queries, vectors), row_mask, recency)
    if n % group or n <= k * group:
        return exact_top_k(s, k)
    return exact_top_k_grouped(s, k, group=group)


def _use_gmax(queries, vectors, k: int) -> bool:
    """Route big-batch bf16 dot-form scans through the stage-1 kernels.

    The JAX route's conditions, without its CPU bail-out and its TPU block
    rules: on a CPU tensor the kernel wrappers run their plain versions."""
    from hyperdb_tpu_torch.ops import gmax as _gmax  # gmax imports this module

    min_b = CONFIG.pallas_gmax_f_min_batch
    if not CONFIG.pallas_gmax or min_b <= 0 or queries.shape[0] < min_b:
        return False
    return _gmax.supported(queries, vectors, k)


def rank_top_k(
    queries,
    vectors,
    k: int,
    metric: str = "cosine_similarity",
    row_mask=None,
    recency=None,
    prenormalized: bool = False,
):
    """Score a (B, d) query block against an (N, d) corpus and take top-k.

    Args:
        queries: (B, d) query block (f32, f16 or bf16).
        vectors: (N, d) corpus (f32 or bf16), on the same device.
        k: results per query (<= N).
        metric: one of :data:`hyperdb_tpu_torch.ops.metrics.METRICS`.
        row_mask: optional (N,) bool; False rows score -inf.
        recency: optional (N,) f32 added after the NaN scrub.
        prenormalized: corpus rows are unit-norm (cosine skips the corpus
            normalization).

    Returns:
        (values, indices): (B, k) f32 and (B, k) int64.
    """
    n = vectors.shape[0]
    group = _auto_group(int(queries.shape[0]))
    while group >= 32 and n % group:
        group //= 2
    use_grouped = (
        CONFIG.grouped_topk_min_rows > 0
        and n >= CONFIG.grouped_topk_min_rows
        and group >= 32
        and n % group == 0
    )

    if use_grouped and (
        metric == "dot_product"
        or (metric == "cosine_similarity" and prenormalized)
    ):
        qq = queries
        if metric == "cosine_similarity":
            # normalize in f32, then cast to the plane's dtype
            qq = _metrics._match_low_precision(_metrics.normalize(queries), vectors)
        elif (
            qq.dtype in LOW_PRECISION
            and vectors.dtype in LOW_PRECISION
            and qq.dtype != vectors.dtype
        ):
            # an f16 query wire against the bf16 plane scores in bf16
            qq = qq.to(vectors.dtype)
        if _use_gmax(qq, vectors, k):
            from hyperdb_tpu_torch.ops.gmax import rank_top_k_grouped_gmax

            return rank_top_k_grouped_gmax(
                qq, vectors, k, row_mask=row_mask, recency=recency
            )
        return rank_top_k_grouped(
            qq, vectors, k, row_mask=row_mask, recency=recency, group=group
        )
    if (
        metric == "manhattan_distance"
        and CONFIG.grouped_topk_min_rows > 0
        and n >= CONFIG.grouped_topk_min_rows
    ):
        raise NotImplementedError(
            "manhattan over a large corpus (streamed scan / L1 kernel) is not "
            "ported yet: ROADMAP.md queue 1, item 7"
        )
    if metric == "cosine_similarity" and prenormalized:
        s = _metrics.cosine_scores_prenormalized(queries, vectors)
    else:
        s = scores(queries, vectors, metric)
    s = _scrub(s, row_mask, recency)
    if use_grouped:
        return exact_top_k_grouped(s, k, group=group)
    return exact_top_k(s, k)
