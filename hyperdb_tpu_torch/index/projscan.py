"""Two-stage reduced-rank scan ("projscan"): an opt-in int8-pure index.

Counterpart of ``hyperdb_tpu/index/projscan.py``, with the same state and
routes:

  stage A  scan the corpus projected to d' < d dimensions (top-d' PCA
           directions of a row sample) and quantized to int8, keep the max of
           each row group, and select the top ``G`` groups;
  stage B  gather the winning groups' FULL-depth int8 rows from the store's
           own plane, rescore them exactly and take the final top-k.

Stage A's route is the JAX package's rule. On the card, where
``quantized._use_gmax_int8`` holds (int8 operands, 128-row groups, d' a
multiple of 16), it is the hand-written ``gmax.gmax_int8`` kernel over
128-row groups with ``G = min(g, max(k, ceil(overfetch / 128)))``: d' = 128
makes its rows 128 bytes, one TMA box deep. Elsewhere (CPU tensors, shapes
outside the kernel's contract) it is the group-16 scan
:func:`_gmax_int8_groups16`, which is what the JAX package runs off the TPU.
A kernel that fails to build or launch raises; stage A never falls back to
the group-16 form. Recall is a property of the corpus spectrum: the build
declines (returns None) when the top-d' directions keep less than
``min_variance`` of the sample variance.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdb_tpu_torch.ops import gmax as _gmax
from hyperdb_tpu_torch.ops.quantized import (
    _int8_dot,
    _pick_chunks,
    _quantize_device,
    _use_gmax_int8,
    quantize_rows,
    rank_top_k_int8,
)
from hyperdb_tpu_torch.ops.ranking import NEG_INF, exact_top_k
from hyperdb_tpu_torch.utils import log

# Below this captured-variance fraction stage A is measurably lossy at
# serving overfetch budgets: the build warns.
FLAT_SPECTRUM_WARN = 0.5

# Stage-A group of the plain (off-card) route: 16 rows.
STAGE_GROUP = 16

# Bound of the largest per-tile temporaries of both stages: the (tile, g)
# group maxes of stage A and the (tile, G * group, d) f32 rows of stage B.
_TILE_BYTES = 1 << 30


def _warn_if_flat(captured: float, d_prime: int, d: int) -> None:
    if d_prime < d and captured < FLAT_SPECTRUM_WARN:
        log.warn(
            "INFO: projscan stage-A keeps "
            f"{100.0 * captured:.0f}% of corpus variance at d'={d_prime} "
            "(flat spectrum) — recall will be poor; prefer the exact scan "
            "(unset HYPERDB_PROJSCAN_THRESHOLD) or raise "
            "HYPERDB_PROJSCAN_DPRIME/OVERFETCH"
        )


def fit_projection(sample_rows: np.ndarray, d_prime: int, seed: int = 0) -> tuple[np.ndarray, float]:
    """(d, d') PCA projection from a host row sample (d x d covariance,
    NumPy ``eigh``). Returns ``(p, captured)``, ``captured`` the fraction of
    the sample's variance the top-d' directions carry. A failed
    decomposition falls back to orthonormalized Gaussian columns (captured
    reported as d'/d)."""
    x = np.asarray(sample_rows, dtype=np.float32)
    d = x.shape[1]
    d_prime = min(d_prime, d)
    cov = (x.T @ x) / max(1, x.shape[0])
    try:
        w, v = np.linalg.eigh(cov)  # ascending
        p = v[:, ::-1][:, :d_prime]
        total = float(np.sum(w))
        captured = float(np.sum(w[::-1][:d_prime])) / total if total > 0 else 1.0
    except np.linalg.LinAlgError:
        rng = np.random.default_rng(seed)
        p, _ = np.linalg.qr(rng.standard_normal((d, d_prime)))
        captured = d_prime / d
    return np.ascontiguousarray(p, dtype=np.float32), float(captured)


class ProjScanIndex:
    """Reduced-rank int8 stage-A corpus plus the exact int8 stage-B rescore.

    Device state: ``p_dev`` (d, d') f32 projection, ``a_i8`` (n_pad, d')
    int8 projected corpus (row-quantized) and ``a_scales`` (n_pad,) f32.
    Stage B reads the caller's full-depth int8 plane (:meth:`search`)."""

    is_ann = True
    kind = "projscan"

    def __init__(self, proj, a_i8, a_scales, num_rows: int, num_valid: int | None = None,
                 captured_variance: float | None = None):
        self.proj = np.array(proj, dtype=np.float32)  # owned: shared with torch
        self.captured_variance = None if captured_variance is None else float(captured_variance)
        self.a_i8 = a_i8
        self.a_scales = a_scales
        self.device = a_i8.device
        self.p_dev = torch.from_numpy(self.proj).to(self.device)
        self.num_rows = int(num_rows)  # the padded row space
        # pad rows must never surface from probe(): the engine indexes
        # source_indices with its output
        self.num_valid = int(num_valid if num_valid is not None else num_rows)
        self.d = int(self.proj.shape[0])
        self.d_prime = int(self.proj.shape[1])
        self._valid_mask = (
            None
            if self.num_valid >= self.num_rows
            else torch.arange(self.num_rows, device=self.device) < self.num_valid
        )

    # ------------------------------------------------------------ build

    @classmethod
    def build_from_device_rows(
        cls,
        rows_dev,
        num_rows: int,
        d_prime: int = 96,
        sample: int = 1 << 17,
        chunk: int = 1 << 20,
        seed: int = 0,
        num_valid: int | None = None,
        min_variance: float | None = None,
    ) -> "ProjScanIndex | None":
        """Build from an (n_pad, d) device plane (float, or an ``(v_i8,
        v_scales)`` tuple, dequantized chunk by chunk). A strided sample of
        about ``sample`` rows from 64 windows fits the projection on the
        host; the plane is then projected and quantized on its device. When
        d >= 128, d' rounds up to a multiple of 128. Returns None (the
        decline) when the top-d' directions keep less than ``min_variance``
        of the sample variance."""
        dequant = isinstance(rows_dev, tuple)
        base = rows_dev[0] if dequant else rows_dev
        n_pad, d = int(base.shape[0]), int(base.shape[1])
        if d >= 128:
            d_prime = min(d, -(-d_prime // 128) * 128)

        def chunk_f32(lo: int, hi: int, step: int = 1) -> torch.Tensor:
            if dequant:
                v_i8, v_sc = rows_dev
                return v_i8[lo:hi:step].float() * v_sc[lo:hi:step, None]
            return rows_dev[lo:hi:step].float()

        windows = [
            (lo, min(lo + 4096, num_rows))
            for lo in range(0, num_rows, max(4096, num_rows // 64))
        ]
        visited = sum(hi - lo for lo, hi in windows)
        stride = max(1, visited // sample)
        host_sample = np.concatenate(
            [chunk_f32(lo, hi, stride).cpu().numpy() for lo, hi in windows]
        )
        proj, captured = fit_projection(host_sample, d_prime, seed=seed)
        _warn_if_flat(captured, proj.shape[1], d)
        if min_variance is not None and captured < min_variance:
            log.info(
                "INFO: projscan declined — captured variance "
                f"{100.0 * captured:.0f}% < min {100.0 * min_variance:.0f}%; "
                "using the exact scan"
            )
            return None
        p_dev = torch.from_numpy(proj).to(base.device)
        parts_q, parts_s = [], []
        for lo in range(0, n_pad, chunk):
            qi, sc = _quantize_device(chunk_f32(lo, min(lo + chunk, n_pad)) @ p_dev)
            parts_q.append(qi)
            parts_s.append(sc)
        return cls(proj, torch.cat(parts_q), torch.cat(parts_s), num_rows,
                   num_valid=num_valid, captured_variance=captured)

    @classmethod
    def build(cls, rows: np.ndarray, d_prime: int = 96, seed: int = 0, device=None):
        """Host build from an (n, d) array (small and medium corpora, tests);
        the planes go to ``device`` (the card unless the caller asks for the
        CPU)."""
        from hyperdb_tpu_torch.core.db import resolve_device

        dev = resolve_device(device)
        rows = np.asarray(rows, dtype=np.float32)
        n = rows.shape[0]
        proj, captured = fit_projection(rows[:: max(1, n // (1 << 16))], d_prime, seed)
        _warn_if_flat(captured, proj.shape[1], rows.shape[1])
        a_i8, a_sc = quantize_rows(rows @ proj)
        return cls(proj, torch.from_numpy(a_i8).to(dev), torch.from_numpy(a_sc).to(dev), n,
                   captured_variance=captured)

    # ------------------------------------------------------------ search

    def search(self, queries, rescore_i8, rescore_scales, k: int, overfetch: int = 256,
               row_mask=None, recency=None):
        """Two-stage top-k. ``queries``: (B, d) float, normalized by the
        caller for cosine. ``rescore_i8`` / ``rescore_scales``: the store's
        full-depth int8 plane. Returns (values (B, k) f32, row ids (B, k)
        int64); equals the int8-pure exact ranking whenever its top-k
        survives stage A."""
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.asarray(queries, dtype=np.float32))
        return projscan_search(
            self.p_dev, self.a_i8, self.a_scales, queries.to(self.device).float(),
            rescore_i8, rescore_scales, k, overfetch, row_mask, recency,
        )

    def probe(self, query_vector, budget: int) -> np.ndarray:
        """The ``budget`` best valid rows by projected score (the Q12
        candidate surface; the engine's single-query path skips it)."""
        q = torch.from_numpy(np.asarray(query_vector, dtype=np.float32).reshape(1, -1))
        qa = q.to(self.device) @ self.p_dev
        k = max(1, min(int(budget), self.num_valid))
        _, idx = rank_top_k_int8(qa, self.a_i8, self.a_scales, k=k, row_mask=self._valid_mask)
        out = idx[0].cpu().numpy()
        return out[out < self.num_valid]

    # ----------------------------------------------------------- persist

    def state(self) -> dict:
        return {
            "kind": "projscan",
            "proj": self.proj,
            "a_i8": self.a_i8.cpu().numpy(),
            "a_scales": self.a_scales.cpu().numpy(),
            "num_rows": np.asarray(self.num_rows),
            "num_valid": np.asarray(self.num_valid),
            "captured_variance": np.asarray(
                -1.0 if self.captured_variance is None else self.captured_variance
            ),
        }

    @classmethod
    def from_state(cls, state: dict, device=None) -> "ProjScanIndex":
        """Restore onto ``device`` (the card unless the caller asks for the CPU)."""
        from hyperdb_tpu_torch.core.db import resolve_device

        device = resolve_device(device)
        cv = float(state.get("captured_variance", -1.0))
        return cls(
            state["proj"],
            torch.from_numpy(np.array(state["a_i8"], dtype=np.int8)).to(device),
            torch.from_numpy(np.array(state["a_scales"], dtype=np.float32)).to(device),
            int(state["num_rows"]),
            num_valid=int(state.get("num_valid", state["num_rows"])),
            captured_variance=None if cv < 0 else cv,
        )


# ---------------------------------------------------------------- stages


def _stage_a_on_kernel(qa_i8, a_i8, G: int) -> bool:
    """Stage A's route: the ``gmax_int8`` kernel over 128-row groups where
    the int8 route's condition holds on the card; the group-16 scan for CPU
    tensors (the JAX package's route off the TPU)."""
    return a_i8.device.type != "cpu" and _use_gmax_int8(qa_i8, a_i8, G)


def _gmax_int8_groups16(qa_i8, qa_scale, a_i8, a_scales, extra, n_chunks: int):
    """(B, n/16) maxes of the rescaled projected int8 scores over 16-row
    groups (``_gmax_int8_xla`` in the JAX package): exact integer dots,
    ``* (q_scale * v_scale) + extra``, NaN -> -inf, a chunk of rows at a
    time so the (B, rows) f32 epilogue stays bounded."""
    n = a_i8.shape[0]
    b = qa_i8.shape[0]
    rows_c = n // n_chunks
    out = torch.empty((b, n // STAGE_GROUP), dtype=torch.float32, device=a_i8.device)
    for lo in range(0, n, rows_c):
        hi = lo + rows_c
        s = _int8_dot(qa_i8, a_i8[lo:hi]) * (qa_scale[:, None] * a_scales[None, lo:hi])
        s = s + extra[None, lo:hi]
        s.masked_fill_(torch.isnan(s), NEG_INF)
        out[:, lo // STAGE_GROUP : hi // STAGE_GROUP] = s.view(
            b, rows_c // STAGE_GROUP, STAGE_GROUP
        ).amax(-1)
    return out


def _stage_b_tile(q_tile, rescore_i8, rescore_scales, gidx_tile, k: int, sg: int,
                  row_mask=None, recency=None):
    """Exact full-depth rescore of one query tile's winning groups: gather
    the groups' int8 rows, f32 products of the quantized query (integer
    sums, exact for d <= 1040), ``* (q_scale * v_scale)``, + recency, the
    mask, NaN -> -inf, then the top-k (ties to the lower position, i.e. the
    better-ranked group)."""
    t, G = gidx_tile.shape
    rows_t = (
        gidx_tile[:, :, None] * sg + torch.arange(sg, device=gidx_tile.device)[None, None, :]
    ).reshape(t, G * sg)
    q_i8, q_scale = _quantize_device(q_tile)
    sub = rescore_i8[rows_t].float()  # (t, c, d)
    cs = torch.matmul(sub, q_i8.float()[:, :, None])[..., 0]
    cs = cs * (q_scale[:, None] * rescore_scales[rows_t])
    if recency is not None:
        cs = cs + recency[rows_t]
    if row_mask is not None:
        cs = cs.masked_fill(~row_mask[rows_t], NEG_INF)
    cs = cs.masked_fill(torch.isnan(cs), NEG_INF)
    vals, pos = exact_top_k(cs, k)
    return vals, torch.gather(rows_t, 1, pos)


def _stage_b(q, rescore_i8, rescore_scales, gidx, k: int, sg: int, row_mask, recency):
    """Query-tiled stage B: the gathered (tile, G * sg, d) f32 rows stay
    under ``_TILE_BYTES``."""
    b = q.shape[0]
    d = rescore_i8.shape[1]
    G = gidx.shape[1]
    tile = b
    while tile > 8 and tile * G * sg * d * 4 > _TILE_BYTES:
        tile //= 2
    parts = [
        _stage_b_tile(q[lo : lo + tile], rescore_i8, rescore_scales, gidx[lo : lo + tile],
                      k, sg, row_mask, recency)
        for lo in range(0, b, tile)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def projscan_search(p_dev, a_i8, a_scales, q, rescore_i8, rescore_scales, k: int,
                    overfetch: int, row_mask=None, recency=None):
    """Stage A (project and quantize the queries, scan the projected corpus
    to group maxes, select the top ``G`` groups), then stage B. With a
    full-rank projection the result is exact: the top-k rows' groups are
    always among the top-k groups by max. At low rank recall rises with
    ``overfetch`` (counted in rows, granted in whole groups)."""
    n = rescore_i8.shape[0]
    b = q.shape[0]
    qa_i8, qa_scale = _quantize_device(q @ p_dev)

    g = n // _gmax.GROUP
    G = min(g, max(k, -(-overfetch // _gmax.GROUP)))
    if _stage_a_on_kernel(qa_i8, a_i8, G):
        extra = _gmax.make_extra(n, row_mask, recency, device=a_i8.device)
        gm = _gmax.gmax_int8(qa_i8, qa_scale, a_i8, a_scales, extra)
        _, gidx = exact_top_k(gm, G)
        return _stage_b(q, rescore_i8, rescore_scales, gidx, k, _gmax.GROUP, row_mask, recency)

    g = n // STAGE_GROUP
    G = min(g, max(k, -(-overfetch // STAGE_GROUP)))
    # query tiles bound the (tile, g) group maxes; each tile re-reads the
    # projected corpus
    tile = b
    while tile > 8 and tile * g * 4 > _TILE_BYTES:
        tile //= 2
    n_chunks = _pick_chunks(tile, n, STAGE_GROUP)
    extra = _gmax.make_extra(n, row_mask, recency, device=a_i8.device)
    gidx = torch.cat([
        exact_top_k(
            _gmax_int8_groups16(qa_i8[lo : lo + tile], qa_scale[lo : lo + tile],
                                a_i8, a_scales, extra, n_chunks),
            G,
        )[1]
        for lo in range(0, b, tile)
    ])
    return _stage_b(q, rescore_i8, rescore_scales, gidx, k, STAGE_GROUP, row_mask, recency)
