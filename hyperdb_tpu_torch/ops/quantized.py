"""Int8 quantized scoring path.

Counterpart of ``hyperdb_tpu/ops/quantized.py``. Symmetric per-row int8
quantization halves the bytes of the corpus scan relative to bf16 and
doubles the corpus a card holds; the tensor cores multiply int8 x int8 with
int32 accumulation, and scores are rescaled by the per-row scale product
afterwards:

    s[b, n] = (q_i8[b] . v_i8[n]) * (q_scale[b] * v_scale[n])

Quantization error is ~1/127 per element; for exact results the engine
overfetches candidates from the int8 scan and re-scores them against the
full-precision rows (:func:`rank_top_k_int8` with ``rescore_rows``): the
true top-k survives inside a 4x overfetch with overwhelming probability,
and the re-scoring gather touches only O(B * 4k * d) bytes.

Two grouped forms, where the JAX package has three. Its ``lax.scan`` form
(``_int8_grouped_topk_chunked``) exists only because XLA materialises the
(B, N) f32 epilogue and must bound it: here every case whose epilogue would
pass ``_EPILOGUE_BUDGET_BYTES`` (``_pick_chunks`` > 1) goes to the stage-1
kernel ``gmax.gmax_int8`` (its plain version on CPU tensors), which keeps
the scores out of device memory, and smaller cases take
:func:`_int8_grouped_topk`, which scores a bounded chunk of queries at a
time. Both packages route the same shapes to the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.ops.ranking import (
    _CHUNK_CELLS,
    NEG_INF,
    _auto_group,
    exact_top_k,
    exact_top_k_grouped,
    finish_candidates,
    gather_dot,
)

# Rows per block of the host-side quantization: bounds its f32 temporaries.
_QUANTIZE_BLOCK_CELLS = 1 << 26


def quantize_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization (host-side, at ingest); all-zero
    rows get scale 0. Row blocks bound the temporaries and change no value."""
    rows = np.asarray(rows, dtype=np.float32)
    n, d = rows.shape
    q = np.empty((n, d), dtype=np.int8)
    scales = np.empty(n, dtype=np.float32)
    step = max(1, _QUANTIZE_BLOCK_CELLS // max(1, d))
    for a in range(0, n, step):
        blk = rows[a : a + step]
        sc = (np.max(np.abs(blk), axis=1) / 127.0).astype(np.float32)
        safe = np.where(sc == 0, 1.0, sc)
        q[a : a + step] = np.clip(np.rint(blk / safe[:, None]), -127, 127).astype(np.int8)
        scales[a : a + step] = sc
    return q, scales


def _quantize_device(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of an f32 query block on its device;
    ``torch.round`` rounds half to even, as ``jnp.round`` does. The divisor
    127 is a tensor on purpose: on the card torch divides by a Python scalar
    as a multiplication by its reciprocal, which moves a scale by an ulp and
    now and then a quantized element by one, away from the CPU's and the
    JAX package's IEEE division."""
    max_abs = x.abs().amax(dim=1)
    scales = max_abs / torch.full_like(max_abs, 127.0)
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    q = torch.clamp(torch.round(x / safe[:, None]), -127, 127).to(torch.int8)
    return q, scales.float()


def _int8_dot(q_i8: torch.Tensor, v_i8: torch.Tensor) -> torch.Tensor:
    """Exact (B, R) int8 inner products as f32. int8 values are exact in
    bf16 and every partial sum is an integer, exact in f32 below 2^24
    (d <= 1040), so on the card the block multiplies as bf16 with f32
    output; elsewhere, and for deeper rows, in f32 or f64."""
    d = q_i8.shape[1]
    if 127 * 127 * d >= 1 << 24:
        return (q_i8.double() @ v_i8.double().T).float()
    if q_i8.is_cuda:
        return torch.mm(q_i8.bfloat16(), v_i8.bfloat16().T, out_dtype=torch.float32)
    return q_i8.float() @ v_i8.float().T


def int8_scores(q_i8, q_scale, v_i8, v_scales):
    """(B, N) rescaled int8 scores."""
    return _int8_dot(q_i8, v_i8) * (q_scale[:, None] * v_scales[None, :])


def _rescore_groups(q_i8, q_scale, v_i8, v_scales, gidx, group, row_mask, recency):
    """Stage 3 of the grouped int8 scan: exactly rescore the winning groups'
    gathered int8 rows and take the final top-k (k = gidx.shape[-1]).
    Shared by the plain stage-1 form and the gmax kernel route. The gather is
    chunked over queries (``ranking.gather_dot``): at k = 64 groups of 128
    rows a query's candidates are 3 MB of int8 and four times that in f32.
    """
    n = v_i8.shape[0]
    g = n // group
    b, k = gidx.shape
    inter_c = gather_dot(q_i8, v_i8, gidx, group)  # (B, k, group) exact integers
    cs = inter_c * (q_scale[:, None, None] * v_scales.view(g, group)[gidx])
    if recency is not None:
        cs = cs + recency.view(g, group)[gidx]
    if row_mask is not None:
        cs = cs.masked_fill(~row_mask.view(g, group)[gidx], NEG_INF)
    return finish_candidates(cs, gidx, b, k, group)


def _int8_grouped_topk(q_i8, q_scale, v_i8, v_scales, k, group, row_mask, recency):
    """Grouped int8 scan, plain form: per-group maxes of the rescaled scores
    (a chunk of queries at a time, so the (B, N) f32 scores never exist at
    once), the top-k groups, then :func:`_rescore_groups`. Same containment
    argument as ``ranking.rank_top_k_grouped``."""
    b = q_i8.shape[0]
    n = v_i8.shape[0]
    g = n // group
    gmax = torch.empty((b, g), dtype=torch.float32, device=q_i8.device)
    chunk = max(1, _CHUNK_CELLS // n)
    for a in range(0, b, chunk):
        s = int8_scores(q_i8[a : a + chunk], q_scale[a : a + chunk], v_i8, v_scales)
        if recency is not None:
            s = s + recency[None, :]
        if row_mask is not None:
            s = s.masked_fill(~row_mask[None, :], NEG_INF)
        gmax[a : a + s.shape[0]] = s.view(s.shape[0], g, group).amax(-1)
    _, gidx = exact_top_k(gmax, k)  # (B, k)
    return _rescore_groups(q_i8, q_scale, v_i8, v_scales, gidx, group, row_mask, recency)


# A (B, N) f32 epilogue above this many bytes is never materialised: such
# scans go to the stage-1 kernel. The JAX package's value (its XLA form must
# chunk there), kept so both packages send the same shapes to the kernel.
_EPILOGUE_BUDGET_BYTES = 1 << 31  # 2 GB


def _pick_chunks(b: int, n: int, group: int) -> int:
    """Smallest chunk count dividing g that keeps a per-chunk epilogue under
    _EPILOGUE_BUDGET_BYTES (1 = one chunk, the plain grouped form)."""
    g = n // group
    n_chunks = 1
    while b * (g // n_chunks) * group * 4 > _EPILOGUE_BUDGET_BYTES and n_chunks < g:
        n_chunks += 1
        while g % n_chunks and n_chunks < g:
            n_chunks += 1
    return n_chunks if g % n_chunks == 0 else 1


def _use_gmax_int8(q_i8, v_i8, k: int) -> bool:
    """Route stage 1 through the gmax_int8 kernel: the JAX route's
    condition without its CPU bail-out and its TPU block rules."""
    from hyperdb_tpu_torch.ops import gmax as _gmax

    return bool(CONFIG.pallas_gmax) and _gmax.supported_int8(q_i8, v_i8, k)


def rank_top_k_int8(
    queries,
    v_i8,
    v_scales,
    k: int,
    row_mask=None,
    recency=None,
    rescore_rows=None,
    overfetch: int = 4,
):
    """Int8 scan + optional full-precision re-score of the top candidates.

    ``queries`` are float (any precision); they are quantized on their
    device. ``rescore_rows`` (N, d) enables the exact re-ranking pass over a
    ``k * overfetch`` candidate set. Returns (values (B, k) f32, indices
    (B, k) int64).
    """
    q32 = queries.float()
    q_i8, q_scale = _quantize_device(q32)
    b = int(queries.shape[0])
    group = _auto_group(b)
    n = v_i8.shape[0]
    k_fetch = k if rescore_rows is None else min(k * overfetch, n)

    if n % group == 0 and n > k_fetch * group:
        if _pick_chunks(b, n, group) > 1 and _use_gmax_int8(q_i8, v_i8, k_fetch):
            from hyperdb_tpu_torch.ops import gmax as _gmax

            extra = _gmax.make_extra(n, row_mask, recency, device=v_i8.device)
            gm = _gmax.gmax_int8(q_i8, q_scale, v_i8, v_scales, extra)
            _, gidx = exact_top_k(gm, min(k_fetch, n // _gmax.GROUP))
            vals, cand = _rescore_groups(
                q_i8, q_scale, v_i8, v_scales, gidx, _gmax.GROUP, row_mask, recency
            )
        else:
            vals, cand = _int8_grouped_topk(
                q_i8, q_scale, v_i8, v_scales, k_fetch, group, row_mask, recency
            )
    else:
        s = int8_scores(q_i8, q_scale, v_i8, v_scales)
        if recency is not None:
            # recency shifts the ranking like a score offset, so candidate
            # selection must see it too, not just the re-score pass
            s = s + recency[None, :]
        if row_mask is not None:
            s = s.masked_fill(~row_mask[None, :], NEG_INF)
        vals, cand = exact_top_k_grouped(s, k_fetch, group=group)

    if rescore_rows is None:
        return vals, cand

    # true f32 over the upcast source rows (TF32 is off package-wide)
    exact = torch.einsum("bd,bkd->bk", q32, rescore_rows[cand].float())
    if recency is not None:
        exact = exact + recency[cand]
    if row_mask is not None:
        exact = exact.masked_fill(~row_mask[cand], NEG_INF)
    vals, pos = exact_top_k(exact, k)
    return vals, torch.gather(cand, 1, pos)
