"""Stage-1 grouped-max scan kernels and the three-stage exact top-k routes.

Counterpart of ``hyperdb_tpu/ops/pallas_gmax.py``: stage 1 computes one
score per (query, row) on tensor cores, scrubs NaN to -inf, and keeps only
the max of every ``sub``-row subgroup and/or 128-row group; stage 2 selects
the top-k groups, then (float route) the top-k subgroups inside them
(:func:`_select_subgroups`); stage 3 gathers those rows, rescores them in
f32 and takes the final top-k (:func:`_finish_candidates`). ``extra`` folds
masks and recency into one additive vector (0 or the recency on live rows,
-inf on masked or padding rows), so stage 1 and stage 3 score the same
function and the containment argument of the JAX route holds: every true
top-k row lives in a selected subgroup, up to ties at the k-th value.

Kernels (``csrc/gmax.cu``, one templated CUDA kernel for all four):

- :func:`gmax_f_sub` replaces ``pallas_gmax.gmax_f_sub`` (kernel body
  ``pallas_gmax.py:318``): ``q . v + extra`` over bf16 operands, subgroup
  maxes, plus the group maxes in the dual form or as a max over each run of
  128/sub subgroups in the single form.
- :func:`gmax_f` replaces ``pallas_gmax.gmax_f`` (``_gmax_kernel_f``,
  ``pallas_gmax.py:121``): the same score, group maxes only.
- :func:`gmax_int8` replaces ``pallas_gmax.gmax_int8``
  (``_gmax_kernel_int8``, ``pallas_gmax.py:139``): ``float(q_i8 . v_i8) *
  (q_scale * v_scale) + extra`` over s8 operands with exact s32 sums.
- :func:`gmax_jaccard` replaces ``pallas_gmax.gmax_jaccard``
  (``_gmax_kernel_jaccard``, ``pallas_gmax.py:392``): the true jaccard score
  ``inter / (|q| + |v| - inter)`` over 0/1 bf16 rows, NaN (0/0) -> -inf,
  and only then ``+ extra``.

Routes: :func:`rank_top_k_grouped_gmax` (dot / prenormalized cosine /
pearson planes), :func:`rank_top_k_grouped_metric_gmax` (euclidean and
hamming through a dot surrogate on the float kernels, jaccard on its own)
and :func:`rank_top_k_int8_gmax` (int8 planes).

Bound on the H100: compute — 2*B*N*d operations on tensor cores against
one read of the (N, d) corpus; at b = 512 and N = 2^20, d = 384 that is
0.41 TFLOP against 0.8 GB, about 500 operations per byte, above the card's
~295 in bf16 (int8 at b = 1024: 2000 per byte against ~590). The kernel
therefore runs the product on tensor cores (``mma.sync``) and keeps the
(B, N) score matrix out of device memory, writing only the maxes; see the
source for the tiling.

Each wrapper takes its plain PyTorch version for CPU tensors only; for a
CUDA tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.ops import cuda_build
from hyperdb_tpu_torch.ops.ranking import (
    _CHUNK_CELLS,
    exact_top_k,
    finish_candidates,
    gather_dot,
    grouped_metric_operands,
)

GROUP = 128  # rows per group; the kernel's corpus block

LAUNCHES = {"gmax_f_sub": 0, "gmax_f": 0, "gmax_int8": 0, "gmax_jaccard": 0}

NEG_INF = float("-inf")

# the `kind` argument of csrc/gmax.cu's gmax_scan
_KIND_F, _KIND_INT8, _KIND_JACCARD = 0, 1, 2


def _scan_fn():
    lib = cuda_build.load("gmax")
    fn = lib.gmax_scan
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check(kind, queries, vectors, qaux, vaux, extra, sub):
    b, d = queries.shape
    n = vectors.shape[0]
    tensors = [t for t in (queries, vectors, qaux, vaux, extra) if t is not None]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("gmax kernels take CUDA tensors")
    want = torch.int8 if kind == _KIND_INT8 else torch.bfloat16
    if queries.dtype != want or vectors.dtype != want:
        raise ValueError(f"this gmax kernel takes {want} queries and corpus")
    if extra.dtype != torch.float32 or extra.shape != (n,):
        raise ValueError("extra must be an (N,) float32 vector")
    if kind != _KIND_F and not (
        qaux.dtype == vaux.dtype == torch.float32 and qaux.shape == (b,) and vaux.shape == (n,)
    ):
        raise ValueError("per-query and per-row terms must be (B,) and (N,) float32 vectors")
    if vectors.shape[1] != d or n % GROUP or (d * queries.element_size()) % 16:
        raise ValueError(f"unsupported shapes q={tuple(queries.shape)} v={tuple(vectors.shape)}")
    if sub and not (8 <= sub <= GROUP and GROUP % sub == 0):
        raise ValueError(f"sub ({sub}) must divide {GROUP} and be at least 8")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("gmax kernels take contiguous 16-byte-aligned tensors")


def _launch(kind, queries, vectors, extra, sm, gm, sub, qaux=None, vaux=None):
    fn = _scan_fn()  # builds on first use; raises if the library cannot be built
    _check(kind, queries, vectors, qaux, vaux, extra, sub)
    b, d = queries.shape
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    rc = fn(
        kind, queries.data_ptr(), vectors.data_ptr(),
        None if qaux is None else qaux.data_ptr(),
        None if vaux is None else vaux.data_ptr(),
        extra.data_ptr(),
        None if sm is None else sm.data_ptr(),
        None if gm is None else gm.data_ptr(),
        b, vectors.shape[0], d, sub, stream,
    )
    if rc:
        raise RuntimeError(f"gmax_scan launch failed: cudaError {rc}")


# ---------------------------------------------------------------- plain


def _plain_scores(queries, vectors, extra):
    """Yield (start, (c, N) f32 scores) over query chunks: upcast, matmul,
    + extra, NaN -> -inf — the kernels' arithmetic, materialised."""
    b = queries.shape[0]
    n = vectors.shape[0]
    v32 = vectors.float()
    chunk = max(1, _CHUNK_CELLS // n)
    for a in range(0, b, chunk):
        s = queries[a : a + chunk].float() @ v32.T + extra
        yield a, s.masked_fill_(torch.isnan(s), NEG_INF)


def gmax_f_plain(queries, vectors, extra):
    """Plain version of :func:`gmax_f`: (B, N/128) f32 group maxes."""
    b, n = queries.shape[0], vectors.shape[0]
    gm = torch.empty((b, n // GROUP), dtype=torch.float32, device=queries.device)
    for a, s in _plain_scores(queries, vectors, extra):
        gm[a : a + s.shape[0]] = s.view(s.shape[0], n // GROUP, GROUP).amax(-1)
    return gm


def gmax_f_sub_plain(queries, vectors, extra, sub: int = 32):
    """Plain version of :func:`gmax_f_sub`: ((B, N/128), (B, N/sub)) f32."""
    b, n = queries.shape[0], vectors.shape[0]
    sm = torch.empty((b, n // sub), dtype=torch.float32, device=queries.device)
    for a, s in _plain_scores(queries, vectors, extra):
        sm[a : a + s.shape[0]] = s.view(s.shape[0], n // sub, sub).amax(-1)
    return sm.view(b, n // GROUP, GROUP // sub).amax(-1), sm


def _int_chunks(q, v):
    """Yield (start, exact (c, N) f32 inner products) over query chunks for
    integer-valued operands (int8 rows, 0/1 rows). Every partial sum is an
    integer, exact in f32 below 2^24 (d <= 1040 for int8) and in f64
    beyond; the corpus is upcast once."""
    bound = (127 * 127 if q.dtype == torch.int8 else 1) * q.shape[1]
    wide = torch.float32 if bound < 1 << 24 else torch.float64
    vw = v.to(wide)
    chunk = max(1, _CHUNK_CELLS // v.shape[0])
    for a in range(0, q.shape[0], chunk):
        yield a, (q[a : a + chunk].to(wide) @ vw.T).float()


def gmax_int8_plain(q_i8, q_scale, v_i8, v_scales, extra):
    """Plain version of :func:`gmax_int8`: (B, N/128) f32 group maxes of
    ``float(q_i8 . v_i8) * (q_scale * v_scale) + extra``, NaN -> -inf."""
    b, n = q_i8.shape[0], v_i8.shape[0]
    gm = torch.empty((b, n // GROUP), dtype=torch.float32, device=q_i8.device)
    for a, dot in _int_chunks(q_i8, v_i8):
        c = dot.shape[0]
        s = dot * (q_scale[a : a + c, None] * v_scales[None, :]) + extra
        s.masked_fill_(torch.isnan(s), NEG_INF)
        gm[a : a + c] = s.view(c, n // GROUP, GROUP).amax(-1)
    return gm


def gmax_jaccard_plain(queries, vectors, q_sum, aux, extra):
    """Plain version of :func:`gmax_jaccard`: (B, N/128) f32 group maxes of
    ``inter / (|q| + |v| - inter)``, NaN -> -inf, then ``+ extra``."""
    b, n = queries.shape[0], vectors.shape[0]
    gm = torch.empty((b, n // GROUP), dtype=torch.float32, device=queries.device)
    for a, inter in _int_chunks(queries, vectors):
        c = inter.shape[0]
        s = inter / (q_sum[a : a + c].view(-1, 1) + aux[None, :] - inter)
        s = s.masked_fill_(torch.isnan(s), NEG_INF) + extra
        gm[a : a + c] = s.view(c, n // GROUP, GROUP).amax(-1)
    return gm


# ---------------------------------------------------------------- kernels


def gmax_f(queries, vectors, extra):
    """Per-128-row-group score maxes for one-matmul metrics.

    Args:
        queries: (B, d) bf16.
        vectors: (N, d) bf16 corpus, N % 128 == 0, d % 8 == 0.
        extra: (N,) f32 additive term (recency / -inf on masked rows).

    Returns: (B, N/128) f32 group maxes.
    """
    if queries.device.type == "cpu":
        return gmax_f_plain(queries, vectors, extra)
    b, n = queries.shape[0], vectors.shape[0]
    gm = torch.empty((b, n // GROUP), dtype=torch.float32, device=queries.device)
    _launch(_KIND_F, queries, vectors, extra, None, gm, 0)
    LAUNCHES["gmax_f"] += 1
    return gm


def gmax_f_sub(queries, vectors, extra, sub: int = 32, dual: bool = True):
    """Per-group AND per-subgroup score maxes (two-level selection input).

    Args as :func:`gmax_f`; ``sub`` divides 128. ``dual`` has the kernel
    write both outputs; otherwise it writes the subgroup maxes only and the
    group maxes are a max over each run of 128/sub of them (bitwise the
    same: max is exact).

    Returns: ``(gm, sm)`` — (B, N/128) and (B, N/sub) f32.
    """
    if queries.device.type == "cpu":
        return gmax_f_sub_plain(queries, vectors, extra, sub)
    b, n = queries.shape[0], vectors.shape[0]
    sm = torch.empty((b, n // sub), dtype=torch.float32, device=queries.device)
    gm = (
        torch.empty((b, n // GROUP), dtype=torch.float32, device=queries.device)
        if dual else None
    )
    _launch(_KIND_F, queries, vectors, extra, sm, gm, sub)
    LAUNCHES["gmax_f_sub"] += 1
    if gm is None:
        gm = sm.view(b, n // GROUP, GROUP // sub).amax(-1)
    return gm, sm


def gmax_int8(q_i8, q_scale, v_i8, v_scales, extra):
    """Per-128-row-group maxes of the rescaled int8 scores.

    Args:
        q_i8: (B, d) int8 quantized queries; q_scale: (B,) f32.
        v_i8: (N, d) int8 corpus, N % 128 == 0, d % 16 == 0; v_scales: (N,)
            f32 (0 on all-zero rows, which then score ``0 + extra``).
        extra: (N,) f32 additive term (recency / -inf on masked rows).

    Returns: (B, N/128) f32 group maxes. The integer dot is exact and the
    epilogue contracts no multiply-add, so the kernel equals
    :func:`gmax_int8_plain` bit for bit.
    """
    if q_i8.device.type == "cpu":
        return gmax_int8_plain(q_i8, q_scale, v_i8, v_scales, extra)
    b, n = q_i8.shape[0], v_i8.shape[0]
    gm = torch.empty((b, n // GROUP), dtype=torch.float32, device=q_i8.device)
    _launch(_KIND_INT8, q_i8, v_i8, extra, None, gm, 0, qaux=q_scale, vaux=v_scales)
    LAUNCHES["gmax_int8"] += 1
    return gm


def gmax_jaccard(queries, vectors, q_sum, aux, extra):
    """Per-128-row-group maxes of the TRUE jaccard scores.

    Args:
        queries: (B, d) 0/1 bf16; q_sum: (B, 1) or (B,) f32 query popcounts.
        vectors: (N, d) 0/1 bf16 corpus, N % 128 == 0, d % 8 == 0; aux: (N,)
            f32 row popcounts.
        extra: (N,) f32 mask term, added AFTER the NaN scrub (an empty query
            against an empty row is 0/0 -> -inf).

    Returns: (B, N/128) f32 group maxes, bitwise those of
    :func:`gmax_jaccard_plain` (exact integer counts, IEEE division).
    """
    if queries.device.type == "cpu":
        return gmax_jaccard_plain(queries, vectors, q_sum, aux, extra)
    b, n = queries.shape[0], vectors.shape[0]
    gm = torch.empty((b, n // GROUP), dtype=torch.float32, device=queries.device)
    _launch(
        _KIND_JACCARD, queries, vectors, extra, None, gm, 0,
        qaux=q_sum.reshape(b).contiguous(), vaux=aux,
    )
    LAUNCHES["gmax_jaccard"] += 1
    return gm


# ---------------------------------------------------------------- route


def make_extra(n: int, row_mask=None, recency=None, device="cpu"):
    """Fold mask + recency into the kernels' one additive (N,) f32 vector."""
    extra = torch.zeros(n, dtype=torch.float32, device=device)
    if recency is not None:
        extra = extra + recency.float()
    if row_mask is not None:
        extra = extra.masked_fill(~row_mask, NEG_INF)
    return extra


def _select_subgroups(gm, sm, b: int, n: int, k: int, sub: int):
    """Two-level selection: top-k groups -> (B, k) global subgroup ids.

    The ``spos`` sort keeps candidates in (group-rank, subgroup-position)
    order, so ties at the k-th value resolve as in the JAX route."""
    ratio = GROUP // sub
    _, gidx = exact_top_k(gm, k)  # (B, k) group ids
    smg = sm.view(b, n // GROUP, ratio)
    sub_cand = torch.gather(smg, 1, gidx[..., None].expand(b, k, ratio))
    _, spos = exact_top_k(sub_cand.reshape(b, k * ratio), k)
    spos, _ = torch.sort(spos, dim=-1)
    return torch.gather(gidx, 1, spos // ratio) * ratio + spos % ratio


def _rescore(queries, vectors, extra, cidx, width: int):
    """Stage 3: exact f32 scores of the (B, k) candidate runs ``cidx``
    (each ``width`` rows) -> (B, k, width), NaN -> -inf, then + extra."""
    n = vectors.shape[0]
    cs = gather_dot(queries, vectors, cidx, width)
    cs.masked_fill_(torch.isnan(cs), NEG_INF)
    return cs + extra.view(n // width, width)[cidx]


def supported(queries, vectors, k: int) -> bool:
    """Shapes and types the kernels take: bf16 operands (low-precision
    pairs only — f32 corpora score in true f32 on the plain route),
    N % 128 == 0 with at least k groups, and d % 8 == 0."""
    n, d = vectors.shape
    return (
        queries.dtype == torch.bfloat16
        and vectors.dtype == torch.bfloat16
        and n % GROUP == 0
        and n // GROUP >= k
        and d % 8 == 0
    )


def rank_top_k_grouped_gmax(queries, vectors, k: int, row_mask=None, recency=None):
    """Dot-metric grouped exact top-k with the stage-1 kernels; the
    counterpart of ``pallas_gmax.rank_top_k_grouped_pallas`` /
    ``_grouped_pallas_impl``. Index-identical to the plain grouped route up
    to ties at the k-th value. The router (``ranking.rank_top_k``) sends only
    inputs that ``supported`` accepts; anything else raises.
    """
    if not supported(queries, vectors, k):
        raise ValueError(
            "rank_top_k_grouped_gmax takes bf16 operands with N % 128 == 0, "
            f"N // 128 >= k and d % 8 == 0; got {tuple(queries.shape)} "
            f"{queries.dtype} x {tuple(vectors.shape)} {vectors.dtype}, k={k}"
        )
    sub = CONFIG.pallas_subgroup
    if not (8 <= sub < GROUP and GROUP % sub == 0):
        sub = 0
    n = vectors.shape[0]
    b = queries.shape[0]
    extra = make_extra(n, row_mask, recency, device=vectors.device)
    # min(b, 1024) is the JAX route's query tile: keeping its rule routes the
    # same shapes to the same kernel in both packages
    if sub and min(b, 1024) % 128 == 0:
        gm, sm = gmax_f_sub(
            queries, vectors, extra, sub=sub, dual=bool(CONFIG.pallas_sub_dual)
        )
        sidx = _select_subgroups(gm, sm, b, n, k, sub)
        cs = _rescore(queries, vectors, extra, sidx, sub)
        return finish_candidates(cs, sidx, b, k, sub)
    gm = gmax_f(queries, vectors, extra)
    _, gidx = exact_top_k(gm, k)
    cs = _rescore(queries, vectors, extra, gidx, GROUP)
    return finish_candidates(cs, gidx, b, k, GROUP)


def rank_top_k_grouped_metric_gmax(
    queries, rows, row_aux, k: int, metric: str, row_mask=None
):
    """Euclidean/hamming/jaccard grouped exact top-k with the stage-1
    kernels; the counterpart of ``pallas_gmax._grouped_metric_pallas_impl``.

    Euclidean and hamming scores are monotone transforms of the per-row
    SURROGATE ``u = 2 q.v - aux`` (aux = |v|^2 over raw rows, popcount |vb|
    over 0/1 rows):

        euclidean: 1/(1 + sqrt(max(|q|^2 - u, 0)))   — non-decreasing in u
        hamming:   (d - |qb|) + u                     — affine in u

    so a group's best true score sits where its best u does, and stage 1
    rides the dot kernels with the query doubled (a power-of-two scale:
    bitwise ``2*(q.v)`` in the f32 accumulator) and ``extra = mask - aux``.
    Jaccard has no dot surrogate (|vb| varies inside the ratio): its stage 1
    is :func:`gmax_jaccard`, single-level. Stage 3 rescores with the TRUE
    metric. Recency is added after the transform and breaks the
    monotonicity, so callers route recency queries to the plain form.
    ``ranking.rank_top_k_grouped_metric`` sends only inputs that
    :func:`supported` accepts; anything else raises.
    """
    from hyperdb_tpu_torch.ops.ranking import GROUPED_METRICS, _grouped_metric_scores

    q32, qq = grouped_metric_operands(queries, rows, metric)
    if metric not in GROUPED_METRICS or not supported(qq, rows, k):
        raise ValueError(
            "rank_top_k_grouped_metric_gmax takes euclidean/hamming/jaccard over a "
            f"bf16 plane with N % 128 == 0, N // 128 >= k and d % 8 == 0; got {metric}, "
            f"{tuple(queries.shape)} x {tuple(rows.shape)} {rows.dtype}, k={k}"
        )
    sub = CONFIG.pallas_subgroup
    if not (8 <= sub < GROUP and GROUP % sub == 0):
        sub = 0
    n, d = rows.shape
    b = queries.shape[0]
    aux32 = row_aux.float()
    mask_extra = make_extra(n, row_mask, device=rows.device)

    def finish(cidx, width):
        cs = _grouped_metric_scores(
            gather_dot(qq, rows, cidx, width),
            aux32.view(n // width, width)[cidx], q32, metric, d,
        )
        cs.masked_fill_(torch.isnan(cs), NEG_INF)
        if row_mask is not None:
            cs.masked_fill_(~row_mask.view(n // width, width)[cidx], NEG_INF)
        return finish_candidates(cs, cidx, b, k, width)

    if metric == "jaccard_similarity":
        gm = gmax_jaccard(qq, rows, q32.sum(-1, keepdim=True), aux32, mask_extra)
    else:
        extra = mask_extra - aux32  # -inf on masked rows survives
        if sub and min(b, 1024) % 128 == 0:  # the float route's tile rule
            gm, sm = gmax_f_sub(
                qq * 2, rows, extra, sub=sub, dual=bool(CONFIG.pallas_sub_dual)
            )
            return finish(_select_subgroups(gm, sm, b, n, k, sub), sub)
        gm = gmax_f(qq * 2, rows, extra)
    _, gidx = exact_top_k(gm, k)
    return finish(gidx, GROUP)


def supported_int8(q_i8, v_i8, k: int) -> bool:
    """Shapes and types :func:`gmax_int8` takes: int8 operands,
    N % 128 == 0 with at least k groups, and d % 16 == 0 (16-byte copies of
    one-byte elements)."""
    n, d = v_i8.shape
    return (
        q_i8.dtype == torch.int8
        and v_i8.dtype == torch.int8
        and n % GROUP == 0
        and n // GROUP >= k
        and d % 16 == 0
    )


def rank_top_k_int8_gmax(queries, v_i8, v_scales, k: int, row_mask=None, recency=None):
    """Int8 grouped top-k with the stage-1 kernel (quantized scores, no
    full-precision rescore rows); the counterpart of
    ``pallas_gmax.rank_top_k_int8_pallas``. Stage 3 is the exact group
    rescore ``quantized.rank_top_k_int8`` pairs with :func:`gmax_int8`.
    Inputs outside :func:`supported_int8` raise."""
    from hyperdb_tpu_torch.ops.quantized import _quantize_device, _rescore_groups

    q_i8, q_scale = _quantize_device(queries.float())
    if not supported_int8(q_i8, v_i8, k):
        raise ValueError(
            "rank_top_k_int8_gmax takes an int8 plane with N % 128 == 0, "
            f"N // 128 >= k and d % 16 == 0; got {tuple(v_i8.shape)} {v_i8.dtype}, k={k}"
        )
    extra = make_extra(v_i8.shape[0], row_mask, recency, device=v_i8.device)
    gm = gmax_int8(q_i8, q_scale, v_i8, v_scales, extra)
    _, gidx = exact_top_k(gm, k)
    return _rescore_groups(q_i8, q_scale, v_i8, v_scales, gidx, GROUP, row_mask, recency)
