"""Stage-1 grouped-max scan kernels and the three-stage exact top-k route.

Counterpart of ``hyperdb_tpu/ops/pallas_gmax.py`` (the float route): stage 1
computes ``s = q . v + extra`` with f32 accumulation over bf16 operands,
scrubs NaN to -inf, and keeps only the max of every ``sub``-row subgroup
and/or 128-row group; stage 2 selects the top-k groups, then the top-k
subgroups inside them (:func:`_select_subgroups`); stage 3 gathers those
rows, rescores them in f32 and takes the final top-k
(:func:`_finish_candidates`). ``extra`` folds masks and recency into one
additive vector (0 or the recency on live rows, -inf on masked or padding
rows), so stage 1 and stage 3 score the same function and the containment
argument of the JAX route holds: every true top-k row lives in a selected
subgroup, up to ties at the k-th value.

Kernels (``csrc/gmax.cu``, one templated CUDA kernel for both):

- :func:`gmax_f_sub` replaces ``pallas_gmax.gmax_f_sub`` (kernel body
  ``pallas_gmax.py:318``): subgroup maxes, plus the group maxes in the dual
  form or as a max over each run of 128/sub subgroups in the single form.
- :func:`gmax_f` replaces ``pallas_gmax.gmax_f`` (``_gmax_kernel_f``,
  ``pallas_gmax.py:121``): group maxes only.

Bound on the H100: compute — 2*B*N*d operations over bf16 tensor cores
against one read of the (N, d) corpus; at b = 512 and N = 2^20, d = 384
that is 0.41 TFLOP against 0.8 GB, about 500 operations per byte, above
the card's ~295. The kernel therefore runs the product on tensor cores
(``mma.sync`` bf16) and keeps the (B, N) score matrix out of device memory,
writing only the maxes; see the source for the tiling.

Each wrapper takes its plain PyTorch version for CPU tensors only; for a
CUDA tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.ops import cuda_build
from hyperdb_tpu_torch.ops.ranking import exact_top_k

GROUP = 128  # rows per group; the kernel's corpus block

LAUNCHES = {"gmax_f_sub": 0, "gmax_f": 0}

NEG_INF = float("-inf")

# f32 score cells per chunk of the plain versions and of the stage-3
# rescore: bounds their temporaries at full corpus size on the card.
_CHUNK_CELLS = 1 << 28


def _scan_fn():
    lib = cuda_build.load("gmax")
    fn = lib.gmax_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(queries, vectors, extra, sub):
    b, d = queries.shape
    n = vectors.shape[0]
    if not (queries.is_cuda and vectors.is_cuda and extra.is_cuda):
        raise ValueError("gmax kernels take CUDA tensors")
    if queries.dtype != torch.bfloat16 or vectors.dtype != torch.bfloat16:
        raise ValueError("gmax kernels take bf16 queries and corpus")
    if extra.dtype != torch.float32 or extra.shape != (n,):
        raise ValueError("extra must be an (N,) float32 vector")
    if vectors.shape[1] != d or n % GROUP or d % 8:
        raise ValueError(f"unsupported shapes q={tuple(queries.shape)} v={tuple(vectors.shape)}")
    if sub and not (8 <= sub <= GROUP and GROUP % sub == 0):
        raise ValueError(f"sub ({sub}) must divide {GROUP} and be at least 8")
    for t in (queries, vectors, extra):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("gmax kernels take contiguous 16-byte-aligned tensors")


def _launch(queries, vectors, extra, sm, gm, sub):
    fn = _scan_fn()  # builds on first use; raises if the library cannot be built
    _check(queries, vectors, extra, sub)
    b, d = queries.shape
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    rc = fn(
        queries.data_ptr(), vectors.data_ptr(), extra.data_ptr(),
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
    _launch(queries, vectors, extra, None, gm, 0)
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
    _launch(queries, vectors, extra, sm, gm, sub)
    LAUNCHES["gmax_f_sub"] += 1
    if gm is None:
        gm = sm.view(b, n // GROUP, GROUP // sub).amax(-1)
    return gm, sm


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
    (each ``width`` rows) -> (B, k, width), NaN -> -inf, then + extra.

    Both operands are upcast before the product: a bf16 product on the card
    would round its output to bf16. Chunked over queries to bound the
    gathered (c, k, width, d) block; chunking changes no result."""
    n, d = vectors.shape
    b, k = cidx.shape
    r3 = vectors.view(n // width, width, d)
    cs = torch.empty((b, k, width), dtype=torch.float32, device=queries.device)
    chunk = max(1, (_CHUNK_CELLS * 4) // (k * width * d))
    for a in range(0, b, chunk):
        cand = r3[cidx[a : a + chunk]].float()  # (c, k, width, d)
        c = cand.shape[0]
        q = queries[a : a + chunk].float()
        cs[a : a + c] = torch.matmul(
            cand.view(c, k * width, d), q[:, :, None]
        ).view(c, k, width)
    cs.masked_fill_(torch.isnan(cs), NEG_INF)
    return cs + extra.view(n // width, width)[cidx]


def _finish_candidates(cs, sidx, b: int, k: int, width: int):
    """Final top-k over (B, k, width) rescored candidates -> global row ids."""
    vals, pos = exact_top_k(cs.reshape(b, k * width), k)
    winner = torch.gather(sidx, 1, pos // width)
    return vals, winner * width + pos % width


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
        return _finish_candidates(cs, sidx, b, k, sub)
    gm = gmax_f(queries, vectors, extra)
    _, gidx = exact_top_k(gm, k)
    cs = _rescore(queries, vectors, extra, gidx, GROUP)
    return _finish_candidates(cs, gidx, b, k, GROUP)
