"""Stage-1 manhattan (L1) scan kernels and the three-stage exact top-k route.

Counterpart of ``hyperdb_tpu/ops/pallas_l1.py``. Manhattan (score
``1/(1 + L1)``) has no matrix-product form: its scan is ``B*N*d``
subtract / absolute-value / add steps on the CUDA cores. Stage 1 keeps one
number per (query, 128-row group) and never writes the (B, N) distances:

- :func:`gmax_l1` replaces ``pallas_l1.gmax_l1`` (kernel body
  ``_l1_kernel``, ``pallas_l1.py:113``): group MAXES of ``extra - L1(q, v)``
  over the row-major (N, d) corpus. A corpus NaN reads as -inf and a query
  NaN as +inf, so any NaN operand gives a distance of +inf and a score of
  -inf.
- :func:`gmax_l1t` replaces ``pallas_l1.gmax_l1t`` (``_l1t_kernel``,
  ``pallas_l1.py:280``): group MINS of ``L1(q, v)`` over a transposed (d, N)
  corpus. Dead rows (``extra`` = -inf) read as +inf, a corpus NaN as -inf
  and a query NaN as the finite 1e30, so ``inf - inf`` never appears; the
  caller negates.

``extra`` is the mask only (0 live, -inf masked or padding): the true score
is a strictly increasing function of ``-L1``, so the best groups by ``-L1``
are the best by score, but recency added to the score breaks that, and
recency queries take the streamed scan.

The kernels' d-sum order differs from torch's ``sum(-1)``, so group maxes
carry f32 summation noise against the rescore's distances. Stage 2
therefore fetches ``k + L1_GROUP_MARGIN`` groups, and stage 3 rescores
their rows with ``ranking.manhattan_block_scores``, the expression the
streamed scan scores with, and takes the final top-k: the route returns the
streamed scan's ids and scores unless more than the margin of group maxes
sit within summation noise of the k-th.

Bound on the H100: operations. Each of the ``B*N*d`` elements costs two
FP32 operations (subtract; add with the ``|x|`` operand modifier) on the
CUDA cores, against one read of the corpus: at b = 512, N = 2^20, d = 384
that is 4.1e11 operations (12.3 ms at 33.5e12 lane-operations/s)
against 0.8 GB (0.24 ms). The kernel (``csrc/l1.cu``) keeps a (4 rows x 8
queries) tile of sums in each thread's registers and reads both operands
from shared memory, 64 FP32 operations for three 16-byte loads.

Each wrapper takes its plain PyTorch version for CPU tensors only; for a
CUDA tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.ops import cuda_build
from hyperdb_tpu_torch.ops import metrics as _metrics
from hyperdb_tpu_torch.ops.gmax import make_extra
from hyperdb_tpu_torch.ops.ranking import (
    _CHUNK_CELLS,
    _manhattan_tile,
    _scrub,
    exact_top_k,
    finish_candidates,
    manhattan_block_scores,
    rank_top_k_manhattan_stream,
)

GROUP = 128  # rows per group; the kernel's corpus block

# Stage-2 group overfetch that absorbs the f32 summation-order noise between
# the kernels' group maxes and the rescore at the k-th group boundary.
L1_GROUP_MARGIN = 12

# Above this many corpus bytes the transposed copy is not made and stage 1
# scans the corpus in place (gmax_l1).
_L1T_MAX_BYTES = 4 << 30

# The finite stand-in for a NaN query coordinate in gmax_l1t: every finite
# row's distance becomes ~d * 1e30 (below the f32 maximum for d <= 4096).
_L1T_NAN_QUERY = 1e30

LAUNCHES = {"gmax_l1": 0, "gmax_l1t": 0}

NEG_INF = float("-inf")
INF = float("inf")

# the `kind` argument of csrc/l1.cu's l1_scan
_KIND_L1, _KIND_L1T = 0, 1

_CORPUS_DTYPES = (torch.float32, torch.bfloat16)


def _scan_fn():
    lib = cuda_build.load("l1")
    fn = lib.l1_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch(kind, queries, corpus, extra, n: int):
    """Check the operands, allocate the (B, n/128) output and launch."""
    fn = _scan_fn()  # builds on first use; raises if the library cannot be built
    b, d = queries.shape
    want = (d, n) if kind == _KIND_L1T else (n, d)
    tensors = (queries, corpus, extra)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the L1 kernels take CUDA tensors")
    if queries.dtype != torch.float32 or corpus.dtype not in _CORPUS_DTYPES:
        raise ValueError("the L1 kernels take float32 queries and a float32 or bfloat16 corpus")
    if extra.dtype != torch.float32 or extra.shape != (n,):
        raise ValueError("extra must be an (N,) float32 vector")
    if tuple(corpus.shape) != want or n % GROUP or d % 8:
        raise ValueError(
            f"unsupported shapes q={tuple(queries.shape)} corpus={tuple(corpus.shape)}"
        )
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the L1 kernels take contiguous 16-byte-aligned tensors")
    out = torch.empty((b, n // GROUP), dtype=torch.float32, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    rc = fn(
        kind, int(corpus.dtype == torch.bfloat16), queries.data_ptr(), corpus.data_ptr(),
        extra.data_ptr(), out.data_ptr(), b, n, d, stream,
    )
    if rc:
        raise RuntimeError(f"l1_scan launch failed: cudaError {rc}")
    return out


# ---------------------------------------------------------------- plain


def _plain_distances(q32, corpus, transposed: bool):
    """Yield (start, (c, N) f32 L1 distances) over query chunks, the corpus
    walked in row blocks so the (c, rows, d) difference stays bounded."""
    n = corpus.shape[1] if transposed else corpus.shape[0]
    d = q32.shape[1]
    rows = min(n, 8192)
    chunk = max(1, _CHUNK_CELLS // (rows * d))
    for a in range(0, q32.shape[0], chunk):
        qc = q32[a : a + chunk]
        parts = []
        for r in range(0, n, rows):
            vb = corpus[:, r : r + rows].T if transposed else corpus[r : r + rows]
            vb = vb.float()
            vb = vb.masked_fill(torch.isnan(vb), NEG_INF)
            parts.append((vb[None] - qc[:, None, :]).abs_().sum(-1))
        yield a, torch.cat(parts, dim=1)


def gmax_l1_plain(queries, vectors, extra):
    """Plain version of :func:`gmax_l1`: (B, N/128) f32 group maxes of
    ``extra - L1``, corpus NaN -> -inf, query NaN -> +inf."""
    b, n = queries.shape[0], vectors.shape[0]
    q32 = queries.float()
    q32 = q32.masked_fill(torch.isnan(q32), INF)
    gm = torch.empty((b, n // GROUP), dtype=torch.float32, device=queries.device)
    for a, dist in _plain_distances(q32, vectors, transposed=False):
        s = extra[None, :] - dist
        gm[a : a + s.shape[0]] = s.view(s.shape[0], n // GROUP, GROUP).amax(-1)
    return gm


def gmax_l1t_plain(queries, vectors_t, extra):
    """Plain version of :func:`gmax_l1t`: (B, N/128) f32 group mins of
    ``L1`` over the (d, N) corpus, dead rows +inf, corpus NaN -> -inf,
    query NaN -> 1e30."""
    b, n = queries.shape[0], vectors_t.shape[1]
    q32 = queries.float()
    q32 = q32.masked_fill(torch.isnan(q32), _L1T_NAN_QUERY)
    dead = torch.isinf(extra)
    gm = torch.empty((b, n // GROUP), dtype=torch.float32, device=queries.device)
    for a, dist in _plain_distances(q32, vectors_t, transposed=True):
        dist = dist.masked_fill_(dead[None, :], INF)
        gm[a : a + dist.shape[0]] = dist.view(dist.shape[0], n // GROUP, GROUP).amin(-1)
    return gm


# ---------------------------------------------------------------- kernels


def gmax_l1(queries, vectors, extra):
    """Per-128-row-group maxes of ``extra - L1(q, v)``.

    Args:
        queries: (B, d) f32, d % 8 == 0.
        vectors: (N, d) f32 or bf16 corpus, N % 128 == 0.
        extra: (N,) f32 mask term (0 live, -inf masked or padding; no
            recency).

    Returns: (B, N/128) f32 group maxes of the negated distances. Within
    f32 summation noise of :func:`gmax_l1_plain` (another d-sum order):
    rtol 1e-5, atol 1e-4 at d = 384; -inf entries agree exactly.
    """
    if queries.device.type == "cpu":
        return gmax_l1_plain(queries, vectors, extra)
    gm = _launch(_KIND_L1, queries, vectors, extra, vectors.shape[0])
    LAUNCHES["gmax_l1"] += 1
    return gm


def gmax_l1t(queries, vectors_t, extra):
    """Per-128-row-group mins of ``L1(q, v)`` over a transposed corpus.

    Args:
        queries: (B, d) f32, d % 8 == 0.
        vectors_t: (d, N) f32 or bf16 transposed corpus, N % 128 == 0.
        extra: (N,) f32 mask term (0 live, -inf masked or padding).

    Returns: (B, N/128) f32 group mins of the distances (+inf where a whole
    group is dead); negate for the ``-L1`` surrogate stage 2 ranks on. Same
    tolerance against :func:`gmax_l1t_plain` as :func:`gmax_l1`.
    """
    if queries.device.type == "cpu":
        return gmax_l1t_plain(queries, vectors_t, extra)
    gm = _launch(_KIND_L1T, queries, vectors_t, extra, vectors_t.shape[1])
    LAUNCHES["gmax_l1t"] += 1
    return gm


# ---------------------------------------------------------------- route


def supported(queries, vectors) -> bool:
    """Shapes and types :func:`gmax_l1` takes: a float32 or bfloat16 (N, d)
    corpus with N % 128 == 0, at least two groups, and d % 8 == 0 (16-byte
    loads of a row's bf16 values). Any batch height and any float query
    dtype pass: the route upcasts the queries and the kernel masks a ragged
    query tile."""
    n, d = vectors.shape
    return (
        vectors.dtype in _CORPUS_DTYPES
        and queries.is_floating_point()
        and n % GROUP == 0
        and n // GROUP >= 2
        and d % 8 == 0
    )


def supported_t(queries, vectors) -> bool:
    """Shapes and types :func:`gmax_l1t` takes, given the (N, d) corpus its
    transposed copy would be made from: those of :func:`supported` (the
    CUDA kernel has no block rule of its own for the transposed layout)."""
    return supported(queries, vectors)


def rank_top_k_manhattan_l1(queries, vectors, k: int, row_mask=None, recency=None):
    """Manhattan exact top-k with the L1 stage-1 kernels; the counterpart
    of ``pallas_l1.rank_top_k_manhattan_pallas``.

    Stage 1: per-group maxes of ``-L1`` (:func:`gmax_l1t` over a transposed
    copy made here while ``CONFIG.pallas_l1t`` is set and the corpus is
    under ``_L1T_MAX_BYTES``, else :func:`gmax_l1` in place). Stage 2:
    :func:`exact_top_k` over (B, g), fetching ``min(k + L1_GROUP_MARGIN,
    g)`` groups. Stage 3: gather those groups' rows, rescore them with the
    true ``1/(1 + L1)`` (NaN -> -inf, then the mask), final top-k.

    As in the JAX route, recency, shapes outside :func:`supported` and
    corpora of fewer than ``k`` groups are routed to the streamed scan, or
    to the materialising form where no tile divides the corpus; these are
    branches decided from the arguments, not a rescue: on a CUDA tensor a
    kernel that cannot be built or launched raises.
    """
    n, d = vectors.shape
    b = queries.shape[0]
    if recency is not None or not supported(queries, vectors) or n // GROUP < k:
        tile = _manhattan_tile(b, n, k)
        if tile:
            return rank_top_k_manhattan_stream(
                queries, vectors, k, row_mask=row_mask, recency=recency, tile=tile
            )
        s = _scrub(_metrics.manhattan_scores(queries, vectors), row_mask, recency)
        return exact_top_k(s, k)

    q32 = queries.float().contiguous()
    extra = make_extra(n, row_mask, device=vectors.device)  # the mask only
    if (
        CONFIG.pallas_l1t
        and supported_t(queries, vectors)
        and n * d * vectors.element_size() <= _L1T_MAX_BYTES
    ):
        gm = -gmax_l1t(q32, vectors.t().contiguous(), extra)
    else:
        gm = gmax_l1(q32, vectors, extra)
    g = n // GROUP
    m = min(k + L1_GROUP_MARGIN, g)
    _, gidx = exact_top_k(gm, m)  # (B, m)
    return _rescore_groups(q32, vectors, gidx, k, row_mask)


def _rescore_groups(q32, vectors, gidx, k: int, row_mask=None):
    """Stage 3: the true scores of the (B, m) groups ``gidx`` and the final
    top-k over them -> (values, global row ids). Chunked over queries to
    bound the gathered (c, m * 128, d) block; chunking changes no result."""
    n, d = vectors.shape
    b, m = gidx.shape
    g = n // GROUP
    r3 = vectors.view(g, GROUP, d)
    mask3 = None if row_mask is None else row_mask.view(g, GROUP)
    cs = torch.empty((b, m, GROUP), dtype=torch.float32, device=vectors.device)
    chunk = max(1, _CHUNK_CELLS // (m * GROUP * d))
    for a in range(0, b, chunk):
        gi = gidx[a : a + chunk]
        c = gi.shape[0]
        cand = r3[gi].view(c, m * GROUP, d)
        cs[a : a + c] = manhattan_block_scores(q32[a : a + c], cand).view(c, m, GROUP)
    if mask3 is not None:
        cs.masked_fill_(~mask3[gidx], NEG_INF)
    return finish_candidates(cs, gidx, b, k, GROUP)
