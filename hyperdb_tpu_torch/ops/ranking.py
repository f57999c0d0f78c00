"""Scoring + recency + mask + exact top-k, as tensor code around the kernels.

Counterpart of ``hyperdb_tpu/ops/ranking.py``: the router
:func:`rank_top_k`, its planar form :func:`rank_top_k_planar` (a corpus
stored as separate planes), the plain grouped form
:func:`rank_top_k_grouped`, the grouped euclidean/hamming/jaccard form
:func:`rank_top_k_grouped_metric`, the streamed manhattan scan
:func:`rank_top_k_manhattan_stream`, the chunk-aware document ranking
:func:`rank_docs_top_k`, the materialising fallback over the seven
metrics, the IVF candidate scan :func:`rank_gathered`, and the reference's
list-level :func:`ranking_algorithm_sort`. Batches over a bf16 plane go
to the stage-1 kernels (``ops/gmax.py``) at or above
``CONFIG.pallas_gmax_f_min_batch``, and on the card the dot-form ones at
every height (:func:`_use_gmax`); manhattan batches at or above
``CONFIG.pallas_l1_min_batch`` to the L1 kernels (``ops/l1.py``). The
grouped routes' stage 3, :func:`gather_dot`, runs bf16 operands on the card
through ``csrc/gather_dot.cu`` (``LAUNCHES`` counts its launches).

Semantics kept from the reference ranker (ranking_algorithm.py:149-204):
NaN scores become -inf before recency is added; masks act as an additive
-inf; ties go to the lower position, which is ``lax.top_k``'s order and the
one the grouped routes rely on (see :func:`exact_top_k`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.ops import cuda_build
from hyperdb_tpu_torch.ops import metrics as _metrics
from hyperdb_tpu_torch.ops.metrics import LOW_PRECISION, scores
from hyperdb_tpu_torch.utils import trace as _trace

NEG_INF = float("-inf")

_LOW32 = (1 << 32) - 1

# f32 score cells per chunk of the plain forms and of the stage-3 rescore:
# bounds their temporaries at full corpus size on the card.
_CHUNK_CELLS = 1 << 28

# launches of csrc/gather_dot.cu (stage 3 over bf16 operands on the card)
LAUNCHES = {"gather_dot": 0}


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


def gather_dot(queries, rows, cidx, width: int):
    """Stage 3's product: exact f32 inner products of each query with its
    (B, k) candidate runs ``cidx`` of ``width`` rows -> (B, k, width).

    bf16 operands on the card go to one hand-written kernel
    (:func:`gather_dot_kernel`) that reads each run in place. Everything else
    (CPU tensors, int8 rows, f16 and f32 rows) takes :func:`gather_dot_plain`."""
    if queries.is_cuda and rows.is_cuda and queries.dtype == rows.dtype == torch.bfloat16:
        return gather_dot_kernel(queries, rows, cidx, width)
    return gather_dot_plain(queries, rows, cidx, width)


def gather_dot_plain(queries, rows, cidx, width: int):
    """Plain form of :func:`gather_dot`. Both operands are upcast before the
    product: a bf16 product on the card would round its output to bf16 (int8
    rows upcast exactly). Chunked over queries to bound the gathered
    (c, k, width, d) block; chunking changes no result. A chunk never holds
    a lone query unless b is 1: the batched product takes another path, which
    rounds otherwise, for a batch of one."""
    n, d = rows.shape
    b, k = cidx.shape
    r3 = rows.view(n // width, width, d)
    out = torch.empty((b, k, width), dtype=torch.float32, device=queries.device)
    chunk = max(2, (_CHUNK_CELLS * 4) // (k * width * d))
    a = 0
    while a < b:
        e = b if b - a <= chunk + 1 else a + chunk
        cand = r3[cidx[a:e]].float()  # (c, k, width, d)
        c = e - a
        out[a:e] = torch.matmul(
            cand.view(c, k * width, d), queries[a:e].float()[:, :, None]
        ).view(c, k, width)
        a = e
    return out


def _gather_dot_fn():
    fn = cuda_build.load("gather_dot").gather_dot
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def gather_dot_kernel(queries, rows, cidx, width: int):
    """:func:`gather_dot` through ``csrc/gather_dot.cu``: (B, d) bf16
    queries, an (N, d) bf16 plane with N % width == 0 and d % 8 == 0, (B, k)
    int64 run ids, all CUDA tensors on one device, contiguous and 16-byte
    aligned; anything else raises. Sums in another order than the plain
    form's GEMV, the same from launch to launch."""
    n, d = rows.shape
    b, k = cidx.shape
    tensors = (queries, rows, cidx)
    if not all(t.is_cuda and t.device == rows.device for t in tensors):
        raise ValueError("gather_dot_kernel takes CUDA tensors on one device")
    if queries.dtype != torch.bfloat16 or rows.dtype != torch.bfloat16:
        raise ValueError("gather_dot_kernel takes bfloat16 queries and rows")
    if cidx.dtype != torch.int64:
        raise ValueError("gather_dot_kernel takes int64 run ids")
    if tuple(queries.shape) != (b, d) or width <= 0 or n % width or d % 8:
        raise ValueError(
            f"unsupported shapes q={tuple(queries.shape)} rows={tuple(rows.shape)} "
            f"cidx={tuple(cidx.shape)} width={width}"
        )
    if not all(t.is_contiguous() for t in tensors) or (queries.data_ptr() | rows.data_ptr()) % 16:
        raise ValueError("gather_dot_kernel takes contiguous tensors, 16-byte-aligned operands")
    out = torch.empty((b, k, width), dtype=torch.float32, device=rows.device)
    if out.numel() == 0:
        return out
    fn = _gather_dot_fn()  # builds on first use; raises if the library cannot be built
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = fn(
        queries.data_ptr(), rows.data_ptr(), cidx.data_ptr(), out.data_ptr(),
        b, k, width, d, n // width, stream,
    )
    if rc:
        raise RuntimeError(f"gather_dot launch failed: cudaError {rc}")
    LAUNCHES["gather_dot"] += 1
    return out


def finish_candidates(cs, sidx, b: int, k: int, width: int):
    """Final top-k over (B, m, width) rescored candidates of the (B, m >= k)
    runs ``sidx`` -> global row ids."""
    vals, pos = exact_top_k(cs.reshape(b, -1), k)
    winner = torch.gather(sidx, 1, pos // width)
    return vals, winner * width + pos % width


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
    with _trace.span("route.plain", vectors):
        s = _scrub(_metrics.qv_dot(queries, vectors), row_mask, recency)
        if n % group or n <= k * group:
            return exact_top_k(s, k)
        return exact_top_k_grouped(s, k, group=group)


def _manhattan_tile(batch: int, n: int, k: int = 1) -> int:
    """Row tile of the streamed manhattan scan (0 = no valid tile): the JAX
    package's arithmetic, because the tile decides routing.

    ``batch * tile <= 2^22`` score cells, a power of two that divides ``n``
    with at least two tiles, and at least ``k`` rows (the stream seeds its
    carry from tile 0). Odd row counts have no tile and take the
    materialising form."""
    floor = max(512, 1 << max(0, (min(k, n) - 1)).bit_length())
    cap = max(floor, min(8192, (1 << 22) // max(batch, 1)))
    tile = 1 << (cap.bit_length() - 1)  # round down to a power of two
    while tile >= floor and n % tile:
        tile //= 2
    return tile if tile >= floor and n % tile == 0 and n // tile >= 2 else 0


def manhattan_block_scores(q32, rows):
    """``1/(1 + sum_d |v - q|)`` with NaN -> -inf, in f32.

    ``q32`` is a (c, d) f32 query chunk; ``rows`` is one (r, d) block shared
    by the chunk's queries or a (c, r, d) block of per-query candidates.
    Returns (c, r). The streamed scan's tiles and the kernel route's stage-3
    rescore both score through this one expression, over a contiguous
    (c, r, d) difference, so a row gets the same bits from either."""
    r32 = rows.float()
    if r32.ndim == 2:
        r32 = r32[None]
    dist = (r32 - q32[:, None, :]).abs_().sum(-1)
    s = 1.0 / (1.0 + dist)
    return s.masked_fill_(torch.isnan(s), NEG_INF)


def rank_top_k_manhattan_stream(
    queries, vectors, k: int, row_mask=None, recency=None, tile: int = 2048
):
    """Streamed manhattan top-k: the (B, N) score matrix never exists
    (``ranking.rank_top_k_manhattan_stream`` in the JAX package).

    The corpus goes by in row tiles; a (B, k) carry holds the running exact
    top-k. Per tile: ``1/(1 + L1)``, NaN -> -inf, ``+ recency``, the mask,
    then one :func:`exact_top_k` over ``[carry | tile scores]``. The carry
    is seeded from tile 0's real scores (so -inf entries carry true row
    ids), always holds rows of earlier tiles, and sits LEFT of the tile in
    the merge; ``exact_top_k`` prefers the lower position, so ties go to
    the lower row id exactly as one top-k over the full matrix would.
    Needs ``tile | n`` and ``k <= tile`` (:func:`_manhattan_tile` gives
    both). Eager torch materialises the (c, tile, d) difference of a tile,
    so each tile is scored a chunk of queries at a time; the tile, and so
    the routing, is the JAX package's."""
    b = queries.shape[0]
    n, d = vectors.shape
    if n % tile:
        raise ValueError(f"tile ({tile}) must divide corpus rows ({n})")
    k_eff = min(k, n)
    if k_eff > tile:
        raise ValueError(f"k ({k_eff}) must be <= tile ({tile})")
    q32 = queries.float()
    rec32 = None if recency is None else recency.float()
    chunk = max(1, _CHUNK_CELLS // (tile * d))
    base = torch.arange(tile, device=vectors.device)
    cv = ci = None
    for t in range(n // tile):
        rows = slice(t * tile, (t + 1) * tile)
        vb = vectors[rows]
        s = torch.cat(
            [manhattan_block_scores(q32[a : a + chunk], vb) for a in range(0, b, chunk)]
        )
        if rec32 is not None:
            s = s + rec32[rows][None, :]
        if row_mask is not None:
            s = s.masked_fill(~row_mask[rows][None, :], NEG_INF)
        if cv is None:
            cv, ci = exact_top_k(s, k_eff)
            continue
        allv = torch.cat([cv, s], dim=1)
        alli = torch.cat([ci, (base + t * tile)[None, :].expand(b, tile)], dim=1)
        cv, pos = exact_top_k(allv, k_eff)
        ci = torch.gather(alli, 1, pos)
    return cv, ci


# Metrics served by rank_top_k_grouped_metric: one matmul plus a per-row
# scalar turn the exact score into an epilogue of the grouped product.
GROUPED_METRICS = ("euclidean_metric", "hamming_distance", "jaccard_similarity")


def _grouped_metric_scores(inter, aux, q32, metric: str, dim: int):
    """Exact similarity from the inner-product term + per-row constants.

    ``inter`` is q.v (euclidean, over raw rows) or qb.vb (hamming/jaccard,
    over 0/1 binarized rows) with any leading/group shape; ``aux`` broadcasts
    against it carrying |v|^2 (euclidean) or popcount |vb| (hamming/jaccard).
    ``q32`` is the (B, d) f32 query block (raw or binarized to match rows).
    """
    lead = (-1,) + (1,) * (inter.ndim - 1)
    if metric == "euclidean_metric":
        qsq = torch.sum(q32 * q32, dim=-1).view(lead)
        d2 = aux - 2.0 * inter + qsq
        return 1.0 / (1.0 + torch.sqrt(torch.clamp(d2, min=0.0)))
    qsum = torch.sum(q32, dim=-1).view(lead)
    if metric == "hamming_distance":
        return float(dim) - (aux + qsum - 2.0 * inter)
    if metric == "jaccard_similarity":
        union = aux + qsum - inter
        return inter / union  # 0/0 -> NaN, scrubbed to -inf by the caller
    raise ValueError(f"metric '{metric}' has no grouped epilogue form")


def grouped_metric_operands(queries, rows, metric: str):
    """(q32, qq): the f32 query block the epilogue reads (binarized ``x > 0``
    for hamming/jaccard) and the block the product takes, cast to a
    low-precision plane's dtype."""
    if metric in ("hamming_distance", "jaccard_similarity"):
        q32 = (queries > 0).float()
    else:
        q32 = queries.float()
    return q32, _metrics._match_low_precision(q32, rows)


def rank_top_k_grouped_metric(
    queries, rows, row_aux, k: int, metric: str,
    row_mask=None, recency=None, group: int = 128,
):
    """Grouped exact top-k for euclidean/hamming/jaccard
    (``ranking.rank_top_k_grouped_metric`` in the JAX package).

    These metrics are one matmul plus per-row constants (reference
    ranking_algorithm.py:44-52,63-75,128-147):

        euclidean:  1/(1 + sqrt(|v|^2 - 2 q.v + |q|^2))
        hamming:    d - (|vb| + |qb| - 2 qb.vb)        (0/1 rows)
        jaccard:    qb.vb / (|vb| + |qb| - qb.vb)      (0/1 rows)

    so stage 1 computes the exact score, keeps each group's max and selects
    the top-k groups, and stage 3 recomputes it on those groups' gathered
    rows. Without recency, big batches over a bf16 plane go to the stage-1
    kernels (``gmax.rank_top_k_grouped_metric_gmax``); recency breaks the
    surrogate's monotonicity, so recency queries stay here. The plain form
    scores chunks of queries at a time and, on the card, multiplies the
    low-precision plane as it is (``metrics.dot_f32``).

    Args:
        queries: (B, d) raw query block (binarized here for hamming/jaccard).
        rows: (N, d) corpus — RAW rows for euclidean, 0/1 rows (``x > 0``)
            for hamming/jaccard (``VectorStore.binary_view``).
        row_aux: (N,) f32 — |v|^2 (euclidean) or popcount |vb|; zero on
            padding rows.
        k, row_mask, recency, group: as in :func:`rank_top_k_grouped`.
    """
    if metric not in GROUPED_METRICS:
        raise ValueError(f"metric '{metric}' has no grouped epilogue form")
    q32, qq = grouped_metric_operands(queries, rows, metric)
    n, d = rows.shape
    b = queries.shape[0]

    # the batch floor holds on the card too: its sweep timed the dot route,
    # whose plain form upcasts the plane to f32; this one multiplies it as
    # it is (``metrics.dot_f32``)
    if recency is None and _use_gmax(qq, rows, k, small_on_card=False):
        from hyperdb_tpu_torch.ops.gmax import rank_top_k_grouped_metric_gmax

        return rank_top_k_grouped_metric_gmax(
            queries, rows, row_aux, k, metric, row_mask=row_mask
        )

    grouped = not (n % group or n <= k * group)
    chunk = max(1, _CHUNK_CELLS // n)
    parts = []
    for a in range(0, b, chunk):
        s = _grouped_metric_scores(
            _metrics.dot_f32(qq[a : a + chunk], rows), row_aux[None, :],
            q32[a : a + chunk], metric, d,
        )
        s = _scrub(s, row_mask, recency)
        parts.append(
            s.view(s.shape[0], n // group, group).amax(-1) if grouped else exact_top_k(s, k)
        )
    if not grouped:
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    _, gidx = exact_top_k(torch.cat(parts), k)  # (B, k)
    g = n // group
    cs = _grouped_metric_scores(
        gather_dot(qq, rows, gidx, group), row_aux.view(g, group)[gidx], q32, metric, d
    )
    cs = cs.masked_fill_(torch.isnan(cs), NEG_INF)
    if recency is not None:
        cs = cs + recency.view(g, group)[gidx]
    if row_mask is not None:
        cs = cs.masked_fill(~row_mask.view(g, group)[gidx], NEG_INF)
    return finish_candidates(cs, gidx, b, k, group)


def _use_gmax(queries, vectors, k: int, *, small_on_card: bool = True) -> bool:
    """Route bf16 scans through the stage-1 kernels.

    The JAX route's conditions, without its CPU bail-out and its TPU block
    rules. On a CPU tensor the kernel wrappers run their plain versions and
    the JAX package's batch floor (``pallas_gmax_f_min_batch``) holds; on
    the card a batch of any height goes, if :func:`gmax.supported` accepts
    it, unless ``small_on_card`` is False (the floor then holds there too)."""
    from hyperdb_tpu_torch.ops import gmax as _gmax  # gmax imports this module

    min_b = CONFIG.pallas_gmax_f_min_batch
    if not CONFIG.pallas_gmax or min_b <= 0:
        return False
    if queries.shape[0] < min_b and not (small_on_card and queries.device.type == "cuda"):
        return False
    return _gmax.supported(queries, vectors, k)


def _use_l1(queries, vectors, k: int) -> bool:
    """Route batched manhattan scans through the L1 stage-1 kernels: the JAX
    route's conditions (``_use_pallas_l1``) without its CPU bail-out, and
    with the CUDA kernel's shape rule (``l1.supported``) in place of the TPU
    block rules. An f16 query wire is upcast and takes the kernel too."""
    from hyperdb_tpu_torch.ops import l1 as _l1  # l1 imports this module

    min_b = CONFIG.pallas_l1_min_batch
    if min_b <= 0 or queries.shape[0] < min_b:
        return False
    return _l1.supported(queries, vectors) and vectors.shape[0] // _l1.GROUP >= k


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
        # never build the (B, N) score matrix: batches take the L1 stage-1
        # kernels, recency (which the -L1 surrogate cannot carry) and small
        # batches the streamed scan
        if recency is None and _use_l1(queries, vectors, k):
            from hyperdb_tpu_torch.ops.l1 import rank_top_k_manhattan_l1

            return rank_top_k_manhattan_l1(queries, vectors, k, row_mask=row_mask)
        tile = _manhattan_tile(int(queries.shape[0]), n, k)
        if tile:
            return rank_top_k_manhattan_stream(
                queries, vectors, k, row_mask=row_mask, recency=recency, tile=tile
            )
    if metric == "cosine_similarity" and prenormalized:
        s = _metrics.cosine_scores_prenormalized(queries, vectors)
    else:
        s = scores(queries, vectors, metric)
    s = _scrub(s, row_mask, recency)
    if use_grouped:
        return exact_top_k_grouped(s, k, group=group)
    return exact_top_k(s, k)


def _merge_plane_topk(vals_parts, idx_parts, k: int, offsets):
    """Merge per-plane (B, k_i) winners into the global (B, k) top-k.

    ``offsets[i]`` is the global row id of plane i's row 0. The planes
    concatenate in plane order and :func:`exact_top_k` prefers the lower
    position, so on equal values the earlier plane's entry wins: the LOWER
    global id, which one top-k over the whole corpus would pick."""
    with _trace.span("route.merge", vals_parts[0]):
        vals = torch.cat(vals_parts, dim=1)
        idxs = torch.cat([p + off for p, off in zip(idx_parts, offsets)], dim=1)
        mv, mi = exact_top_k(vals, k)
        return mv, torch.gather(idxs, 1, mi)


def rank_top_k_planar(
    queries,
    planes,
    k: int,
    metric: str = "cosine_similarity",
    row_masks=None,
    recencies=None,
    prenormalized: bool = False,
):
    """Exact top-k over a corpus stored as SEPARATE device planes
    (``ranking.rank_top_k_planar`` in the JAX package): each (N_i, d) plane
    is ranked by :func:`rank_top_k` (so by its kernel routes), and the
    per-plane winners merge through one (B, sum k_i) top-k.

    Every metric scores a row independently of the rest of the corpus, so
    the global top-k lies in the union of the per-plane top-k and the merge
    is exact; ties go to the lowest global id (:func:`_merge_plane_topk`).
    The planes are ranked back to back on one stream, with no read-back in
    between: the caching allocator hands a plane's freed temporaries to the
    next plane in stream order.

    Args mirror :func:`rank_top_k`: ``planes`` is a sequence of (N_i, d)
    tensors; ``row_masks`` / ``recencies`` are optional sequences aligned
    with it. Returns (values, indices), indices global over the plane
    concatenation.
    """
    planes = list(planes)
    if not planes:
        raise ValueError("rank_top_k_planar: need at least one plane")
    if len(planes) == 1:
        return rank_top_k(
            queries, planes[0], k=min(k, int(planes[0].shape[0])), metric=metric,
            row_mask=None if row_masks is None else row_masks[0],
            recency=None if recencies is None else recencies[0],
            prenormalized=prenormalized,
        )
    vals_parts, idx_parts, offsets = [], [], []
    offset = 0
    for i, plane in enumerate(planes):
        v, idx = rank_top_k(
            queries, plane, k=min(k, int(plane.shape[0])), metric=metric,
            row_mask=None if row_masks is None else row_masks[i],
            recency=None if recencies is None else recencies[i],
            prenormalized=prenormalized,
        )
        vals_parts.append(v)
        idx_parts.append(idx)
        offsets.append(offset)
        offset += int(plane.shape[0])
    k_eff = min(k, sum(int(p.shape[1]) for p in idx_parts))
    return _merge_plane_topk(vals_parts, idx_parts, k_eff, offsets)


def rank_docs_top_k(
    queries,
    rows,
    row_docs,
    row_valid,
    k: int,
    num_docs: int,
    metric: str = "cosine_similarity",
    doc_mask=None,
    recency=None,
    prenormalized: bool = False,
):
    """Chunk-aware ranking: score rows, reduce to documents, take the top-k
    documents (``ranking.rank_docs_top_k`` in the JAX package).

    The corpus has one row per chunk but results are per document: a
    document's score is its best chunk's. Row scores are scrubbed (NaN ->
    -inf), rows that are padding or belong to a masked document become
    -inf, and a segment max over ``row_docs`` reduces them (documents
    without a live row stay -inf); recency and the document mask then apply
    at document level. The (c, N_pad) row scores are materialised, for
    every metric, a chunk of queries at a time.

    Args:
        queries: (B, d) query block.
        rows: (N_pad, d) padded corpus rows.
        row_docs: (N_pad,) integer chunk-row -> document index.
        row_valid: (N_pad,) bool, False on capacity padding.
        k: top-k (<= num_docs).
        num_docs: padded document count (segment count).
        doc_mask: optional (num_docs,) bool document filter mask.
        recency: optional (num_docs,) f32 recency term.
        prenormalized: rows are unit-norm (cosine fast path).

    Returns:
        (values, doc_indices): (B, k) f32 and (B, k) int64.
    """
    b = queries.shape[0]
    n = rows.shape[0]
    seg = row_docs.long()
    valid = row_valid if doc_mask is None else row_valid & doc_mask[seg]
    chunk = max(1, _CHUNK_CELLS // max(n, num_docs))
    vals, idx = [], []
    for a in range(0, b, chunk):
        qc = queries[a : a + chunk]
        if metric == "cosine_similarity" and prenormalized:
            s = _metrics.cosine_scores_prenormalized(qc, rows)
        else:
            s = scores(qc, rows, metric)
        s = s.float()
        s = s.masked_fill(torch.isnan(s), NEG_INF).masked_fill(~valid[None, :], NEG_INF)
        doc_s = torch.full(
            (s.shape[0], num_docs), NEG_INF, dtype=torch.float32, device=s.device
        )
        doc_s.scatter_reduce_(1, seg[None, :].expand_as(s), s, "amax", include_self=True)
        if recency is not None:
            doc_s = doc_s + recency[None, :]
        if doc_mask is not None:
            doc_s = doc_s.masked_fill(~doc_mask[None, :], NEG_INF)
        v, i = exact_top_k(doc_s, k)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def rank_gathered(
    queries, rows, cand_ids, cand_valid, k: int, metric: str = "cosine_similarity",
    recency=None, prenormalized: bool = False,
):
    """Score only the candidate rows ``cand_ids`` and take the top-k
    (``ranking.rank_gathered`` in the JAX package): the IVF fast path.

    ``cand_ids`` is a padded (C,) vector of global row ids with
    ``cand_valid`` marking live entries: (C,) for one shared candidate set,
    or (B, C) for the batched IVF shape (one union of probed clusters, each
    query restricted to the clusters it probed). Scores: the query metric
    (cosine over the prenormalized plane), NaN -> -inf, then + recency (a
    (C,) vector aligned with ``cand_ids``), then invalid entries -> -inf;
    ties go to the lower position. Queries go a chunk at a time, so the
    (B, C) scores are never all materialised. Returns (values (B, k) f32,
    global row ids (B, k) int64)."""
    sub = rows[cand_ids]
    chunk = max(1, _CHUNK_CELLS // max(1, sub.shape[0]))
    vals, idx = [], []
    for a in range(0, queries.shape[0], chunk):
        qc = queries[a : a + chunk]
        if metric == "cosine_similarity" and prenormalized:
            s = _metrics.cosine_scores_prenormalized(qc, sub)
        else:
            s = scores(qc, sub, metric)
        s = s.float().masked_fill(torch.isnan(s), NEG_INF)
        if recency is not None:
            s = s + recency[None, :]
        valid = cand_valid[a : a + chunk] if cand_valid.ndim == 2 else cand_valid[None, :]
        v, pos = exact_top_k(s.masked_fill(~valid, NEG_INF), k)
        vals.append(v)
        idx.append(cand_ids[pos].long())
    return torch.cat(vals), torch.cat(idx)


def recency_scores(timestamps, recency_bias: float):
    """``recency_bias * exp(t - max(t))`` as a float32 NumPy vector
    (ranking_algorithm.py:183, Q17)."""
    t = np.asarray(timestamps, dtype=np.float64)
    if t.size == 0:
        return np.zeros(0, dtype=np.float32)
    return (recency_bias * np.exp(t - t.max())).astype(np.float32)


def ranking_algorithm_sort(
    vectors,
    query_vector,
    top_k: int = 5,
    metric: str = "cosine_similarity",
    timestamps=None,
    recency_bias: float = 0,
    device=None,
):
    """The reference's ``hyperDB_ranking_algorithm_sort``
    (ranking_algorithm.py:149-204): NaN input or an unknown metric raises, a
    single row prints ``Info: Only one document left.`` and returns a (1, 1)
    score; otherwise the top-k row ids and scores of one query, computed by
    :func:`rank_top_k` on ``device`` (the card unless the caller asks for
    the CPU)."""
    from hyperdb_tpu_torch.core.db import resolve_device

    vectors = np.asarray(vectors)
    query = np.asarray(query_vector)
    if np.isnan(vectors).any() or np.isnan(query).any():
        raise ValueError("Vectors and query_vector should not contain NaN values.")
    if metric not in _metrics.METRICS:
        raise ValueError(f"Unknown metric: {metric}")
    if vectors.ndim != 2:
        raise ValueError("Vectors should be a 2D array of shape (N, d).")
    dev = resolve_device(device)
    q = query.reshape(1, -1) if query.ndim == 1 else query[:1]
    recency = None
    if timestamps is not None and len(timestamps) > 0:
        r = recency_scores(np.asarray(timestamps), recency_bias)
        if r.shape[0] != vectors.shape[0]:
            raise ValueError("timestamps must have one entry per vector row.")
        recency = torch.from_numpy(r).to(dev)
    qt = torch.from_numpy(np.asarray(q, dtype=np.float32)).to(dev)
    vt = torch.from_numpy(np.asarray(vectors, dtype=np.float32)).to(dev)
    n = vectors.shape[0]
    if n == 1:
        vals, _ = rank_top_k(qt, vt, k=1, metric=metric, recency=recency)
        print("Info: Only one document left.")
        return np.array([0]), np.array([vals[0].cpu().numpy()])
    k = max(0, min(int(top_k), n))
    if k == 0:
        return [], []
    vals, idx = rank_top_k(qt, vt, k=k, metric=metric, recency=recency)
    return idx[0].cpu().numpy(), vals[0].cpu().numpy()
