"""Drive the PyTorch/CUDA port (``hyperdb_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one or a few lines each on standard output:

1. environment: the card's name and power limit (``nvidia-smi``), the torch
   and nvcc versions, and the time the kernels took to build. The stage-1
   scans exist in two variants (``wgmma`` fed by TMA, which the shape rule
   ``gmax.kernel_variant`` picks at these shapes, and ``mma.sync``): every
   launch through ``HyperDB`` must have run the first
   (``gmax.LAUNCHES_BY_VARIANT``), and each of the four kernels is also timed
   through the second in the same run (``ms_before``);
2. the float kernels (``gmax_f_sub`` single and dual, ``gmax_f``) against
   their plain PyTorch versions at the main path's shapes: a 2^20-row,
   d = 384 bf16 plane, b = 512, with masked rows, recency, a NaN row, a
   NaN group and duplicated rows. Tolerance 1e-5 absolute on unit-norm operands (the
   kernel and the plain f32 matmul sum the same exact bf16 products in
   different orders); -inf positions must match exactly, and the two
   variants must agree within the same tolerance. Each is timed (median of
   CUDA-event times after warm-up) beside its bound, the ``mma.sync``
   variant and the time of ``torch.mm`` with f32 output plus ``amax`` over
   the same product; the b = 16384 line times both variants too;
3. the main path: ``HyperDB(documents, 1M x 384 f16 vectors,
   fp_precision="float16")`` on the card, ``query_batch_arrays`` with
   cosine, top_k = 10 at b = 512 and b = 16384; every launch counter is set
   to 0 just before and read just after, and the ids are held tie-aware
   against an exact reference (chunked f32 matmul over the same bf16 plane
   plus a stable sort);
4. the same at b = 512 with ``CONFIG.pallas_subgroup = 0``, which routes
   stage 1 through ``gmax_f``;
   each batch is timed on the host clock and split into the device time
   of its stages;
5. ``query`` (b = 1) and ``query_batch`` at b = 64 on the plain grouped
   route, with the same check;
6. path B, the grouped metrics on the same DB at b = 512: euclidean,
   hamming and pearson must launch ``gmax_f_sub`` and jaccard
   ``gmax_jaccard``; ids tie-aware equal to a plain reference over the same
   planes with the same score formula. With recency the three epilogue
   metrics must launch nothing (the plain grouped form); pearson is a dot
   scan, whose kernel takes recency. ``gmax_jaccard`` is held EQUAL to its
   plain version on the store's 0/1 plane (masked group, masked rows, empty
   rows, an empty query) and timed like the float kernels;
7. path A, int8 planes: ``device_precision="int8-pure"`` at b = 1024 and
   b = 4096 (``gmax_int8`` launched once per batch; ids tie-aware equal to
   a plain reference over the same int8 planes) and at b = 64 (the plain
   grouped form, no launch); ``"int8"`` at b = 1024 (ids identical to the
   same route with the plain stage 1; recall@10 against the exact bf16
   reference at least 0.99). ``gmax_int8`` is held EQUAL to its plain
   version at b = 1024 on the store's plane (masked group, masked rows,
   recency, zero-scale rows) and timed beside ``torch._int_mm`` + rescale +
   ``amax``.
8. the manhattan kernels (``gmax_l1``, ``gmax_l1t``) against their plain
   versions on the store's raw 2^20 x 384 bf16 plane at b = 64 and b = 512,
   with masked rows, a masked group, a NaN corpus element and a NaN query.
   Their d-sum order differs from torch's ``sum(-1)``, so they are held to
   rtol 1e-5 plus atol 1e-4 on distances of magnitude ~430 (and to the same
   rtol on the ~1e30 entries of the NaN query in ``gmax_l1t``); +-inf
   positions must match exactly. Each is timed beside its bound (two FP32
   operations per element on the CUDA cores), its plain version (timed
   once: it takes seconds) and ``torch.cdist(p=1)`` + mask + group max;
9. path C, manhattan through ``query_batch_arrays``: b = 64 and b = 512,
   each with ``CONFIG.pallas_l1t`` = 1 (``gmax_l1t`` over a transposed
   copy) and = 0 (``gmax_l1`` in place); b = 64 with recency and b = 8 (the
   streamed scan, no launch). Ids tie-aware equal to an exact f32 reference
   over the same bf16 plane, scores within 1e-8 (scores are ~2e-3; the
   kernel route's and the reference's f32 distance sums differ by ~1e-4 in
   ~430); and the kernel route's ids and scores against the streamed
   route's on the same queries (``pallas_l1_min_batch`` = 0);
10. path D, chunked: the same rows as 250000 documents of 4 rows each
   (``HyperDB.from_state``; padded to 262144 documents over the 2^20-row
   plane), cosine and manhattan at b = 64, with and
   without a metadata filter; document ids tie-aware equal to a reference
   that scores every row and takes each document's best.

Then a JSON line describing every kernel, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero and prints no last line. It needs one CUDA device and refuses to run
without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_DOCS = 1_000_000
DIM = 384
TOP_K = 10
SUB = 32
ATOL = 1e-5  # unit-norm bf16 operands, f32 sums in different orders
# Tolerances of the tie-aware id checks of paths A and B. Hamming, jaccard
# and int8 scores are exact integer counts through the same IEEE operations
# in the route and in the reference (0 expected); euclidean scores (~0.035)
# carry the f32 sum order of q.v through d^2 ~ 768, under 1e-8.
METRIC_ATOL = {
    "euclidean_metric": 1e-7,
    "hamming_distance": 1e-7,
    "jaccard_similarity": 1e-7,
    "pearson_correlation": ATOL,
}
INT8_ATOL = 1e-7
RECENCY_BIAS = 0.05
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# H100 SXM FP32 outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as two, so the CUDA cores run half that many lane-operations
PEAK_FP32_OPS = 67e12 / 2
GMAX_SOURCE = "hyperdb_tpu_torch/csrc/gmax_wgmma.cu"
L1_SOURCE = "hyperdb_tpu_torch/csrc/l1.cu"
L1_RTOL, L1_ATOL = 1e-5, 1e-4  # group maxes of -L1: another d-sum order than torch's
MANHATTAN_ATOL = 1e-8  # scores 1/(1 + L1) ~ 2e-3 from distances equal within ~1e-4 in ~430
ROWS_PER_DOC = 4  # path D
NEG_INF = float("-inf")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def nvcc_version() -> str:
    from hyperdb_tpu_torch.ops import cuda_build

    out = subprocess.run(
        [cuda_build._nvcc(), "--version"], check=True, capture_output=True, text=True
    ).stdout.strip()
    return out.splitlines()[-1]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Median host time of ``fn()``, which ends in a device-to-host read."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def scan_bound_ms(b: int, n: int, d: int, out_cols: int, kind: str = "bf16"):
    """Least time for one stage-1 scan: the larger of its operations over
    the tensor-core peak of its operand type and its bytes (every input read
    once, the maxes written once) over the memory rate. ``kind`` is "bf16"
    (q, v, extra), "int8" (one-byte q and v, plus q_scale, v_scales, extra)
    or "jaccard" (bf16 q and v, plus q_sum, aux, extra)."""
    flops = 2.0 * b * n * d
    width = 1.0 if kind == "int8" else 2.0
    nbytes = width * (b * d + n * d) + 4.0 * n + 4.0 * b * out_cols
    if kind != "bf16":
        nbytes += 4.0 * (b + n)
    peak = PEAK_INT8_OPS if kind == "int8" else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def l1_bound_ms(b: int, n: int, d: int, corpus_bytes: int = 2):
    """Least time for one stage-1 manhattan scan: two FP32 operations per
    (query, row, depth) element (subtract; add with the |x| modifier) over
    the CUDA cores' operation rate, or its bytes (f32 queries, the corpus,
    extra, the (b, n/128) output) over the memory rate."""
    t_ops = 2.0 * b * n * d / PEAK_FP32_OPS * 1e3
    nbytes = 4.0 * b * d + corpus_bytes * n * d + 4.0 * n + 4.0 * b * (n // 128)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def l1_err(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold an L1 kernel's output to its plain version's: no NaN, +-inf in
    the same places, the rest within ``L1_RTOL`` / ``L1_ATOL``. Returns the
    max abs difference over the entries below 1e29 (a NaN query's entries in
    ``gmax_l1t`` sit at ~1e30 and are held to the relative tolerance only)."""
    if got.shape != want.shape or torch.isnan(got).any():
        raise AssertionError(f"{name}: wrong shape or NaN in the kernel's output")
    inf = torch.isinf(want)
    if not torch.equal(torch.where(inf, want, torch.zeros_like(want)),
                       torch.where(torch.isinf(got), got, torch.zeros_like(got))):
        raise AssertionError(f"{name}: infinite entries differ between kernel and plain version")
    fin = ~inf
    g, w = got[fin], want[fin]
    bad = (g - w).abs() > L1_ATOL + L1_RTOL * w.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries off the plain version beyond rtol {L1_RTOL} "
            f"atol {L1_ATOL} (max abs {float((g - w).abs()[bad].max()):.3g})"
        )
    small = w.abs() < 1e29
    return float((g[small] - w[small]).abs().max())


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference on finite entries; -inf positions must agree."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    ninf = torch.isneginf(want)
    if not torch.equal(torch.isneginf(got), ninf):
        raise AssertionError("-inf positions differ between kernel and plain version")
    fin = ~ninf
    if not torch.isfinite(got[fin]).all():
        raise AssertionError("kernel produced non-finite values")
    return float((got[fin] - want[fin]).abs().max())


def kernel_entry(name, replaces, err, kern, plain, lib, bound, reps=20,
                 source=GMAX_SOURCE, slow=False, before=None):
    """Time one kernel beside its plain version and its library call, and
    make its entry of the ``kernels`` line. ``lib`` may be None. ``slow``
    times the plain version and the library call once each, with no
    warm-up (they take seconds). ``before`` is the same scan through the
    ``mma.sync`` variant: its time is the entry's ``ms_before``."""
    ms = cuda_ms(kern, reps=reps)
    ms_before = None if before is None else cuda_ms(before, reps=reps)
    side_reps, side_warmup = (1, 0) if slow else (5, 1)
    plain_ms = cuda_ms(plain, reps=side_reps, warmup=side_warmup)
    lib_ms = None if lib is None else cuda_ms(lib, reps=side_reps, warmup=side_warmup)
    bound_ms, bound_by = bound
    lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f}"
    before_txt = "" if ms_before is None else f" ms_before={ms_before:.4f} (mma.sync variant)"
    log(
        f"kernel {name}: max_abs_err={err:.3g} ms={ms:.4f}{before_txt} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_txt} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"bound/ms={bound_ms / ms:.3f}"
    )
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
    }
    if ms_before is not None:
        entry["ms_before"] = ms_before
    return entry


def scan_before(kind, q, v, extra, sub=0, group=True, qaux=None, vaux=None):
    """One stage-1 scan through the ``mma.sync`` variant, whatever the shape
    rule picks: the kernel of before the redesign, timed beside the new one."""
    from hyperdb_tpu_torch.ops import gmax as G

    b, n = q.shape[0], v.shape[0]
    sm = torch.empty((b, n // sub), dtype=torch.float32, device=q.device) if sub else None
    gm = torch.empty((b, n // G.GROUP), dtype=torch.float32, device=q.device) if group else None
    G._launch(kind, q, v, extra, sm, gm, sub, qaux=qaux, vaux=vaux, _variant="mma")
    return gm, sm


def both_variants_line(name, b, ms, ms_before, bound, bound_by, card):
    log(
        f"kernel {name}: b={b} ms={ms:.4f} ms_before={ms_before:.4f} (mma.sync variant) "
        f"bound_ms={bound:.4f} ({bound_by}) bound/ms={bound / ms:.3f} "
        f"bound/ms_before={bound / ms_before:.3f} [{card}]"
    )


# ---------------------------------------------------------------- data


def make_corpus(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((N_DOCS, DIM), dtype=np.float32).astype(np.float16)
    v[17] = v[4]  # exact duplicate rows: the lower id must win the tie
    return v


def make_documents() -> list:
    """One small dict per document with a timestamp in [0, 1) for the
    recency queries."""
    return [{"ts": (i % 1000) / 1000.0} for i in range(N_DOCS)]


def make_queries(seed: int, b: int, corpus: np.ndarray, plant: bool = True) -> np.ndarray:
    q = np.random.default_rng(seed).standard_normal((b, DIM), dtype=np.float32)
    if plant:
        q[0] = corpus[4].astype(np.float32)
    return q


def recency_vector(n_pad: int) -> torch.Tensor:
    """The engine's recency term for ``make_documents`` (all documents
    surviving): bias * exp(t - max t), f32, zero on padding rows."""
    t = (np.arange(N_DOCS) % 1000) / 1000.0
    rec = np.zeros(n_pad, dtype=np.float32)
    rec[:N_DOCS] = (RECENCY_BIAS * np.exp(t - t.max())).astype(np.float32)
    return torch.from_numpy(rec).cuda()


# ---------------------------------------------------------------- references


class Reference:
    """Exact top-k of ``f(qq . rows, aux, qconst)`` (+ recency) over one
    plane, by a chunked f32 matmul over the upcast plane and a stable
    descending sort (ties to the lower id); padding rows are -inf.

    ``qq`` is the (B, d) operand block exactly as the route multiplies it
    (already rounded to the plane's dtype, or int8); ``f(inter, aux,
    qconst)`` is the route's score formula with ``aux`` broadcast over rows
    and ``qconst`` a (B, 1) per-query column."""

    def __init__(self, qq, rows, n, k, f=None, aux=None, qconst=None, rec=None):
        self.qq = qq.float()
        self.rows, self.n, self.f, self.aux, self.rec = rows, n, f, aux, rec
        self.qconst = qconst
        rows32 = rows.float()
        vals, ids = [], []
        for a in range(0, self.qq.shape[0], 64):
            qc = None if qconst is None else qconst[a : a + 64]
            s = self._score(self.qq[a : a + 64] @ rows32.T, None if aux is None else aux[None, :], qc)
            if rec is not None:
                s = s + rec[None, :]
            s[:, n:] = NEG_INF
            sv, si = torch.sort(s, dim=-1, descending=True, stable=True)
            vals.append(sv[:, :k])
            ids.append(si[:, :k])
        self.vals, self.ids = torch.cat(vals), torch.cat(ids)

    def _score(self, inter, aux, qconst):
        s = inter if self.f is None else self.f(inter, aux, qconst)
        return s.masked_fill(torch.isnan(s), NEG_INF)

    def exact(self, ids: torch.Tensor, queries=None) -> torch.Tensor:
        """Exact scores of rows ``ids`` (B, k) — or (m,) rows for the
        queries listed in ``queries`` (m,)."""
        qq = self.qq if queries is None else self.qq[queries]
        qc = self.qconst
        if qc is not None and queries is not None:
            qc = qc[queries]
        rows = self.rows[ids].float()
        if ids.ndim == 2:
            inter = torch.einsum("bd,bkd->bk", qq, rows)
        else:
            inter = (qq * rows).sum(-1)
            qc = None if qc is None else qc[:, 0]
        s = self._score(inter, None if self.aux is None else self.aux[ids], qc)
        return s if self.rec is None else s + self.rec[ids]


def check_top_k(name, got_ids, got_vals, ref: Reference, atol: float):
    """Tie-aware: at every rank, the returned id's exact score and the
    returned score lie within ``atol`` of the reference's score at that
    rank; where an id differs from the reference's, the two rows' scores lie
    within ``atol`` of each other; no query returns an id twice."""
    gi = torch.from_numpy(np.ascontiguousarray(got_ids)).cuda()
    gv = torch.from_numpy(np.ascontiguousarray(got_vals)).cuda()
    if gi.shape != ref.ids.shape or int(gi.max()) >= ref.n or int(gi.min()) < 0:
        raise AssertionError(f"{name}: ids out of range or of the wrong shape")
    if not torch.isfinite(gv).all():
        raise AssertionError(f"{name}: non-finite scores")
    exact = ref.exact(gi)
    err_exact = float((exact - ref.vals).abs().max())
    err_score = float((gv - ref.vals).abs().max())
    swapped = gi != ref.ids
    swaps = int(swapped.sum())
    if err_exact > atol or err_score > atol:
        raise AssertionError(
            f"{name}: scores off the reference (ids {err_exact:.3g}, scores "
            f"{err_score:.3g} > {atol})"
        )
    if swaps:
        ref_exact = ref.exact(ref.ids[swapped], queries=swapped.nonzero()[:, 0])
        err_swap = float((exact[swapped] - ref_exact).abs().max())
        if err_swap > atol:
            raise AssertionError(
                f"{name}: an id differs from the reference's at a score gap "
                f"of {err_swap:.3g} > {atol}"
            )
    uniq = torch.sort(gi, dim=1).values
    if (uniq[:, 1:] == uniq[:, :-1]).any():
        raise AssertionError(f"{name}: a query returned the same id twice")
    return swaps, err_score


def cosine_reference(plane: torch.Tensor, n: int, q: np.ndarray, k: int) -> Reference:
    """Exact cosine top-k over the bf16 plane: the query normalized in f32
    and rounded to bf16, as the route multiplies it."""
    qt = torch.from_numpy(q).cuda()
    norm = torch.sqrt((qt * qt).sum(-1, keepdim=True))
    qn = (qt / torch.where(norm == 0, torch.ones_like(norm), norm)).bfloat16()
    return Reference(qn, plane, n, k)


def check_ids(name, got_ids, got_vals, plane, n, q, k):
    return check_top_k(name, got_ids, got_vals, cosine_reference(plane, n, q, k), ATOL)


def metric_reference(db, metric: str, q: np.ndarray, k: int, rec=None) -> Reference:
    """The plain reference of one grouped metric: the same plane, the same
    operand rounding and the same score formula as the route."""
    store = db._store
    dv = store.device_view(db.source_indices)
    q32 = torch.from_numpy(q).cuda()
    if metric == "pearson_correlation":
        from hyperdb_tpu_torch.ops.metrics import pearson_center_normalize

        plane = store.pearson_view(db.source_indices)["rows_pearson"]
        qq = torch.from_numpy(pearson_center_normalize(q.astype(np.float32))).cuda()
        return Reference(qq.to(plane.dtype), plane, N_DOCS, k, rec=rec)
    if metric == "euclidean_metric":
        rows, aux = dv["rows"], dv["row_sq"]
        qconst = (q32 * q32).sum(-1, keepdim=True)

        def f(inter, a, qsq):
            return 1.0 / (1.0 + torch.sqrt(torch.clamp(a - 2.0 * inter + qsq, min=0.0)))
    else:
        bv = store.binary_view(db.source_indices)
        rows, aux = bv["rows_bin"], bv["row_bin_sum"]
        q32 = (q32 > 0).float()
        qconst = q32.sum(-1, keepdim=True)
        if metric == "hamming_distance":
            def f(inter, a, qsum):
                return float(DIM) - (a + qsum - 2.0 * inter)
        else:
            def f(inter, a, qsum):
                return inter / (a + qsum - inter)
    return Reference(q32.to(rows.dtype), rows, N_DOCS, k, f=f, aux=aux, qconst=qconst, rec=rec)


def quantize_queries(q: np.ndarray):
    """The int8 cosine route's query block, in NumPy on the host: normalized
    in f32 as the engine does, quantized per row with IEEE division and
    round half to even."""
    qn = np.linalg.norm(q, axis=1, keepdims=True)
    qn[qn == 0] = 1.0
    x = (q / qn).astype(np.float32)
    scales = (np.max(np.abs(x), axis=1) / np.float32(127.0)).astype(np.float32)
    safe = np.where(scales == 0, np.float32(1.0), scales)
    q_i8 = np.clip(np.rint(x / safe[:, None]), -127, 127).astype(np.int8)
    return torch.from_numpy(q_i8).cuda(), torch.from_numpy(scales).cuda()


def int8_reference(dv, q: np.ndarray, k: int) -> Reference:
    """Exact top-k of the rescaled int8 scores over the store's unit-norm
    int8 plane (the plain ``int8_scores`` formula, chunked)."""
    q_i8, q_scale = quantize_queries(q)
    return Reference(
        q_i8, dv["rowsn_q"], N_DOCS, k, f=lambda inter, a, qs: inter * (qs * a),
        aux=dv["rown_scales"], qconst=q_scale[:, None],
    )


class DocReference:
    """Exact top-k DOCUMENTS by a full scan in f32, independent of the
    routes: every row of the plane is scored, a document's score is the
    best of its ``per_doc`` consecutive rows (1: rows are documents), then
    recency and the document mask, then a stable descending sort (ties to
    the lower id). It has :class:`Reference`'s interface for
    :func:`check_top_k`.

    ``metric`` is "manhattan" (``1/(1 + sum|v - q|)`` against the f32
    queries) or "cosine" (the dot with the query normalized in f32 and
    rounded to the plane's dtype, as the route multiplies it)."""

    def __init__(self, metric, q, rows, n_docs, k, per_doc=1, doc_mask=None, rec=None):
        self.metric, self.rows, self.n, self.per_doc, self.rec = metric, rows, n_docs, per_doc, rec
        qt = torch.from_numpy(np.asarray(q, dtype=np.float32)).cuda()
        if metric == "cosine":
            norm = torch.sqrt((qt * qt).sum(-1, keepdim=True))
            qt = (qt / torch.where(norm == 0, torch.ones_like(norm), norm)).to(rows.dtype).float()
        self.q = qt
        n_rows = n_docs * per_doc
        vals, ids = [], []
        for a in range(0, qt.shape[0], 64):
            qc = qt[a : a + 64]
            if metric == "cosine":
                s = qc @ rows[:n_rows].float().T
            else:
                s = torch.cat(
                    [self._pairs(qc[:, None, :], rows[r : r + 8192].float()[None])
                     for r in range(0, n_rows, 8192)], dim=1,
                )[:, :n_rows]
            s = s.masked_fill(torch.isnan(s), NEG_INF)
            s = s.view(s.shape[0], n_docs, per_doc).amax(-1)
            if rec is not None:
                s = s + rec[None, :n_docs]
            if doc_mask is not None:
                s = s.masked_fill(~doc_mask[None, :], NEG_INF)
            sv, si = torch.sort(s, dim=-1, descending=True, stable=True)
            vals.append(sv[:, :k])
            ids.append(si[:, :k])
        self.vals, self.ids = torch.cat(vals), torch.cat(ids)

    def _pairs(self, q, r):
        """Scores of broadcastable (.., d) queries and rows -> (..)."""
        if self.metric == "cosine":
            return (r * q).sum(-1)
        return 1.0 / (1.0 + (r - q).abs().sum(-1))

    def exact(self, ids: torch.Tensor, queries=None) -> torch.Tensor:
        qq = self.q if queries is None else self.q[queries]
        rows_of = ids[..., None] * self.per_doc + torch.arange(self.per_doc, device=ids.device)
        r = self.rows[rows_of].float()  # (.., per_doc, d)
        q = qq.view(qq.shape[0], *([1] * (r.ndim - 2)), qq.shape[1])
        s = self._pairs(q, r)
        s = s.masked_fill(torch.isnan(s), NEG_INF).amax(-1)
        return s if self.rec is None else s + self.rec[ids]


# ---------------------------------------------------------------- phases


def phase_kernels(plane: torch.Tensor, n: int, seed: int, card: str):
    """The float kernels against their plain versions at the main path's shapes."""
    from hyperdb_tpu_torch.ops import gmax as G

    n_pad = plane.shape[0]
    rng = np.random.default_rng(seed + 1)
    v = plane.clone()
    v[5] = v[3]  # tie inside one subgroup
    v[300] = v[40]  # tie across groups
    v[777] = float("nan")  # NaN row -> -inf scores
    v[512:640] = float("nan")  # a whole NaN group: only the scrub makes its maxes -inf
    mask = torch.from_numpy(rng.random(n_pad) < 0.9).cuda()
    mask[n:] = False
    mask[128:256] = False  # one whole group masked
    rec = torch.from_numpy((rng.random(n_pad) * 0.05).astype(np.float32)).cuda()
    extra = G.make_extra(n_pad, mask, rec, device="cuda")
    q = torch.from_numpy(rng.standard_normal((512, DIM), dtype=np.float32)).cuda()
    q = (q / q.norm(dim=1, keepdim=True)).bfloat16()
    b = q.shape[0]

    gm, sm = G.gmax_f_sub(q, v, extra, sub=SUB, dual=False)
    gm_d, sm_d = G.gmax_f_sub(q, v, extra, sub=SUB, dual=True)
    gm_f = G.gmax_f(q, v, extra)
    torch.cuda.synchronize()
    want_gm, want_sm = G.gmax_f_sub_plain(q, v, extra, sub=SUB)
    err_sub = max(max_err(sm, want_sm), max_err(gm, want_gm))
    err_dual = max(max_err(sm_d, want_sm), max_err(gm_d, want_gm))
    err_f = max_err(gm_f, G.gmax_f_plain(q, v, extra))
    if not torch.equal(gm_d, gm):
        raise AssertionError("dual-form group maxes differ from the single form's")
    for name, err in (("gmax_f_sub", err_sub), ("gmax_f_sub dual", err_dual), ("gmax_f", err_f)):
        if err > ATOL:
            raise AssertionError(f"{name}: max abs err {err:.3g} > {ATOL}")
    old_gm, old_sm = scan_before(G._KIND_F, q, v, extra, sub=SUB)
    torch.cuda.synchronize()
    err_old = max(max_err(old_sm, sm), max_err(old_gm, gm))
    if err_old > ATOL:
        raise AssertionError(f"gmax_f_sub: the two variants differ by {err_old:.3g} > {ATOL}")
    log(f"gmax_f_sub: wgmma variant against mma.sync variant: max abs diff {err_old:.3g}")
    del gm_d, sm_d, want_sm, want_gm, old_gm, old_sm

    def library(width):
        s = torch.mm(q, v.T, out_dtype=torch.float32)
        return s.view(b, n_pad // width, width).amax(-1)

    log(f"float kernels at b={b} n={n_pad} d={DIM} (tol {ATOL}):")
    results = {
        "gmax_f_sub": kernel_entry(
            "gmax_f_sub", "hyperdb_tpu/ops/pallas_gmax.py:265", err_sub,
            lambda: G.gmax_f_sub(q, v, extra, sub=SUB, dual=False),
            lambda: G.gmax_f_sub_plain(q, v, extra, sub=SUB),
            lambda: library(SUB), scan_bound_ms(b, n_pad, DIM, n_pad // SUB),
            before=lambda: scan_before(G._KIND_F, q, v, extra, sub=SUB, group=False),
        ),
        "gmax_f": kernel_entry(
            "gmax_f", "hyperdb_tpu/ops/pallas_gmax.py:217", err_f,
            lambda: G.gmax_f(q, v, extra), lambda: G.gmax_f_plain(q, v, extra),
            lambda: library(G.GROUP), scan_bound_ms(b, n_pad, DIM, n_pad // G.GROUP),
            before=lambda: scan_before(G._KIND_F, q, v, extra),
        ),
    }
    dual_ms = cuda_ms(lambda: G.gmax_f_sub(q, v, extra, sub=SUB, dual=True), reps=20)
    log(f"kernel gmax_f_sub dual: max_abs_err={err_dual:.3g} ms={dual_ms:.4f}")

    # the main path's large batch: kernel time beside its bound
    qb = q.repeat(32, 1)
    ms_big = cuda_ms(lambda: G.gmax_f_sub(qb, v, extra, sub=SUB, dual=False), reps=5)
    ms_old = cuda_ms(lambda: scan_before(G._KIND_F, qb, v, extra, sub=SUB, group=False), reps=3)
    bound, bound_by = scan_bound_ms(qb.shape[0], n_pad, DIM, n_pad // SUB)
    both_variants_line("gmax_f_sub", qb.shape[0], ms_big, ms_old, bound, bound_by, card)
    dual_big = cuda_ms(lambda: G.gmax_f_sub(qb, v, extra, sub=SUB, dual=True), reps=5)
    log(f"kernel gmax_f_sub dual: b={qb.shape[0]} ms={dual_big:.4f} (the single form adds a "
        f"torch amax over the subgroup maxes for its group maxes)")
    del qb, v
    torch.cuda.empty_cache()
    return results


def kernel_masks(n_pad: int, n: int, seed: int, recency: bool):
    """extra for the new kernels' checks: ~10% of the rows masked at random,
    one whole group masked, padding masked, and recency where asked."""
    from hyperdb_tpu_torch.ops import gmax as G

    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random(n_pad) < 0.9).cuda()
    mask[n:] = False
    mask[128:256] = False  # one whole group masked
    rec = None
    if recency:
        rec = torch.from_numpy((rng.random(n_pad) * 0.05).astype(np.float32)).cuda()
    return G.make_extra(n_pad, mask, rec, device="cuda")


def phase_kernel_jaccard(rows_bin: torch.Tensor, bin_sum: torch.Tensor, seed: int):
    """``gmax_jaccard`` against its plain version at b = 512 on the store's
    0/1 plane, with empty rows (one alone, one whole group) and an empty
    query (0/0 -> -inf); the two must be equal."""
    from hyperdb_tpu_torch.ops import gmax as G

    n_pad = rows_bin.shape[0]
    b = 512
    v = rows_bin.clone()
    aux = bin_sum.clone()
    for rows in (slice(5, 6), slice(640, 768)):
        v[rows] = 0
        aux[rows] = 0
    extra = kernel_masks(n_pad, N_DOCS, seed + 11, recency=False)
    q = torch.from_numpy(
        np.random.default_rng(seed + 12).standard_normal((b, DIM), dtype=np.float32)
    ).cuda()
    q32 = (q > 0).float()
    q32[3] = 0  # an empty query
    qq, q_sum = q32.bfloat16(), q32.sum(-1, keepdim=True)
    got = G.gmax_jaccard(qq, v, q_sum, aux, extra)
    torch.cuda.synchronize()
    want = G.gmax_jaccard_plain(qq, v, q_sum, aux, extra)
    err = max_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"gmax_jaccard differs from its plain version (max abs {err:.3g})")
    if not (torch.isneginf(got[:, 1]).all() and torch.isneginf(got[3, 5]) and got[0, 5] == 0):
        raise AssertionError("gmax_jaccard: masked group / empty rows / empty query are off")

    def library():
        inter = torch.mm(qq, v.T, out_dtype=torch.float32)
        s = inter / (q_sum + aux[None, :] - inter)
        s = s.masked_fill_(torch.isnan(s), NEG_INF) + extra
        return s.view(b, n_pad // G.GROUP, G.GROUP).amax(-1)

    log(f"jaccard kernel at b={b} n={n_pad} d={DIM} (must equal its plain version):")
    entry = kernel_entry(
        "gmax_jaccard", "hyperdb_tpu/ops/pallas_gmax.py:414", err,
        lambda: G.gmax_jaccard(qq, v, q_sum, aux, extra),
        lambda: G.gmax_jaccard_plain(qq, v, q_sum, aux, extra),
        library, scan_bound_ms(b, n_pad, DIM, n_pad // G.GROUP, "jaccard"),
        before=lambda: scan_before(G._KIND_JACCARD, qq, v, extra, qaux=q_sum.reshape(b), vaux=aux),
    )
    del v, aux
    torch.cuda.empty_cache()
    return entry


def phase_kernel_int8(v_i8: torch.Tensor, v_scales: torch.Tensor, seed: int, card: str):
    """``gmax_int8`` against its plain version at b = 1024 on the store's
    unit-norm int8 plane, with masks, recency, zero-scale rows (one alone,
    one whole group) and a zero-scale query; the two must be equal."""
    from hyperdb_tpu_torch.ops import gmax as G

    n_pad = v_i8.shape[0]
    b = 1024
    v = v_i8.clone()
    vs = v_scales.clone()
    for rows in (slice(5, 6), slice(640, 768)):
        v[rows] = 0
        vs[rows] = 0
    extra = kernel_masks(n_pad, N_DOCS, seed + 21, recency=True)
    q = np.random.default_rng(seed + 22).standard_normal((b, DIM), dtype=np.float32)
    q[3] = 0
    q_i8, q_scale = quantize_queries(q)
    got = G.gmax_int8(q_i8, q_scale, v, vs, extra)
    torch.cuda.synchronize()
    want = G.gmax_int8_plain(q_i8, q_scale, v, vs, extra)
    err = max_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"gmax_int8 differs from its plain version (max abs {err:.3g})")
    if not (torch.isneginf(got[:, 1]).all() and torch.equal(got[:, 5], got[3:4, 5].expand(b))):
        raise AssertionError("gmax_int8: masked group / zero-scale rows are off")

    lib = None
    if hasattr(torch, "_int_mm"):
        def lib():
            s = torch._int_mm(q_i8, v.T).float() * (q_scale[:, None] * vs[None, :]) + extra
            return s.view(b, n_pad // G.GROUP, G.GROUP).amax(-1)

        try:  # the yardstick only: the port never calls it
            log(f"library call torch._int_mm + rescale equals the plain version: "
                f"{torch.equal(lib(), want)}")
        except RuntimeError as e:
            log(f"library call torch._int_mm not usable here ({str(e).splitlines()[0]})")
            lib = None
    else:
        log("library call torch._int_mm not present in this torch: library_ms is null")

    log(f"int8 kernel at b={b} n={n_pad} d={DIM} (must equal its plain version):")
    entry = kernel_entry(
        "gmax_int8", "hyperdb_tpu/ops/pallas_gmax.py:460", err,
        lambda: G.gmax_int8(q_i8, q_scale, v, vs, extra),
        lambda: G.gmax_int8_plain(q_i8, q_scale, v, vs, extra),
        lib, scan_bound_ms(b, n_pad, DIM, n_pad // G.GROUP, "int8"),
        before=lambda: scan_before(G._KIND_INT8, q_i8, v, extra, qaux=q_scale, vaux=vs),
    )
    q4 = q_i8.repeat(4, 1)
    qs4 = q_scale.repeat(4)
    ms_big = cuda_ms(lambda: G.gmax_int8(q4, qs4, v, vs, extra), reps=5)
    ms_old = cuda_ms(lambda: scan_before(G._KIND_INT8, q4, v, extra, qaux=qs4, vaux=vs), reps=5)
    bound, bound_by = scan_bound_ms(q4.shape[0], n_pad, DIM, n_pad // G.GROUP, "int8")
    both_variants_line("gmax_int8", q4.shape[0], ms_big, ms_old, bound, bound_by, card)
    del v, vs, q4
    torch.cuda.empty_cache()
    return entry


def run_batch(db, q, label, card, metric="cosine_similarity", **kw):
    """One query_batch_arrays at the batch of ``q``, timed on the host clock."""
    reps = 5 if q.shape[0] <= 1024 else 2
    db.query_batch_arrays(q, top_k=TOP_K, metric=metric, **kw)
    ms = wall_ms(lambda: db.query_batch_arrays(q, top_k=TOP_K, metric=metric, **kw), reps)
    log(f"{label}: b={q.shape[0]} ms/batch={ms:.3f} q/s={q.shape[0] / ms * 1e3:.1f} [{card}]")
    return ms


def log_breakdown(label, parts, wall, card):
    device = sum(parts.values())
    items = " ".join(f"{name}={ms:.3f}" for name, ms in parts.items())
    log(
        f"breakdown {label} (device ms): {items} sum={device:.3f}; batch wall={wall:.3f} "
        f"-> host+transfers={wall - device:.3f} [{card}]"
    )


def stage_breakdown(db, q: np.ndarray, wall: float, card: str, pearson: bool = False) -> None:
    """Device time of each stage of one main-path batch (the functions the
    route calls, on the same inputs), beside the batch's host-clock time;
    the difference is host work and transfers. ``pearson``: the same dot
    route over the centered plane (the queries are centered on the host in
    NumPy, so there is no device pre-step)."""
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.ops import metrics as M

    dv = db._store.device_view(db.source_indices)
    n = dv["n_pad"]
    b, k = q.shape[0], 16  # k padded to a power of two, as the engine does
    parts = {}
    if pearson:
        plane = db._store.pearson_view(db.source_indices)["rows_pearson"]
        qq = torch.from_numpy(M.pearson_center_normalize(q.astype(np.float32))).cuda().to(plane.dtype)
    else:
        plane = dv["rows_norm"]
        qt = torch.from_numpy(q).cuda()
        qq = M._match_low_precision(M.normalize(qt), plane)
        parts["normalize"] = cuda_ms(lambda: M._match_low_precision(M.normalize(qt), plane), 3, 1)
    extra = G.make_extra(n, dv["row_valid"], None, device=plane.device)
    gm, sm = G.gmax_f_sub(qq, plane, extra, sub=SUB, dual=False)
    sidx = G._select_subgroups(gm, sm, b, n, k, SUB)
    cs = G._rescore(qq, plane, extra, sidx, SUB)
    parts.update({
        "stage1": cuda_ms(lambda: G.gmax_f_sub(qq, plane, extra, sub=SUB, dual=False), 3, 1),
        "stage2": cuda_ms(lambda: G._select_subgroups(gm, sm, b, n, k, SUB), 3, 1),
        "stage3_rescore": cuda_ms(lambda: G._rescore(qq, plane, extra, sidx, SUB), 3, 1),
        "stage3_topk": cuda_ms(lambda: G.finish_candidates(cs, sidx, b, k, SUB), 3, 1),
    })
    log_breakdown(f"{'pearson' if pearson else 'cosine'} b={b}", parts, wall, card)


def stage_breakdown_metric(db, metric: str, q: np.ndarray, wall: float, card: str) -> None:
    """The same for one grouped-metric batch on its kernel route."""
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.ops import ranking as R

    dv = db._store.device_view(db.source_indices)
    n, b, k = dv["n_pad"], q.shape[0], 16
    if metric == "euclidean_metric":
        rows, aux = dv["rows"], dv["row_sq"]
    else:
        bv = db._store.binary_view(db.source_indices)
        rows, aux = bv["rows_bin"], bv["row_bin_sum"]
    qt = torch.from_numpy(q).cuda()
    q32, qq = R.grouped_metric_operands(qt, rows, metric)
    mask_extra = G.make_extra(n, dv["row_valid"], device=rows.device)
    if metric == "jaccard_similarity":
        q_sum = q32.sum(-1, keepdim=True)
        width = G.GROUP
        stage1 = lambda: G.gmax_jaccard(qq, rows, q_sum, aux, mask_extra)  # noqa: E731
        gm = stage1()
        stage2 = lambda: R.exact_top_k(gm, k)[1]  # noqa: E731
    else:
        extra = mask_extra - aux
        width = SUB
        stage1 = lambda: G.gmax_f_sub(qq * 2, rows, extra, sub=SUB, dual=False)  # noqa: E731
        gm, sm = stage1()
        stage2 = lambda: G._select_subgroups(gm, sm, b, n, k, SUB)  # noqa: E731
    cidx = stage2()

    def stage3():
        cs = R._grouped_metric_scores(
            R.gather_dot(qq, rows, cidx, width), aux.view(n // width, width)[cidx], q32, metric, DIM
        )
        cs.masked_fill_(torch.isnan(cs), NEG_INF)
        cs.masked_fill_(~dv["row_valid"].view(n // width, width)[cidx], NEG_INF)
        return R.finish_candidates(cs, cidx, b, k, width)

    parts = {
        "operands": cuda_ms(lambda: R.grouped_metric_operands(qt, rows, metric), 3, 1),
        "stage1": cuda_ms(stage1, 3, 1),
        "stage2": cuda_ms(stage2, 3, 1),
        "stage3": cuda_ms(stage3, 3, 1),
    }
    log_breakdown(f"{metric} b={b}", parts, wall, card)


def stage_breakdown_int8(db, q: np.ndarray, wall: float, card: str) -> None:
    """The same for one int8 cosine batch on the kernel route; with the
    ``"int8"`` representation the candidate set is 4x wider and a last stage
    rescores it against the float plane."""
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.ops import quantized as Q
    from hyperdb_tpu_torch.ops import ranking as R

    dv = db._store.device_view(db.source_indices)
    rescore = db._store.precision == "int8"
    v_i8, vs, n = dv["rowsn_q"], dv["rown_scales"], dv["n_pad"]
    b, k = q.shape[0], 16
    k_fetch = 4 * k if rescore else k
    qn = np.linalg.norm(q, axis=1, keepdims=True)
    x = torch.from_numpy((q / qn).astype(np.float32)).cuda()
    q_i8, q_scale = Q._quantize_device(x)
    extra = G.make_extra(n, dv["row_valid"], None, device=v_i8.device)
    gm = G.gmax_int8(q_i8, q_scale, v_i8, vs, extra)
    gidx = R.exact_top_k(gm, k_fetch)[1]
    stage3 = lambda: Q._rescore_groups(  # noqa: E731
        q_i8, q_scale, v_i8, vs, gidx, G.GROUP, dv["row_valid"], None
    )
    parts = {
        "quantize": cuda_ms(lambda: Q._quantize_device(x), 3, 1),
        "stage1": cuda_ms(lambda: G.gmax_int8(q_i8, q_scale, v_i8, vs, extra), 3, 1),
        "stage2": cuda_ms(lambda: R.exact_top_k(gm, k_fetch), 3, 1),
        "stage3_groups": cuda_ms(stage3, 3, 1),
    }
    if rescore:
        cand = stage3()[1]
        plane = dv["rows_norm"]

        def overfetch():
            exact = torch.einsum("bd,bkd->bk", x, plane[cand].float())
            return R.exact_top_k(exact.masked_fill(~dv["row_valid"][cand], NEG_INF), k)

        parts["rescore_f32"] = cuda_ms(overfetch, 3, 1)
    log_breakdown(f"{db._store.precision} cosine b={b}", parts, wall, card)


def zero_launches(G) -> None:
    for counter in (G.LAUNCHES, getattr(G, "LAUNCHES_BY_VARIANT", {})):
        for key in counter:
            counter[key] = 0


def check_variant(G, name: str) -> dict:
    """Every stage-1 launch since the counters were zeroed ran the wgmma
    variant: the variant counter holds the wrappers' launches, all under
    ``wgmma``. Returns a copy of the variant counter."""
    by_variant = dict(G.LAUNCHES_BY_VARIANT)
    total = sum(G.LAUNCHES.values())
    if by_variant != {"wgmma": total, "mma": 0}:
        raise AssertionError(
            f"{name}: {total} launches by wrapper but {by_variant} by variant: "
            "the path did not run the wgmma kernel alone"
        )
    return by_variant


def path_metrics(db, corpus, kernels, seed: int, card: str) -> None:
    """Path B: the four grouped metrics at b = 512 through the entry point."""
    from hyperdb_tpu_torch.ops import gmax as G

    n_pad = db._store.device_view(db.source_indices)["n_pad"]
    rec = recency_vector(n_pad)
    expect = {
        "euclidean_metric": "gmax_f_sub", "hamming_distance": "gmax_f_sub",
        "jaccard_similarity": "gmax_jaccard", "pearson_correlation": "gmax_f_sub",
    }
    for i, (metric, kernel) in enumerate(expect.items()):
        # euclidean: no planted copy of a corpus row, whose d^2 ~ 0 cancels
        # to noise that the square root amplifies past any tight tolerance
        q = make_queries(seed + 30 + i, 512, corpus, plant=metric != "euclidean_metric")
        atol = METRIC_ATOL[metric]
        zero_launches(G)
        ids, vals = db.query_batch_arrays(q, top_k=TOP_K, metric=metric)
        launches = dict(G.LAUNCHES)
        by_variant = check_variant(G, metric)
        if launches[kernel] < 1 or sum(launches.values()) != launches[kernel]:
            raise AssertionError(f"{metric}: expected {kernel} alone, launched {launches}")
        if kernel == "gmax_jaccard":
            kernels["gmax_jaccard"]["launches"] = launches[kernel]
        swaps, err = check_top_k(metric, ids, vals, metric_reference(db, metric, q, TOP_K), atol)
        log(
            f"path B {metric} b=512: launches {json.dumps(launches)} by variant "
            f"{json.dumps(by_variant)}; ids tie-aware equal to "
            f"the plain reference ({swaps} tied swaps, score err {err:.3g}, tol {atol})"
        )
        wall = run_batch(db, q, f"path B {metric}", card, metric=metric)
        if metric == "pearson_correlation":
            stage_breakdown(db, q, wall, card, pearson=True)
        else:
            stage_breakdown_metric(db, metric, q, wall, card)

        zero_launches(G)
        kw = {"recency_bias": RECENCY_BIAS, "timestamp_key": "ts"}
        ids, vals = db.query_batch_arrays(q, top_k=TOP_K, metric=metric, **kw)
        launches = dict(G.LAUNCHES)
        check_variant(G, f"{metric} with recency")
        want = {kernel: 1} if metric == "pearson_correlation" else {}
        if {name: c for name, c in launches.items() if c} != want:
            raise AssertionError(f"{metric} with recency: launched {launches}, expected {want}")
        ref = metric_reference(db, metric, q, TOP_K, rec=rec)
        swaps, err = check_top_k(f"{metric} recency", ids, vals, ref, atol)
        log(
            f"path B {metric} b=512 with recency: launches {json.dumps(launches)}; ids "
            f"tie-aware equal ({swaps} tied swaps, score err {err:.3g}, tol {atol})"
        )
        del ref
        torch.cuda.empty_cache()


def path_int8(docs, corpus, kernels, plane_bf16, seed: int, card: str) -> None:
    """Path A: int8-pure and int8 planes, cosine, through the entry point."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.ops import gmax as G

    t = time.perf_counter()
    db = HyperDB(documents=docs, vectors=corpus, fp_precision="float16",
                 device_precision="int8-pure")
    dv = db._store.device_view(db.source_indices)
    torch.cuda.synchronize()
    log(f"int8-pure db build: {tuple(dv['rowsn_q'].shape)} {dv['rowsn_q'].dtype} planes, "
        f"{time.perf_counter() - t:.1f} s")
    kernels["gmax_int8"] = phase_kernel_int8(dv["rowsn_q"], dv["rown_scales"], seed, card)

    q1k = make_queries(seed + 40, 1024, corpus)
    q4k = make_queries(seed + 41, 4096, corpus)
    zero_launches(G)
    i1k, v1k = db.query_batch_arrays(q1k, top_k=TOP_K)
    i4k, v4k = db.query_batch_arrays(q4k, top_k=TOP_K)
    launches = dict(G.LAUNCHES)
    by_variant = check_variant(G, "int8-pure")
    log(f"path A int8-pure launches: {json.dumps(launches)} by variant: {json.dumps(by_variant)}")
    if launches["gmax_int8"] < 2:
        raise AssertionError("int8-pure did not launch gmax_int8 once per batch")
    kernels["gmax_int8"]["launches"] = launches["gmax_int8"]
    swaps, err = check_top_k("int8-pure b=1024", i1k, v1k, int8_reference(dv, q1k, TOP_K), INT8_ATOL)
    log(f"path A int8-pure b=1024: ids tie-aware equal to the plain int8 reference "
        f"({swaps} tied swaps, score err {err:.3g}, tol {INT8_ATOL})")
    swaps, err = check_top_k(
        "int8-pure b=4096", i4k[:512], v4k[:512], int8_reference(dv, q4k[:512], TOP_K), INT8_ATOL
    )
    log(f"path A int8-pure b=4096: first 512 ids tie-aware equal ({swaps} tied swaps, "
        f"score err {err:.3g})")
    wall = run_batch(db, q1k, "path A int8-pure", card)
    stage_breakdown_int8(db, q1k, wall, card)
    wall = run_batch(db, q4k, "path A int8-pure", card)
    stage_breakdown_int8(db, q4k, wall, card)

    q64 = make_queries(seed + 42, 64, corpus)
    zero_launches(G)
    i64, v64 = db.query_batch_arrays(q64, top_k=TOP_K)
    if any(G.LAUNCHES.values()):
        raise AssertionError(f"int8-pure b=64 launched a kernel: {G.LAUNCHES}")
    swaps, err = check_top_k("int8-pure b=64", i64, v64, int8_reference(dv, q64, TOP_K), INT8_ATOL)
    log(f"path A int8-pure b=64 (plain grouped form, no launch): ids tie-aware equal "
        f"({swaps} tied swaps, score err {err:.3g})")
    try:
        db.query_batch_arrays(q64, top_k=TOP_K, metric="euclidean_metric")
    except ValueError as e:
        log(f"int8-pure + euclidean raises: {str(e)[:60]}...")
    else:
        raise AssertionError("int8-pure + euclidean_metric did not raise")
    del db, dv
    torch.cuda.empty_cache()

    t = time.perf_counter()
    db = HyperDB(documents=docs, vectors=corpus, fp_precision="float16", device_precision="int8")
    dv = db._store.device_view(db.source_indices)
    torch.cuda.synchronize()
    log(f"int8 db build: {time.perf_counter() - t:.1f} s")
    zero_launches(G)
    ids, vals = db.query_batch_arrays(q1k, top_k=TOP_K)
    launches = dict(G.LAUNCHES)
    by_variant = check_variant(G, "int8")
    log(f"path A int8 launches: {json.dumps(launches)} by variant: {json.dumps(by_variant)}")
    if launches["gmax_int8"] < 1:
        raise AssertionError("int8 did not launch gmax_int8")
    kernels["gmax_int8"]["launches"] += launches["gmax_int8"]
    kernel_fn = G.gmax_int8
    G.gmax_int8 = G.gmax_int8_plain  # the same route with the plain stage 1
    try:
        ids_p, vals_p = db.query_batch_arrays(q1k, top_k=TOP_K)
    finally:
        G.gmax_int8 = kernel_fn
    if G.LAUNCHES != launches:
        raise AssertionError("the plain stage 1 launched a kernel")
    if not (np.array_equal(ids, ids_p) and np.array_equal(vals, vals_p)):
        raise AssertionError("int8: the kernel route and the plain stage 1 disagree")
    ref = cosine_reference(plane_bf16, N_DOCS, q1k, TOP_K)
    ref_ids = ref.ids.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / TOP_K for a, b in zip(ids.tolist(), ref_ids.tolist())]))
    log(f"path A int8 b=1024: ids identical to the plain stage 1; recall@{TOP_K} against the "
        f"exact bf16 reference = {recall:.5f}")
    if recall < 0.99:
        raise AssertionError(f"int8 recall@{TOP_K} {recall:.4f} < 0.99")
    if list(ids[0, :2]) != [4, 17]:
        raise AssertionError(f"int8: duplicate rows 4/17 not first in lower-id order: {ids[0, :2]}")
    wall = run_batch(db, q1k, "path A int8", card)
    stage_breakdown_int8(db, q1k, wall, card)
    del db, dv, ref
    torch.cuda.empty_cache()


def phase_kernels_l1(rows: torch.Tensor, n: int, seed: int, card: str):
    """``gmax_l1`` and ``gmax_l1t`` against their plain versions on the
    store's raw plane at b = 64 and b = 512. Returns their entries of the
    ``kernels`` line, at b = 512."""
    from hyperdb_tpu_torch.ops import l1 as L

    n_pad = rows.shape[0]
    g = n_pad // L.GROUP
    v = rows.clone()
    v[300] = v[40]  # a tie across groups
    v[777, 5] = float("nan")  # a NaN corpus element sinks its row only
    extra = kernel_masks(n_pad, n, seed + 51, recency=False)  # ~10% masked, group 1 whole
    vt = v.t().contiguous()
    v32 = v.float()
    dead = torch.isinf(extra)
    results = {}
    log(f"manhattan kernels at n={n_pad} d={DIM} {v.dtype} (rtol {L1_RTOL}, atol {L1_ATOL}):")
    for b in (64, 512):
        q = torch.from_numpy(
            np.random.default_rng(seed + 52 + b).standard_normal((b, DIM), dtype=np.float32)
        ).cuda()
        q[3, 7] = float("nan")  # a NaN query: every group bottoms out
        got, got_t = L.gmax_l1(q, v, extra), L.gmax_l1t(q, vt, extra)
        torch.cuda.synchronize()
        want, want_t = L.gmax_l1_plain(q, v, extra), L.gmax_l1t_plain(q, vt, extra)
        err, err_t = l1_err("gmax_l1", got, want), l1_err("gmax_l1t", got_t, want_t)
        keep = torch.ones(b, dtype=torch.bool, device=q.device)
        keep[3] = False
        err_both = l1_err("gmax_l1 against -gmax_l1t", got[keep], -got_t[keep])
        if not (
            torch.isneginf(got[:, 1]).all() and torch.isposinf(got_t[:, 1]).all()
            and torch.isneginf(got[3]).all() and (got_t[3] >= 1e29).all()
            and torch.isfinite(got[0, 6]) and torch.isfinite(got_t[0, 6])  # row 777's group
        ):
            raise AssertionError("L1 kernels: masked group / NaN element / NaN query are off")
        log(f"b={b}: the two contracts agree after negation within {err_both:.3g}")
        del want, want_t, got, got_t

        def lib_l1():
            return (extra - torch.cdist(q, v32, p=1)).view(b, g, L.GROUP).amax(-1)

        def lib_l1t():
            dist = torch.cdist(q, vt.float().t(), p=1).masked_fill_(dead[None, :], float("inf"))
            return dist.view(b, g, L.GROUP).amin(-1)

        try:  # the yardstick only: the port never calls it
            lib_l1()
        except RuntimeError as e:
            log(f"library call torch.cdist not usable here ({str(e).splitlines()[0]})")
            lib_l1 = lib_l1t = None
        entries = {
            "gmax_l1": kernel_entry(
                f"gmax_l1 b={b}", "hyperdb_tpu/ops/pallas_l1.py:163", err,
                lambda: L.gmax_l1(q, v, extra), lambda: L.gmax_l1_plain(q, v, extra),
                lib_l1, l1_bound_ms(b, n_pad, DIM, v.element_size()),
                reps=10, source=L1_SOURCE, slow=True,
            ),
            "gmax_l1t": kernel_entry(
                f"gmax_l1t b={b}", "hyperdb_tpu/ops/pallas_l1.py:322", err_t,
                lambda: L.gmax_l1t(q, vt, extra), lambda: L.gmax_l1t_plain(q, vt, extra),
                lib_l1t, l1_bound_ms(b, n_pad, DIM, v.element_size()),
                reps=10, source=L1_SOURCE, slow=True,
            ),
        }
        for name, entry in entries.items():
            entry["name"] = name
            results[name] = entry  # the b = 512 entries stay
    log(f"transpose of the {tuple(v.shape)} plane: {cuda_ms(lambda: v.t().contiguous(), 5, 1):.4f} ms "
        f"[{card}]")
    del v, vt, v32
    torch.cuda.empty_cache()
    return results


def stage_breakdown_l1(db, q: np.ndarray, wall: float, card: str, l1t: int) -> None:
    """Device time of each stage of one manhattan batch on its kernel route
    (the functions the route calls, on the same inputs)."""
    from hyperdb_tpu_torch.ops import l1 as L
    from hyperdb_tpu_torch.ops import ranking as R

    dv = db._store.device_view(db.source_indices)
    rows, n = dv["rows"], dv["n_pad"]
    b, k = q.shape[0], 16
    q32 = torch.from_numpy(q).cuda()
    extra = L.make_extra(n, dv["row_valid"], device=rows.device)
    parts = {"mask_extra": cuda_ms(lambda: L.make_extra(n, dv["row_valid"], device=rows.device), 3, 1)}
    if l1t:
        vt = rows.t().contiguous()
        parts["transpose"] = cuda_ms(lambda: rows.t().contiguous(), 3, 1)
        stage1 = lambda: -L.gmax_l1t(q32, vt, extra)  # noqa: E731
    else:
        stage1 = lambda: L.gmax_l1(q32, rows, extra)  # noqa: E731
    gm = stage1()
    m = min(k + L.L1_GROUP_MARGIN, n // L.GROUP)
    gidx = R.exact_top_k(gm, m)[1]
    parts["stage1"] = cuda_ms(stage1, 3, 1)
    parts["stage2"] = cuda_ms(lambda: R.exact_top_k(gm, m), 3, 1)
    parts["stage3"] = cuda_ms(lambda: L._rescore_groups(q32, rows, gidx, k, dv["row_valid"]), 3, 1)
    log_breakdown(f"manhattan b={b} pallas_l1t={l1t}", parts, wall, card)


def path_manhattan(db, corpus, kernels, seed: int, card: str) -> None:
    """Path C: manhattan over the 1M-row corpus through the entry point."""
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.ops import l1 as L
    from hyperdb_tpu_torch.ops import ranking as R

    dv = db._store.device_view(db.source_indices)
    rows, n_pad = dv["rows"], dv["n_pad"]
    queries = {b: make_queries(seed + 60 + b, b, corpus) for b in (8, 64, 512)}
    refs = {b: DocReference("manhattan", q, rows, N_DOCS, TOP_K) for b, q in queries.items()}
    knob_t, knob_b = CONFIG.pallas_l1t, CONFIG.pallas_l1_min_batch
    results = {}
    zero_launches(L)
    try:
        for b in (64, 512):
            for l1t in (1, 0):
                CONFIG.pallas_l1t = l1t
                before = dict(L.LAUNCHES)
                ids, vals = db.query_batch_arrays(
                    queries[b], top_k=TOP_K, metric="manhattan_distance"
                )
                name = "gmax_l1t" if l1t else "gmax_l1"
                other = "gmax_l1" if l1t else "gmax_l1t"
                if L.LAUNCHES[name] != before[name] + 1 or L.LAUNCHES[other] != before[other]:
                    raise AssertionError(f"manhattan b={b} pallas_l1t={l1t}: launched {L.LAUNCHES}")
                swaps, err = check_top_k(
                    f"manhattan b={b} l1t={l1t}", ids, vals, refs[b], MANHATTAN_ATOL
                )
                if list(ids[0, :2]) != [4, 17]:
                    raise AssertionError(f"manhattan: duplicate rows 4/17 not first: {ids[0, :2]}")
                log(f"path C manhattan b={b} pallas_l1t={l1t} ({name}): ids tie-aware equal to the "
                    f"exact reference ({swaps} tied swaps, score err {err:.3g}, tol {MANHATTAN_ATOL})")
                results[b, l1t] = (ids, vals)
        launches = dict(L.LAUNCHES)
        log(f"path C launches: {json.dumps(launches)}")
        if launches != {"gmax_l1": 2, "gmax_l1t": 2}:
            raise AssertionError(f"path C: expected two launches of each kernel, got {launches}")
        for name in launches:
            kernels[name]["launches"] = launches[name]

        # the streamed route: recency, a small batch, and the same queries
        # with the kernel route switched off
        CONFIG.pallas_l1t = knob_t
        kw = {"recency_bias": RECENCY_BIAS, "timestamp_key": "ts"}
        ids, vals = db.query_batch_arrays(queries[64], top_k=TOP_K, metric="manhattan_distance", **kw)
        ref = DocReference("manhattan", queries[64], rows, N_DOCS, TOP_K, rec=recency_vector(n_pad))
        # the recency term (up to 0.05) is added in f32: an ulp there is 3.7e-9
        swaps, err = check_top_k("manhattan b=64 recency", ids, vals, ref, 2 * MANHATTAN_ATOL)
        log(f"path C manhattan b=64 with recency (streamed, no launch): ids tie-aware equal "
            f"({swaps} tied swaps, score err {err:.3g})")
        del ref
        ids, vals = db.query_batch_arrays(queries[8], top_k=TOP_K, metric="manhattan_distance")
        swaps, err = check_top_k("manhattan b=8", ids, vals, refs[8], MANHATTAN_ATOL)
        log(f"path C manhattan b=8 (streamed, no launch): ids tie-aware equal "
            f"({swaps} tied swaps, score err {err:.3g})")
        CONFIG.pallas_l1_min_batch = 0
        for b in (64, 512):
            sids, svals = db.query_batch_arrays(queries[b], top_k=TOP_K, metric="manhattan_distance")
            check_top_k(f"manhattan b={b} streamed", sids, svals, refs[b], MANHATTAN_ATOL)
            for l1t in (1, 0):
                kids, kvals = results[b, l1t]
                differ = kids != sids
                gap = float(np.abs(kvals - svals).max())
                if differ.any() and float(np.abs(kvals - svals)[differ].max()) > MANHATTAN_ATOL:
                    raise AssertionError(
                        f"manhattan b={b} l1t={l1t}: kernel and streamed routes return different ids"
                    )
                if gap > MANHATTAN_ATOL:
                    raise AssertionError(f"manhattan b={b}: routes' scores differ by {gap:.3g}")
                log(f"path C manhattan b={b} pallas_l1t={l1t}: kernel route against streamed "
                    f"route: {int(differ.sum())} ids differ, max score difference {gap:.3g}, "
                    f"bit-identical scores: {bool(np.array_equal(kvals, svals))}")
        CONFIG.pallas_l1_min_batch = knob_b
        if L.LAUNCHES != launches:
            raise AssertionError(f"the streamed route launched a kernel: {L.LAUNCHES}")
        del refs

        for b in (64, 512):
            for l1t in (1, 0):
                CONFIG.pallas_l1t = l1t
                wall = run_batch(db, queries[b], f"path C manhattan pallas_l1t={l1t}", card,
                                 metric="manhattan_distance")
                stage_breakdown_l1(db, queries[b], wall, card, l1t)
        CONFIG.pallas_l1t = knob_t
        rec = recency_vector(n_pad)
        for b, label, rkw, r in ((64, "streamed, recency", kw, rec), (8, "streamed", {}, None)):
            wall = run_batch(db, queries[b], f"path C manhattan {label}", card,
                             metric="manhattan_distance", **rkw)
            qt = torch.from_numpy(queries[b]).cuda()
            scan = cuda_ms(lambda: R.rank_top_k(
                qt, rows, 16, metric="manhattan_distance", row_mask=dv["row_valid"], recency=r
            ), 2, 1)
            log_breakdown(f"manhattan b={b} {label}", {"scan": scan}, wall, card)
        CONFIG.pallas_l1_min_batch = 0
        run_batch(db, queries[64], "path C manhattan streamed", card, metric="manhattan_distance")
    finally:
        CONFIG.pallas_l1t, CONFIG.pallas_l1_min_batch = knob_t, knob_b
    torch.cuda.empty_cache()


def path_chunked(corpus, seed: int, card: str) -> None:
    """Path D: the corpus as documents of 4 rows each, through the chunked
    doc-level branch."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.ops import l1 as L

    n_docs = N_DOCS // ROWS_PER_DOC
    t = time.perf_counter()
    db = HyperDB.from_state({
        "vectors": corpus[: n_docs * ROWS_PER_DOC],
        "documents": [{"grp": "ab"[i % 2]} for i in range(n_docs)],
        "source_indices": np.repeat(np.arange(n_docs), ROWS_PER_DOC),
        "metadata_keys": ["grp"], "fp_precision": np.float16, "ann_metric": "cosine",
    })
    dv = db._store.device_view(db.source_indices)
    torch.cuda.synchronize()
    if db.size() != n_docs or db.size(with_chunks=True) != n_docs * ROWS_PER_DOC:
        raise AssertionError("chunked db: wrong document or row count")
    log(f"chunked db build: {n_docs} documents x {ROWS_PER_DOC} rows, {time.perf_counter() - t:.1f} s")
    q = make_queries(seed + 70, 64, corpus)
    grp_a = torch.from_numpy(np.arange(n_docs) % 2 == 0).cuda()
    zero_launches(G)
    zero_launches(L)
    for metric, kind, plane, atol in (
        ("cosine_similarity", "cosine", "rows_norm", ATOL),
        ("manhattan_distance", "manhattan", "rows", MANHATTAN_ATOL),
    ):
        for label, kw, mask in (
            ("no filter", {}, None),
            ("metadata filter", {"filters": [("metadata", {"grp": "a"})]}, grp_a),
        ):
            ids, vals = db.query_batch_arrays(q, top_k=TOP_K, metric=metric, **kw)
            ref = DocReference(kind, q, dv[plane], n_docs, TOP_K, per_doc=ROWS_PER_DOC, doc_mask=mask)
            swaps, err = check_top_k(f"chunked {metric} {label}", ids, vals, ref, atol)
            if mask is not None and (ids % 2).any():
                raise AssertionError(f"chunked {metric}: the filter let a masked document through")
            if list(ids[0, :2]) != [4 // ROWS_PER_DOC, 17 // ROWS_PER_DOC] and mask is None:
                raise AssertionError(f"chunked {metric}: rows 4 and 17's documents not first: {ids[0, :2]}")
            log(f"path D chunked {metric}, {label}: document ids tie-aware equal to the row-scan "
                f"reference ({swaps} tied swaps, score err {err:.3g}, tol {atol})")
            del ref
            run_batch(db, q, f"path D chunked {metric}, {label}", card, metric=metric, **kw)
    if any(G.LAUNCHES.values()) or any(L.LAUNCHES.values()):
        raise AssertionError("the chunked branch launched a kernel")
    del db, dv
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2

    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.ops import cuda_build
    from hyperdb_tpu_torch.ops import gmax as G

    # 1. environment and build
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc_version()}")
    t = time.perf_counter()
    libs = cuda_build.build()
    log(f"kernel build: {time.perf_counter() - t:.2f} s for {sorted(libs)}")

    # 3 (data first: phase 2 runs on the main path's own plane)
    t = time.perf_counter()
    corpus = make_corpus(args.seed)
    docs = make_documents()
    db = HyperDB(documents=docs, vectors=corpus, fp_precision="float16", metadata_keys=["ts"])
    dv = db._store.device_view(db.source_indices)
    plane, n_pad = dv["rows_norm"], dv["n_pad"]
    torch.cuda.synchronize()
    log(f"db build: {N_DOCS} x {DIM} f16 -> {tuple(plane.shape)} {plane.dtype} plane "
        f"on {plane.device}, {time.perf_counter() - t:.1f} s")

    # 2. float kernels against their plain versions
    kernels = phase_kernels(plane, N_DOCS, args.seed, card)

    # 3. the main path: launch counts from this run only
    q512 = make_queries(args.seed + 2, 512, corpus)
    q16k = make_queries(args.seed + 3, 16384, corpus)
    zero_launches(G)
    i512, v512 = db.query_batch_arrays(q512, top_k=TOP_K, metric="cosine_similarity")
    i16k, v16k = db.query_batch_arrays(q16k, top_k=TOP_K, metric="cosine_similarity")
    launches = dict(G.LAUNCHES)
    by_variant = check_variant(G, "main path")
    log(f"main path launches: {json.dumps(launches)} by variant: {json.dumps(by_variant)}")
    if launches["gmax_f_sub"] < 2:
        raise AssertionError("the main path did not launch gmax_f_sub at both batches")
    kernels["gmax_f_sub"]["launches"] = launches["gmax_f_sub"]
    swaps, err = check_ids("b=512", i512, v512, plane, N_DOCS, q512, TOP_K)
    if list(i512[0, :2]) != [4, 17]:
        raise AssertionError(f"duplicate rows 4/17 not first in lower-id order: {i512[0, :2]}")
    log(f"main b=512: ids tie-aware equal to the reference ({swaps} tied swaps, score err {err:.3g})")
    swaps, err = check_ids("b=16384", i16k[:512], v16k[:512], plane, N_DOCS, q16k[:512], TOP_K)
    log(f"main b=16384: first 512 ids tie-aware equal ({swaps} tied swaps, score err {err:.3g})")
    wall = run_batch(db, q512, "main path", card)
    stage_breakdown(db, q512, wall, card)
    wall = run_batch(db, q16k, "main path", card)
    stage_breakdown(db, q16k, wall, card)
    del i16k, v16k, q16k

    # 4. gmax_f through the entry point
    sub = CONFIG.pallas_subgroup
    CONFIG.pallas_subgroup = 0
    zero_launches(G)
    ids, vals = db.query_batch_arrays(q512, top_k=TOP_K, metric="cosine_similarity")
    launches_f = dict(G.LAUNCHES)
    by_variant = check_variant(G, "gmax_f path")
    log(f"gmax_f path launches: {json.dumps(launches_f)} by variant: {json.dumps(by_variant)}")
    if launches_f["gmax_f"] < 1:
        raise AssertionError("pallas_subgroup=0 did not route stage 1 through gmax_f")
    kernels["gmax_f"]["launches"] = launches_f["gmax_f"]
    swaps, err = check_ids("gmax_f b=512", ids, vals, plane, N_DOCS, q512, TOP_K)
    log(f"gmax_f b=512: ids tie-aware equal ({swaps} tied swaps, score err {err:.3g})")
    run_batch(db, q512, "gmax_f path", card)
    CONFIG.pallas_subgroup = sub

    # 5. smaller routes (plain grouped form, no kernel)
    q64 = make_queries(args.seed + 4, 64, corpus)
    rows = db.query_batch(q64, top_k=TOP_K)
    ids = np.array([[r[2] for r in row] for row in rows])
    vals = np.array([[r[1] for r in row] for row in rows], dtype=np.float32)
    swaps, err = check_ids("query_batch b=64", ids, vals, plane, N_DOCS, q64, TOP_K)
    log(f"query_batch b=64: ids tie-aware equal ({swaps} tied swaps, score err {err:.3g})")
    one = db.query(q64[5], top_k=TOP_K)
    swaps, err = check_ids(
        "query b=1", np.array([[r[2] for r in one]]),
        np.array([[r[1] for r in one]], dtype=np.float32), plane, N_DOCS, q64[5:6], TOP_K,
    )
    log(f"query b=1: ids tie-aware equal ({swaps} tied swaps, score err {err:.3g})")
    run_batch(db, q64, "plain grouped route", card)

    # 6. path B: grouped metrics on the same DB
    t = time.perf_counter()
    bv = db._store.binary_view(db.source_indices)
    torch.cuda.synchronize()
    log(f"binary view build: {time.perf_counter() - t:.1f} s")
    kernels["gmax_jaccard"] = phase_kernel_jaccard(bv["rows_bin"], bv["row_bin_sum"], args.seed)
    path_metrics(db, corpus, kernels, args.seed, card)

    # 8-9. the manhattan kernels on the raw plane, then path C
    kernels.update(phase_kernels_l1(dv["rows"], N_DOCS, args.seed, card))
    path_manhattan(db, corpus, kernels, args.seed, card)

    # the planes path A needs no more: keep only the cosine plane for its recall check
    for key in ("rows", "rows_bin", "row_bin_sum", "rows_pearson"):
        dv.pop(key, None)
    del bv
    torch.cuda.empty_cache()

    # 7. path A: int8 planes
    path_int8(docs, corpus, kernels, plane, args.seed, card)
    del db, dv, plane
    torch.cuda.empty_cache()

    # 10. path D: the chunked doc-level branch
    path_chunked(corpus, args.seed, card)

    names = ("gmax_f_sub", "gmax_f", "gmax_int8", "gmax_jaccard", "gmax_l1", "gmax_l1t")
    for name in names:
        if kernels[name]["launches"] < 1:
            raise AssertionError(f"{name} was never launched through HyperDB")
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [kernels[name] for name in names]}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
