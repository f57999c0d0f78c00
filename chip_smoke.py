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
   rows, an empty query) and timed like the float kernels. One more
   euclidean b = 512 batch plants a copy of row 4 as query 0 and prints the
   grouped route's score of row 4 beside its own formula in f64 and the
   f64 difference form;
7. path A, int8 planes: ``device_precision="int8-pure"`` at b = 1024 and
   b = 4096 (``gmax_int8`` launched once per batch; ids tie-aware equal to
   a plain reference over the same int8 planes) and at b = 64 (the plain
   grouped form, no launch); ``"int8"`` at b = 1024 (ids identical to the
   same route with the plain stage 1; recall@10 against the exact bf16
   reference at least 0.99). ``gmax_int8`` is held EQUAL to its plain
   version at b = 1024 on the store's plane (masked group, masked rows,
   recency, zero-scale rows) and timed beside ``torch._int_mm`` + rescale +
   ``amax``. The projscan build on this isotropic plane must decline;
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
   plane), cosine, manhattan and euclidean at b = 64, with and
   without a metadata filter; document ids tie-aware equal to a reference
   that scores every row and takes each document's best; then the plain
   euclidean routes' float64 expansion timed beside the f32 one
   (``euclidean_cost``);
11. path E, text and persistence: the in-repo ``local-384`` encoder
   (``MiniLMEmbedder.from_local_assets``, full width) on the card against
   the same encoder on the CPU over 1024 seeded texts (largest element
   difference and smallest cosine within ``ENC_MAX_ABS``/``ENC_MIN_COS``, at
   both settings of cuBLAS's reduced-precision bf16 reduction), a b = 512
   forward timed beside its bound; a float16 text DB of 2^18 demo-shaped
   documents (descriptions of 20-120 Zipf-drawn vocab words, none chunks)
   built through ``make_embedding_function``, docs/s split into tokenise,
   encode and commit; text batches through
   ``generate_query_vectors_batch_device`` + ``query_batch_arrays`` at
   b = 512 and 4096 (``gmax_f_sub`` on the ``wgmma`` variant, counters set
   to 0 just before), b = 512 through the host path (identical answers) and
   b = 1 through ``query``, ids tie-aware against the exact reference over
   the DB's plane and the card's own query embeddings, each timed with its
   breakdown; checkpoint and ``.pickle.gz`` round trips into fresh DBs on the
   card, answers bit-identical; the default (hybrid, 4480-d) embedder over
   16384 documents and a b = 512 text batch on the plain route;
12. path F, the two indexes (run after path A): a seeded 1M x 384 float16
   corpus with a decaying spectrum (``make_spectral_corpus``; its top 128
   directions must keep at least 0.6 of the variance). F1: a float16 DB
   with IVF (nlist 2000), its build's f64 assignment and exact centroid
   sums timed beside f32 forms of the same steps, through ``query`` (b = 1:
   the pre-filter and the
   gathered scan) and ``query_batch_arrays`` at b = 64 and 512 (the shared
   probe frontier), each answer held tie-aware to an exact f32 scan over
   the rows the same index probed, recall@10 against the full exact scan
   held to ``IVF_RECALL_FLOOR``, each timed beside the exact scan of the
   same DB; an add of 1 % more rows must join the clusters without
   re-clustering. F2: an int8-pure DB with projscan (d' = 128) at b = 1024
   and 4096: ``gmax_int8`` launched once per batch on the ``wgmma``
   variant, ids and scores identical to the same route with the plain
   stage A, recall@10 against the int8-pure exact scan, a stage breakdown,
   the exact scan beside it; ``gmax_int8`` held EQUAL to its plain version
   at (1024, 2^20, 128) on the index's own plane and timed beside its bound
   and ``torch._int_mm``. F3: a checkpoint round trip of each DB into a
   fresh DB on the card, index state equal and answers bit-identical.
13. path G, serving and the CLI on the card (G1, G2, G4 over the main
   path's DB before it is freed, G3 in path E). Each serving phase runs 8
   load processes (``hyperdb_tpu_torch/tools/serve_load.py``, spawned as
   processes of their own, never threads of this one), each with 4
   keep-alive connections, for 1 s of warm-up and 5 s measured, and prints
   q/s, p50 / p99 ms per request, flushes, mean and max flush, engine and
   hand-back ms per flush, the worker's idle share and the CPU cores the
   server and the clients used; 512 sampled responses are held tie-aware
   (scores within 1e-5) to ``query_batch_arrays`` on the same block (the
   float16 wire block; for text, the flush's own embeddings), and
   ``/healthz`` and ``/stats`` must answer. G1: the native front end, binary
   f32 queries, 32 in flight per connection, at ``max_batch`` 1024 (must
   launch ``gmax_f_sub``) and at the CLI default 256, then the engine alone
   at b = 256, 512, 1024; G2: the stdlib front end with its batcher
   (``max_batch`` 64), JSON queries, one in flight per connection; G3: the
   native front end over path E's text DB, ``text/plain`` queries, 16 in
   flight per connection, ``max_batch`` 512 (the encoder's WordPiece must
   be the C++ one); G4: ``python -m hyperdb_tpu_torch`` ``build`` of a
   4096-document JSONL, ``stats`` and ``query --text`` on its checkpoint,
   ``bench --batch 512 --iters 10`` on a checkpoint of the main path's DB,
   each a process of its own on the card. Path E also times the encoder's
   host tokenisation of 512 texts with the C++ WordPiece against the
   Python path (ids equal).
14. path H, multi-device, over the main path's DB (H1 before path G, H3 and
   H2 after it, H4 last). H1: ``ShardedHyperDB`` over meshes of 1 and 4
   shards on the card (n_local 2^20 and 250112): cosine at b = 512 and 16384
   (``gmax_f_sub`` on every shard), 512 with ``pallas_subgroup = 0``
   (``gmax_f``), manhattan b = 64 under ``pallas_l1t`` = 1 and 0
   (``gmax_l1t``, ``gmax_l1``), euclidean and jaccard b = 512 (the plain
   per-shard route), cosine b = 512 with recency and with a metadata
   filter, at 4 shards also cosine b = 512 at the default
   ``grouped_topk_min_rows`` (the other 4-shard cells lower it, since
   250112-row shards fall under it; at the default every shard takes the
   plain scan, timed and held to the exact reference), and ``int8-pure``
   at b = 1024 and 4096 (``gmax_int8`` on every
   shard where the route's epilogue budget sends it there: b = 1024 on one
   shard, 4096 on four). Launches are counted per shard (``ShardSpy``) and
   the expected kernel must run once on every shard, a plain route on none;
   every answer is held tie-aware to an exact reference and, where the
   single-device route computes the same formula, to the single-device
   answer on the same block (euclidean's differs by the grouped route's
   bf16 query and is reported); ms/batch beside the single-device time.
   H2: a 4-shard DB with reserved capacity: add 4096 rows, remove 1000
   documents, compact, each held to a HyperDB rebuilt from the same
   documents; ``from_checkpoint`` of a sharded checkpoint of the DB
   (``load_sharded_vectors``). H3: the native front end over the 1-shard
   DB with G1's traffic at ``max_batch`` 1024 for 3 s. H4: the launchers
   ``tools/multihost_serve_dryrun.py`` (two ranks on the card over gloo,
   each with half of a 1M x 384 corpus: the array surface at b = 512, and
   the document surface's 11 checks over 20000 documents of 1-3 rows, a
   relayed refill and plane reuse; world size 1 at the launcher's defaults,
   the card over nccl) and ``tools/multihost_fault_dryrun.py`` (a hung
   follower must raise on the leader within its 5 s deadline).

Then a JSON line describing every kernel, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero and prints no last line. It needs one CUDA device and refuses to run
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
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
TEXT_DOCS = 1 << 18  # path E: documents of the text DB (no document chunks)
ENC_TEXTS = 1024  # path E: texts of the card-against-CPU encoder check
DEFAULT_EMB_DOCS = 16384  # path E: documents embedded by the default (hybrid) embedder
F_CENTRES = 4096  # path F: cluster centres of the decaying-spectrum corpus
F_NOISE = 0.08  # path F: per-direction noise of a row around its centre
# path F: floor of the IVF batches' recall@10 against the full exact scan. A
# CPU rehearsal of path F at 65536 and 262144 rows (nlist 512 and 1024, the
# same budget rule) measured 0.9957-1.0; 0.9 leaves room for the finer lists
# of 1M rows while still failing an index that probes the wrong clusters.
IVF_RECALL_FLOOR = 0.9
# card against CPU, local-384 encoder, unit rows: largest element difference
# and smallest row cosine (6.7e-4 and 0.99999 measured on an H100 over this
# script's 1024 texts, PERF.md)
ENC_MAX_ABS, ENC_MIN_COS = 5e-3, 0.9999
# path G, serving: spawned load clients, each with SERVE_CONNS keep-alive
# connections; a warm-up, then the measured window; SERVE_SAMPLE responses
# of each phase held to query_batch_arrays on the same block
SERVE_CLIENTS, SERVE_CONNS = 8, 4
SERVE_WARMUP_S, SERVE_SECONDS = 1.0, 5.0
SERVE_WINDOW_MS = 2.0
SERVE_SAMPLE = 512
SERVE_ATOL = ATOL
G4_DOCS = 4096  # path G4: documents of the CLI's build
H3_SECONDS = 3.0  # path H3: the measured window of the sharded serving phase
H1_SHARD_MIN_ROWS = 1 << 17  # path H1: grouped_topk_min_rows for shards of 250112 rows
H4_DOCS2 = 20_000  # path H4: documents (1-3 rows each) behind the document surface
ROOT = os.path.dirname(os.path.abspath(__file__))
LOAD_TOOL = os.path.join(ROOT, "hyperdb_tpu_torch", "tools", "serve_load.py")
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
    queries), "euclidean" (``1/(1 + sqrt(sum((v - q)^2)))``, the difference
    form, against the f32 queries) or "cosine" (the dot with the query
    normalized in f32 and rounded to the plane's dtype, as the route
    multiplies it)."""

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
        if self.metric == "euclidean":
            return 1.0 / (1.0 + torch.sqrt(((r - q) ** 2).sum(-1)))
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


def stage_breakdown(db, q: np.ndarray, wall: float, card: str, pearson: bool = False,
                    label: str = "cosine", extra_parts: dict | None = None) -> dict:
    """Device time of each stage of one main-path batch (the functions the
    route calls, on the same inputs), beside the batch's host-clock time;
    the difference is host work and transfers. ``pearson``: the same dot
    route over the centered plane (the queries are centered on the host in
    NumPy, so there is no device pre-step). ``extra_parts`` are measured
    steps before the scan (the text path's tokenise and encode), printed
    first. Returns the parts."""
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.ops import metrics as M

    dv = db._store.device_view(db.source_indices)
    n = dv["n_pad"]
    b, k = q.shape[0], 16  # k padded to a power of two, as the engine does
    parts: dict = {}
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
    parts = {**(extra_parts or {}), **parts}
    log_breakdown(f"{'pearson' if pearson else label} b={b}", parts, wall, card)
    return parts


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
    planted_euclidean(db, corpus, seed, card)


def planted_euclidean(db, corpus, seed: int, card: str) -> None:
    """Euclidean at b = 512 with a planted copy of row 4 as query 0: the
    grouped route's score of row 4 beside two f64 scores. "formula": the
    route's own expansion |v|^2 - 2 q.v + |q|^2 on its operands (the stored
    bf16 row, the query rounded to bf16 for the product, the f32 query for
    |q|^2), so the gap to it is f32 cancellation alone; "difference": the
    reference's sqrt(sum((q - v)^2)) of the f32 query and the stored row,
    so the gap to it adds the plane's rounding of the row."""
    q = make_queries(seed + 39, 512, corpus)
    ids, vals = db.query_batch_arrays(q, top_k=TOP_K, metric="euclidean_metric")
    if list(ids[0, :2]) != [4, 17]:
        raise AssertionError(f"euclidean planted: rows 4/17 not first in lower-id order: {ids[0, :3]}")
    row = db._store.device_view(db.source_indices)["rows"][4]
    v, q0 = row.double(), torch.from_numpy(q[0]).cuda().double()
    d2 = float((v * v).sum() - 2.0 * (q0.to(row.dtype).double() * v).sum() + (q0 * q0).sum())
    formula = 1.0 / (1.0 + max(d2, 0.0) ** 0.5)
    difference = float(1.0 / (1.0 + torch.linalg.norm(q0 - v)))
    score = float(vals[0, 0])
    log(f"path B euclidean b=512 with row 4 planted: ids {ids[0, :3].tolist()}, route score of "
        f"row 4 {score:.8f}; f64 formula {formula:.8f} (gap {formula - score:.3g}), f64 "
        f"difference form {difference:.8f} (gap {difference - score:.3g}) [{card}]")


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
    projscan_decline_check(dv)
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


# ---------------------------------------------------------------- path F: indexes


def make_spectral_corpus(seed: int, n: int) -> np.ndarray:
    """Path F's corpus: ``n`` x ``DIM`` float16 rows shaped like real
    embeddings, with a decaying spectrum. ``F_CENTRES`` cluster centres
    with per-direction scales ``(j+1)^-0.5`` under a seeded rotation, plus
    isotropic per-row noise of ``F_NOISE`` per direction; rows 4 and 17 are
    one duplicated row (the lower id must win the tie)."""
    rng = np.random.default_rng(seed + 90)
    rot, _ = np.linalg.qr(rng.standard_normal((DIM, DIM)))
    scales = (np.arange(DIM) + 1.0) ** -0.5
    centres = ((rng.standard_normal((F_CENTRES, DIM)) * scales) @ rot.T).astype(np.float32)
    assign = rng.integers(0, F_CENTRES, size=n)
    v = np.empty((n, DIM), dtype=np.float16)
    step = 1 << 18
    for a in range(0, n, step):
        m = min(step, n - a)
        noise = rng.standard_normal((m, DIM), dtype=np.float32) * np.float32(F_NOISE)
        v[a : a + m] = centres[assign[a : a + m]] + noise
    v[17] = v[4]
    return v


def index_queries(seed: int, b: int, corpus: np.ndarray) -> np.ndarray:
    """Queries near corpus rows (a row plus noise of the rows' own noise
    scale), as a retrieval front end sends; query 0 is row 4 itself."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, N_DOCS, size=b)
    q = corpus[rows].astype(np.float32)
    q += rng.standard_normal(q.shape, dtype=np.float32) * np.float32(F_NOISE)
    q[0] = corpus[4].astype(np.float32)
    return q


def recall_at_k(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / want.shape[1]
                          for a, b in zip(got.tolist(), want.tolist())]))


def check_over_candidates(name, plane, q, cands, got_ids, got_vals):
    """Exactness of an IVF answer: for each query, the ids and scores equal
    (tie-aware, ``ATOL``) an exact f32 scan with a stable sort over exactly
    the rows ``cands[i]`` that the same index object probed."""
    worst, swaps = 0.0, 0
    for i, cand in enumerate(cands):
        cand = np.asarray(cand, dtype=np.int64)
        ref = cosine_reference(plane[torch.from_numpy(cand).cuda()], len(cand), q[i : i + 1], TOP_K)
        order = np.argsort(cand, kind="stable")
        at = np.searchsorted(cand[order], got_ids[i])
        at = np.minimum(at, len(cand) - 1)
        if not np.array_equal(cand[order][at], got_ids[i]):
            raise AssertionError(f"{name} query {i}: an id outside the probed candidates")
        s, e = check_top_k(f"{name} query {i}", order[at][None], got_vals[i : i + 1], ref, ATOL)
        swaps += s
        worst = max(worst, e)
    return swaps, worst


def projscan_decline_check(dv) -> None:
    """F2's decline check on path A's isotropic int8-pure plane: the top-128
    directions keep about a third of its variance, so the build with
    ``min_variance = 0.5`` must decline and say so."""
    import contextlib
    import io

    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.index.projscan import ProjScanIndex

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        index = ProjScanIndex.build_from_device_rows(
            (dv["rowsn_q"], dv["rown_scales"]), num_rows=int(dv["n_pad"]),
            d_prime=CONFIG.projscan_dprime, num_valid=N_DOCS, min_variance=0.5,
        )
    said = out.getvalue().strip().splitlines()
    if index is not None or not any("projscan declined" in line for line in said):
        raise AssertionError(f"projscan did not decline the isotropic plane: {said}")
    log(f"path F decline check on path A's isotropic int8-pure plane: {said[-1]} "
        f"({time.perf_counter() - t:.1f} s)")


def path_ivf(db, corpus, extra, plane, seed: int, card: str) -> None:
    """F1: the IVF index on a float16 DB through ``query`` and
    ``query_batch_arrays``, exact over its probed candidates, timed beside
    the exact scan of the same DB."""
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.index.flat import FlatIndex
    from hyperdb_tpu_torch.index.ivf import IVFIndex, default_nlist
    from hyperdb_tpu_torch.ops import gmax as G

    index = db.ann_index
    if not isinstance(index, IVFIndex) or index.nlist != default_nlist(N_DOCS):
        raise AssertionError(f"F1: expected an IVF index of {default_nlist(N_DOCS)} lists")
    budget = max(TOP_K * 20, -(-N_DOCS * 5 // 100))  # the engine's default ann_percent

    # b = 1: the single-query pre-filter and the gathered scan
    q1 = index_queries(seed + 91, 8, corpus)
    got = [db.query(q, top_k=TOP_K) for q in q1]
    ids = np.array([[r[2] for r in row] for row in got])
    vals = np.array([[r[1] for r in row] for row in got], dtype=np.float32)
    cands = [index.probe(q, budget) for q in q1]
    swaps, err = check_over_candidates("F1 query", plane, q1, cands, ids, vals)
    if list(ids[0, :2]) != [4, 17]:
        raise AssertionError(f"F1: duplicate rows 4/17 not first in lower-id order: {ids[0, :2]}")
    one = q1[1]

    def single():
        db.clear_cache()
        return db.query(one, top_k=TOP_K)

    ms = wall_ms(single, 5)
    flat, db.ann_index = db.ann_index, FlatIndex(db.ann_metric, DIM)
    ms_exact = wall_ms(single, 5)
    db.ann_index = flat
    log(f"path F1 ivf query b=1: {len(q1)} queries exact over their probed candidates "
        f"({swaps} tied swaps, score err {err:.3g}, tol {ATOL}; {cands[1].size} candidates of "
        f"budget {budget}); ms/query={ms:.3f} against the exact scan {ms_exact:.3f} [{card}]")

    for b in (64, 512):
        q = index_queries(seed + 92 + b, b, corpus)
        CONFIG.batch_ivf_min_rows = N_DOCS
        zero_launches(G)
        ids, vals = db.query_batch_arrays(q, top_k=TOP_K)
        if any(G.LAUNCHES.values()):
            raise AssertionError(f"F1 b={b}: the IVF route launched a kernel: {G.LAUNCHES}")
        t = time.perf_counter()
        cand_ids, valid = index.probe_batch(q, budget)
        probe_ms = (time.perf_counter() - t) * 1e3
        checked = range(0, b, b // 16)
        swaps, err = check_over_candidates(
            f"F1 b={b}", plane, q[list(checked)], [cand_ids[valid[i]] for i in checked],
            ids[list(checked)], vals[list(checked)],
        )
        exact = cosine_reference(plane, N_DOCS, q, TOP_K).ids.cpu().numpy()
        recall = recall_at_k(ids, exact)
        if recall < IVF_RECALL_FLOOR:
            raise AssertionError(f"F1 b={b}: recall@{TOP_K} {recall:.4f} < {IVF_RECALL_FLOOR}")
        wall = run_batch(db, q, f"path F1 ivf b={b}", card)
        CONFIG.batch_ivf_min_rows = 1 << 62
        wall_exact = run_batch(db, q, f"path F1 exact scan, same DB, b={b}", card)
        log(f"path F1 ivf b={b}: {len(checked)} checked queries exact over their probed "
            f"candidates ({swaps} tied swaps, score err {err:.3g}); union of probed clusters "
            f"U={cand_ids.size} rows ({cand_ids.size / N_DOCS:.3f} of the corpus); recall@{TOP_K} "
            f"against the full exact scan = {recall:.5f}; probe (host) {probe_ms:.1f} ms of "
            f"{wall:.3f}; ivf/exact = {wall / wall_exact:.2f} [{card}]")

    # an incremental add of 1 % more rows joins the clusters: no re-clustering
    centroids, nlist = index.centroids.copy(), index.nlist
    t = time.perf_counter()
    db.add([{"ts": 0.5} for _ in range(len(extra))], vectors=extra)
    add_s = time.perf_counter() - t
    if db.ann_index is not index or index.nlist != nlist or not np.array_equal(index.centroids, centroids):
        raise AssertionError("F1: the 1 % add re-clustered instead of taking add_rows")
    if index.num_rows != N_DOCS + len(extra):
        raise AssertionError(f"F1: the index holds {index.num_rows} rows after the add")
    dv = db._store.device_view(db.source_indices)
    q = index_queries(seed + 95, 4, corpus)
    q[3] = extra[7].astype(np.float32)  # a new row finds itself
    got = [db.query(x, top_k=TOP_K) for x in q]
    ids = np.array([[r[2] for r in row] for row in got])
    vals = np.array([[r[1] for r in row] for row in got], dtype=np.float32)
    budget = max(TOP_K * 20, -(-len(db.documents) * 5 // 100))
    swaps, err = check_over_candidates(
        "F1 after add", dv["rows_norm"], q, [index.probe(x, budget) for x in q], ids, vals
    )
    if ids[3, 0] != N_DOCS + 7:
        raise AssertionError(f"F1: the added row 7 did not find itself: {ids[3, :3]}")
    log(f"path F1 add of {len(extra)} rows: {add_s:.2f} s, add_rows (nlist {nlist}, centroids "
        f"unchanged); answers exact over the probed candidates ({swaps} tied swaps, score err "
        f"{err:.3g}) [{card}]")


def projscan_breakdown(db, q: np.ndarray, wall: float, card: str) -> None:
    """Device time of each projscan stage of one batch (the functions the
    route calls, on the same inputs) beside its host-clock time."""
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.index import projscan as P
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.ops.quantized import _quantize_device
    from hyperdb_tpu_torch.ops.ranking import exact_top_k

    index = db.ann_index
    dv = db._store.device_view(db.source_indices)
    n, b, k = dv["n_pad"], q.shape[0], 16
    qn = np.linalg.norm(q, axis=1, keepdims=True)
    qt = torch.from_numpy((q / qn).astype(np.float32)).cuda()
    G_ = min(n // G.GROUP, max(k, -(-CONFIG.projscan_overfetch // G.GROUP)))
    qa_i8, qa_sc = _quantize_device(qt @ index.p_dev)
    extra = G.make_extra(n, dv["row_valid"], None, device=qt.device)
    gm = G.gmax_int8(qa_i8, qa_sc, index.a_i8, index.a_scales, extra)
    gidx = exact_top_k(gm, G_)[1]
    parts = {
        "A_project_quantize": cuda_ms(lambda: _quantize_device(qt @ index.p_dev), 3, 1),
        "A_gmax_int8": cuda_ms(lambda: G.gmax_int8(qa_i8, qa_sc, index.a_i8, index.a_scales, extra), 3, 1),
        "A_select": cuda_ms(lambda: exact_top_k(gm, G_), 3, 1),
        "B_gather_rescore_topk": cuda_ms(
            lambda: P._stage_b(qt, dv["rowsn_q"], dv["rown_scales"], gidx, k, G.GROUP,
                               dv["row_valid"], None), 3, 1),
    }
    log_breakdown(f"projscan cosine b={b} (G={G_} groups of {G.GROUP})", parts, wall, card)


def phase_kernel_int8_projscan(index, seed: int, card: str) -> dict:
    """``gmax_int8`` at projscan's stage-A shape, (1024, 2^20, 128) on the
    index's own projected plane, with a masked group, masked rows, recency
    and zero-scale rows: EQUAL to its plain version, timed beside its bound
    and ``torch._int_mm`` + rescale + ``amax``."""
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.ops.quantized import _quantize_device

    n_pad, dp = index.a_i8.shape
    b = 1024
    v = index.a_i8.clone()
    vs = index.a_scales.clone()
    for rows in (slice(5, 6), slice(640, 768)):
        v[rows] = 0
        vs[rows] = 0
    extra = kernel_masks(n_pad, N_DOCS, seed + 96, recency=True)
    q = torch.from_numpy(np.random.default_rng(seed + 97).standard_normal((b, DIM), dtype=np.float32)).cuda()
    q_i8, q_scale = _quantize_device((q / q.norm(dim=1, keepdim=True)) @ index.p_dev)
    got = G.gmax_int8(q_i8, q_scale, v, vs, extra)
    torch.cuda.synchronize()
    want = G.gmax_int8_plain(q_i8, q_scale, v, vs, extra)
    err = max_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"gmax_int8 at d'={dp} differs from its plain version (max abs {err:.3g})")
    if not torch.isneginf(got[:, 1]).all():
        raise AssertionError("gmax_int8 at projscan depth: the masked group is off")

    lib = None
    if hasattr(torch, "_int_mm"):
        def lib():
            s = torch._int_mm(q_i8, v.T).float() * (q_scale[:, None] * vs[None, :]) + extra
            return s.view(b, n_pad // G.GROUP, G.GROUP).amax(-1)

        try:  # the yardstick only: the port never calls it
            lib()
        except RuntimeError as e:
            log(f"library call torch._int_mm not usable here ({str(e).splitlines()[0]})")
            lib = None
    ms = cuda_ms(lambda: G.gmax_int8(q_i8, q_scale, v, vs, extra), reps=20)
    plain_ms = cuda_ms(lambda: G.gmax_int8_plain(q_i8, q_scale, v, vs, extra), reps=5, warmup=1)
    lib_ms = None if lib is None else cuda_ms(lib, reps=5, warmup=1)
    bound_ms, bound_by = scan_bound_ms(b, n_pad, dp, n_pad // G.GROUP, "int8")
    lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"kernel gmax_int8 at projscan depth: b={b} n={n_pad} d'={dp} max_abs_err={err:.3g} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_txt} bound_ms={bound_ms:.4f} "
        f"({bound_by}) bound/ms={bound_ms / ms:.3f} [{card}]")
    del v, vs
    return {"b": b, "n": n_pad, "d": dp, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def path_projscan(db, corpus, kernels, seed: int, card: str) -> None:
    """F2: the projscan index on an int8-pure DB through
    ``query_batch_arrays`` at b = 1024 and 4096: ``gmax_int8`` launched
    once per batch on the ``wgmma`` variant, ids and scores identical to
    the same route with stage A's plain version."""
    from hyperdb_tpu_torch.index.projscan import ProjScanIndex
    from hyperdb_tpu_torch.ops import gmax as G

    index = db.ann_index
    if not isinstance(index, ProjScanIndex) or index.d_prime != 128:
        raise AssertionError(f"F2: expected a projscan index at d'=128, got {index}")
    dv = db._store.device_view(db.source_indices)
    kernels["gmax_int8"]["at_projscan_depth"] = phase_kernel_int8_projscan(index, seed, card)

    for b in (1024, 4096):
        q = index_queries(seed + 98 + b, b, corpus)
        zero_launches(G)
        ids, vals = db.query_batch_arrays(q, top_k=TOP_K)
        launches = dict(G.LAUNCHES)
        by_variant = check_variant(G, f"projscan b={b}")
        if launches != {**{name: 0 for name in launches}, "gmax_int8": 1}:
            raise AssertionError(f"F2 b={b}: expected gmax_int8 once, launched {launches}")
        kernels["gmax_int8"]["launches"] += 1
        kernel_fn = G.gmax_int8
        G.gmax_int8 = G.gmax_int8_plain  # the same route with the plain stage A
        try:
            ids_p, vals_p = db.query_batch_arrays(q, top_k=TOP_K)
        finally:
            G.gmax_int8 = kernel_fn
        if G.LAUNCHES != launches:
            raise AssertionError("F2: the plain stage A launched a kernel")
        if not (np.array_equal(ids, ids_p) and np.array_equal(vals, vals_p)):
            raise AssertionError(f"F2 b={b}: the kernel route and the plain stage A disagree")
        m = min(b, 1024)
        exact = int8_reference(dv, q[:m], TOP_K)
        recall = recall_at_k(ids[:m], exact.ids.cpu().numpy())
        if b == 1024 and list(ids[0, :2]) != [4, 17]:
            raise AssertionError(f"F2: duplicate rows 4/17 not first in lower-id order: {ids[0, :2]}")
        log(f"path F2 projscan b={b}: launches {json.dumps(launches)} by variant "
            f"{json.dumps(by_variant)}; ids and scores identical to the plain stage A; "
            f"recall@{TOP_K} against the int8-pure exact scan of the same planes "
            f"(first {m} queries) = {recall:.5f}")
        wall = run_batch(db, q, f"path F2 projscan b={b}", card)
        projscan_breakdown(db, q, wall, card)
        flat, db.ann_index = db.ann_index, None
        run_batch(db, q, f"path F2 exact int8-pure scan, same DB, b={b}", card)
        db.ann_index = flat


def phase_index_files(db, q: np.ndarray, name: str, card: str, **make_kw) -> None:
    """F3: a checkpoint round trip into a fresh DB on the card: the index
    state comes back equal and the answers bit-identical."""
    import shutil
    from pathlib import Path

    from hyperdb_tpu_torch import HyperDB

    out = Path(__file__).resolve().parent / "build" / "smoke_persist"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        ids, vals = db.query_batch_arrays(q, top_k=TOP_K)
        t = time.perf_counter()
        db.save(str(out / f"{name}.ckpt"), format="checkpoint")
        save_s = time.perf_counter() - t
        fresh = HyperDB(device="cuda", **make_kw)
        t = time.perf_counter()
        fresh.load(str(out / f"{name}.ckpt"), format="checkpoint")
        load_s = time.perf_counter() - t
        want, got = db.ann_index.state(), fresh.ann_index.state()
        for key, value in want.items():
            if not np.array_equal(np.asarray(got[key]), np.asarray(value)):
                raise AssertionError(f"F3 {name}: index state '{key}' differs after the round trip")
        got_ids, got_vals = fresh.query_batch_arrays(q, top_k=TOP_K)
        if not (np.array_equal(got_ids, ids) and np.array_equal(got_vals, vals)):
            raise AssertionError(f"F3 {name}: answers after the round trip differ")
        log(f"path F3 {name} checkpoint: save {save_s:.2f} s, load {load_s:.2f} s; index state "
            f"({', '.join(sorted(k for k in want if k != 'kind'))}) equal, b={q.shape[0]} ids and "
            f"scores bit-identical [{card}]")
        del fresh
    finally:
        shutil.rmtree(out, ignore_errors=True)


def ivf_build_cost(index, plane, card: str) -> None:
    """F1: what the build's f64 assignment logits and exact fixed-point
    centroid sums cost at this size, beside the same steps with f32 logits
    and f32 ``index_add_`` sums (timed here only): one full assignment pass
    over the N rows, one over the training sample, one centroid update."""
    from hyperdb_tpu_torch.index import ivf as IVF

    cent = torch.from_numpy(index.centroids).to(plane.device)
    rows = plane[:N_DOCS]
    train = rows[: IVF._TRAIN_SAMPLE].float()
    assign = IVF._assign(train, cent)
    half = 0.5 * (cent * cent).sum(1)
    step = (1 << 28) // cent.shape[0]

    def assign_f32(x):
        return torch.cat([torch.argmax(x[a : a + step].float() @ cent.T - half, dim=1)
                          for a in range(0, x.shape[0], step)])

    def mean_f32():
        sums = torch.zeros_like(cent).index_add_(0, assign, train)
        counts = torch.zeros(cent.shape[0], device=cent.device).index_add_(
            0, assign, torch.ones(train.shape[0], device=cent.device))
        return sums / counts.clamp(min=1)[:, None]

    ms = {
        "full f64": cuda_ms(lambda: IVF._assign(rows, cent), reps=3, warmup=1),
        "full f32": cuda_ms(lambda: assign_f32(rows), reps=3, warmup=1),
        "sample f64": cuda_ms(lambda: IVF._assign(train, cent), reps=3, warmup=1),
        "sample f32": cuda_ms(lambda: assign_f32(train), reps=3, warmup=1),
        "sums exact": cuda_ms(lambda: IVF._segment_mean(train, assign, cent), reps=3, warmup=1),
        "sums f32": cuda_ms(mean_f32, reps=3, warmup=1),
    }
    iters = IVF._KMEANS_ITERS
    shipped = iters * (ms["sample f64"] + ms["sums exact"]) + ms["full f64"]
    f32 = iters * (ms["sample f32"] + ms["sums f32"]) + ms["full f32"]
    log(f"path F1 ivf build steps at {N_DOCS} x {DIM}, nlist {index.nlist}, sample "
        f"{train.shape[0]} (device ms): full assignment pass f64 {ms['full f64']:.3f} (f32 "
        f"{ms['full f32']:.3f}); sample pass f64 {ms['sample f64']:.3f} (f32 {ms['sample f32']:.3f}); "
        f"centroid update exact {ms['sums exact']:.3f} (f32 index_add_ {ms['sums f32']:.3f}); "
        f"{iters} iterations + the full pass {shipped:.1f} ms against {f32:.1f} [{card}]")
    del cent, rows, train, assign


def path_indexes(docs, kernels, seed: int, card: str) -> None:
    """Path F: the IVF and projscan indexes at 1M x 384 on the card."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.core import db as DB
    from hyperdb_tpu_torch.index.projscan import fit_projection

    t = time.perf_counter()
    corpus = make_spectral_corpus(seed, N_DOCS + N_DOCS // 100)
    corpus, extra = corpus[:N_DOCS], corpus[N_DOCS:]  # extra: F1's 1 % add
    sample = corpus[:: max(1, N_DOCS // 65536)].astype(np.float32)
    sample /= np.linalg.norm(sample, axis=1, keepdims=True)
    _, captured = fit_projection(sample, 128)
    log(f"path F corpus: {corpus.shape} {corpus.dtype}, {F_CENTRES} centres with scales "
        f"(j+1)^-0.5 under a seeded rotation, noise {F_NOISE}; top-128 directions keep "
        f"{captured:.4f} of the unit rows' variance; {time.perf_counter() - t:.1f} s")
    if captured < 0.6:
        raise AssertionError(f"path F corpus keeps only {captured:.3f} of its variance at d'=128")

    # F1: IVF on a float16 DB
    threshold = DB.IVF_THRESHOLD
    DB.IVF_THRESHOLD = N_DOCS
    try:
        t = time.perf_counter()
        db = HyperDB(documents=docs, vectors=corpus, fp_precision="float16")
        torch.cuda.synchronize()
        log(f"path F1 ivf db build: {time.perf_counter() - t:.1f} s, nlist {db.ann_index.nlist}, "
            f"{db.ann_index.num_rows} rows [{card}]")
    finally:
        DB.IVF_THRESHOLD = threshold
    plane = db._store.device_view(db.source_indices)["rows_norm"]
    ivf_build_cost(db.ann_index, plane, card)
    try:
        path_ivf(db, corpus, extra, plane, seed, card)
        CONFIG.batch_ivf_min_rows = N_DOCS
        phase_index_files(db, index_queries(seed + 99, 512, corpus), "ivf", card)
    finally:
        CONFIG.batch_ivf_min_rows = 1 << 62
    del db, plane
    torch.cuda.empty_cache()

    # F2: projscan on an int8-pure DB
    threshold = CONFIG.projscan_threshold
    CONFIG.projscan_threshold = N_DOCS
    try:
        t = time.perf_counter()
        db = HyperDB(documents=docs, vectors=corpus, fp_precision="float16",
                     device_precision="int8-pure")
        torch.cuda.synchronize()
        index = db.ann_index
        log(f"path F2 projscan db build: {time.perf_counter() - t:.1f} s, d'={index.d_prime}, "
            f"captured variance {index.captured_variance:.4f}, projected plane "
            f"{tuple(index.a_i8.shape)} int8 + scales = "
            f"{(index.a_i8.numel() + 4 * index.a_scales.numel()) / 2**20:.1f} MiB [{card}]")
    finally:
        CONFIG.projscan_threshold = threshold
    path_projscan(db, corpus, kernels, seed, card)
    phase_index_files(db, index_queries(seed + 100, 1024, corpus), "projscan", card,
                      device_precision="int8-pure")
    del db, corpus, extra
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
        ("euclidean_metric", "euclidean", "rows", ATOL),
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
    euclidean_cost(db, q, dv, card)
    del db, dv
    torch.cuda.empty_cache()


def euclidean_f32(q, v):
    """The plain euclidean score as the port computed it before the float64
    expansion: |v|^2 - 2 q.v + |q|^2 in f32 (kept here to time beside it)."""
    q32, v32 = q.float(), v.float()
    d2 = (v32 * v32).sum(-1)[None, :] - 2.0 * (q32 @ v32.T) + (q32 * q32).sum(-1)[:, None]
    return 1.0 / (1.0 + torch.sqrt(torch.clamp(d2, min=0.0)))


def euclidean_cost(db, q: np.ndarray, dv, card: str) -> None:
    """What the plain routes' float64 euclidean expansion
    (``ops/metrics.euclidean_scores``) costs beside the f32 one, on the same
    inputs, in the order f64, f32, f32, f64: the chunked doc-level branch
    through the entry point at b = 64 (host clock), and the plain scan
    ``ranking.rank_top_k`` over the 2^20-row plane at b = 64 (device
    clock). Also prints both formulas' score of the planted copy of row 4."""
    from hyperdb_tpu_torch.ops import metrics as M
    from hyperdb_tpu_torch.ops import ranking as R

    f64 = M._METRIC_FNS["euclidean_metric"]
    rows, qt = dv["rows"], torch.from_numpy(q).cuda()
    chunked, plain = {"f64": [], "f32": []}, {"f64": [], "f32": []}
    try:
        for name, fn in (("f64", f64), ("f32", euclidean_f32), ("f32", euclidean_f32), ("f64", f64)):
            M._METRIC_FNS["euclidean_metric"] = fn
            chunked[name].append(wall_ms(
                lambda: db.query_batch_arrays(q, top_k=TOP_K, metric="euclidean_metric"), 5
            ))
            plain[name].append(cuda_ms(
                lambda: R.rank_top_k(qt, rows, TOP_K, metric="euclidean_metric"), reps=5
            ))
    finally:
        M._METRIC_FNS["euclidean_metric"] = f64
    planted = {name: float(fn(qt[:1], rows[4:5])[0, 0]) for name, fn in (("f64", f64), ("f32", euclidean_f32))}
    exact = float(1.0 / (1.0 + torch.linalg.norm(qt[0].double() - rows[4].double())))
    log(f"euclidean cost, f64 expansion / f32 expansion ({rows.shape[0]} rows): chunked b=64 "
        f"ms/batch {chunked['f64']} / {chunked['f32']}; plain rank_top_k b=64 device ms "
        f"{plain['f64']} / {plain['f32']}; planted row 4 score {planted['f64']:.8f} / "
        f"{planted['f32']:.8f}, f64 difference form {exact:.8f} [{card}]")


# ---------------------------------------------------------------- path E: text


def vocab_words() -> list[str]:
    """The whole-word (alphabetic, not ``##``-continued) tokens of the
    in-repo encoder's WordPiece vocab, in vocab order."""
    from hyperdb_tpu_torch.models.minilm import ASSETS_DIR

    with open(f"{ASSETS_DIR}/vocab.txt", encoding="utf-8") as f:
        return [w for w in (line.rstrip("\n") for line in f) if w.isalpha()]


def zipf_texts(rng, words: list[str], n: int, lo: int, hi: int) -> list[str]:
    """``n`` texts of ``lo``-``hi`` words drawn from ``words`` by a Zipf law
    (rank r with weight 1/r)."""
    p = 1.0 / np.arange(1, len(words) + 1)
    lens = rng.integers(lo, hi + 1, n)
    draws = rng.choice(len(words), size=int(lens.sum()), p=p / p.sum())
    bounds = np.concatenate([[0], np.cumsum(lens)])
    w = np.asarray(words, dtype=object)
    return [" ".join(w[draws[a:b]]) for a, b in zip(bounds[:-1], bounds[1:])]


def text_documents(rng, words, n: int) -> list[dict]:
    """Demo-shaped documents: a name and an info dict with a type and a
    20-120-word description, short enough that none chunks."""
    kinds = ("fire", "water", "grass", "psychic", "ghost", "dragon", "steel", "fairy")
    return [
        {"name": f"item{i}", "info": {"type": kinds[i % len(kinds)], "description": d}}
        for i, d in enumerate(zipf_texts(rng, words, n, 20, 120))
    ]


def encoder_bound_ms(tokens: int, seq: int, cfg) -> tuple[float, str]:
    """Least time of one encoder forward over ``tokens`` (padded) tokens of
    sequences of ``seq``: its multiply-adds (per token and layer, the four
    h x h and two h x i products and the two attention products of S x h)
    over the bf16 tensor-core rate; its bytes (weights read once) are far
    below that."""
    h, i, layers = cfg.hidden, cfg.intermediate, cfg.layers
    flops = 2.0 * tokens * layers * (4 * h * h + 2 * h * i + 2 * seq * h)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (2.0 * 12e6 + 8.0 * tokens) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def enc_diff(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(largest element difference, smallest row cosine) of two blocks of
    unit rows."""
    return float(np.abs(got - want).max()), float((got * want).sum(axis=1).min())


def phase_encoder(enc, words, seed: int, card: str) -> None:
    """E1: the local-384 encoder on the card against the same encoder on
    the CPU, at both settings of cuBLAS's reduced-precision bf16 reduction,
    and a 512-text forward timed beside its bound."""
    from hyperdb_tpu_torch.models.minilm import MiniLMEmbedder

    rng = np.random.default_rng(seed + 80)
    texts = zipf_texts(rng, words, ENC_TEXTS, 8, 60)
    cpu_enc = MiniLMEmbedder.from_local_assets(device="cpu")
    t = time.perf_counter()
    want = cpu_enc.encode(texts)
    cpu_s = time.perf_counter() - t
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    diffs = {}
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = setting
            diffs[setting] = enc_diff(enc.encode(texts), want)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    for setting, (max_abs, min_cos) in diffs.items():
        log(f"path E encoder card vs CPU on {len(texts)} texts, bf16 reduced-precision "
            f"reduction {setting}: max abs {max_abs:.3g} (limit {ENC_MAX_ABS}), min cosine "
            f"{min_cos:.7f} (limit {ENC_MIN_COS})")
    max_abs, min_cos = diffs[flag]
    if not (max_abs <= ENC_MAX_ABS and min_cos >= ENC_MIN_COS):
        raise AssertionError(f"encoder on the card off the CPU: {max_abs:.3g} / {min_cos:.6f}")
    log(f"path E encoder on the CPU: {cpu_s:.1f} s for {len(texts)} texts")

    batch = texts[:512]
    reps = 5
    t = time.perf_counter()
    for _ in range(reps):
        ids, mask = enc._prep_batch(batch)
    tok_ms = (time.perf_counter() - t) / reps * 1e3
    fwd_ms = cuda_ms(lambda: enc._forward(ids, mask), reps=10)
    bound, by = encoder_bound_ms(ids.size, ids.shape[1], enc.config)
    log(f"path E encoder forward b=512 seq={ids.shape[1]} ({ids.size} tokens, "
        f"{int(mask.sum())} live): ms={fwd_ms:.4f} bound_ms={bound:.4f} ({by}) "
        f"bound/ms={bound / fwd_ms:.3f}; tokenise (host) {tok_ms:.3f} ms [{card}]")


def timed(fn, acc: dict, key: str, sync: bool = False):
    def run(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t
        return out

    return run


def phase_ingest(enc, docs, card: str):
    """E2: build a float16 text DB through ``make_embedding_function`` over
    the card's encoder; docs/s split into tokenise (chunker and encoder
    tokenizer, host), encode (device forward) and commit."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.models.embedder import make_embedding_function

    ef = make_embedding_function(enc, enc.chunk_tokenizer)
    acc = {"embed": 0.0, "prep": 0.0, "forward": 0.0}
    timed_ef = timed(ef, acc, "embed")
    timed_ef.embedder, timed_ef.tokenizer = ef.embedder, ef.tokenizer
    enc._prep_batch = timed(enc._prep_batch, acc, "prep")
    enc._forward = timed(enc._forward, acc, "forward", sync=True)
    try:
        t = time.perf_counter()
        db = HyperDB(docs, embedding_function=timed_ef, fp_precision="float16")
        total = time.perf_counter() - t
    finally:
        del enc._prep_batch, enc._forward  # the class's methods again
    db.embedding_function = ef
    n = len(docs)
    if db.size() != n or db.size(with_chunks=True) != n or db.split_info != dict.fromkeys(range(n), 1):
        raise AssertionError("text ingest: a document chunked or went missing")
    tokenise = acc["embed"] - acc["forward"]
    commit = total - acc["embed"]
    log(f"path E ingest: {n} documents in {total:.2f} s = {n / total:.1f} docs/s; tokenise "
        f"{tokenise:.2f} s (chunker {acc['embed'] - acc['prep'] - acc['forward']:.2f}, encoder "
        f"tokenizer {acc['prep']:.2f}), encode {acc['forward']:.2f} s, commit {commit:.2f} s [{card}]")
    return db


def text_stage_parts(db, texts: list[str]) -> tuple[dict, np.ndarray]:
    """Host tokenise ms (chunker + encoder tokenizer) and device encode ms
    of one device-path text batch, and its query block on the host."""
    from hyperdb_tpu_torch.query import engine as E

    enc, prepare = E._default_embed_path(db)
    t = time.perf_counter()
    chunks, _, _ = prepare(list(texts))
    prepped = [enc._prep_batch(chunks[i : i + enc._MAX_BATCH])
               for i in range(0, len(chunks), enc._MAX_BATCH)]
    tok_ms = (time.perf_counter() - t) * 1e3
    enc_ms = sum(cuda_ms(lambda p=p: enc._forward(*p), 3, 1) for p in prepped)
    block = E.generate_query_vectors_batch_device(db, list(texts))
    return {"tokenise(host)": tok_ms, "encode": enc_ms}, block[: len(texts)].cpu().numpy()


def phase_text_queries(db, words, kernels, seed: int, card: str):
    """E3: text batches of 8-16 words over the text DB: b = 512 and 4096
    through the device block (``gmax_f_sub``, wgmma variant), b = 512
    through the host path, b = 1 through ``query``. Returns the b = 512
    block with its ids and scores, for the persistence phase."""
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.query import engine as E

    rng = np.random.default_rng(seed + 90)
    q512, q4k = zipf_texts(rng, words, 512, 8, 16), zipf_texts(rng, words, 4096, 8, 16)
    dv = db._store.device_view(db.source_indices)
    plane, n = dv["rows_norm"], db.size()
    zero_launches(G)
    block = E.generate_query_vectors_batch_device(db, q512)
    ids, vals = db.query_batch_arrays(block, top_k=TOP_K, n_valid=512)
    block4k = E.generate_query_vectors_batch_device(db, q4k)
    ids4k, vals4k = db.query_batch_arrays(block4k, top_k=TOP_K, n_valid=4096)
    launches = dict(G.LAUNCHES)
    by_variant = check_variant(G, "path E")
    log(f"path E text launches: {json.dumps(launches)} by variant: {json.dumps(by_variant)}")
    if launches["gmax_f_sub"] < 2 or by_variant["wgmma"] < 2:
        raise AssertionError("path E: the text batches did not launch gmax_f_sub (wgmma) twice")
    kernels["gmax_f_sub"]["launches"] += launches["gmax_f_sub"]
    if block.shape != (512, DIM) or block4k.shape != (4096, DIM) or block.device != dv["row_valid"].device:
        raise AssertionError("path E: query blocks of the wrong shape or device")
    q_host = block.cpu().numpy()
    swaps, err = check_ids("text b=512", ids, vals, plane, n, q_host, TOP_K)
    log(f"path E text b=512 (device block): ids tie-aware equal to the reference "
        f"({swaps} tied swaps, score err {err:.3g})")
    swaps, err = check_ids("text b=4096", ids4k[:512], vals4k[:512], plane, n,
                           block4k[:512].cpu().numpy(), TOP_K)
    log(f"path E text b=4096 (device block): first 512 ids tie-aware equal ({swaps} tied swaps, "
        f"score err {err:.3g})")

    hq = E.generate_query_vectors_batch(db, q512)
    hids, hvals = db.query_batch_arrays(hq, top_k=TOP_K)
    if not (np.array_equal(hq, q_host) and np.array_equal(hids, ids) and np.array_equal(hvals, vals)):
        raise AssertionError("path E: the host text path and the device block disagree")
    log("path E text b=512 (host path): embeddings, ids and scores identical to the device block")
    one = db.query(q512[7], top_k=TOP_K)
    q1 = E.generate_query_vectors_batch(db, [q512[7]])
    swaps, err = check_ids("text b=1", np.array([[r[2] for r in one]]),
                           np.array([[r[1] for r in one]], dtype=np.float32), plane, n, q1, TOP_K)
    log(f"path E text b=1 (query): ids tie-aware equal ({swaps} tied swaps, score err {err:.3g})")

    for texts in (q512, q4k):
        b = len(texts)
        wall = wall_ms(lambda: db.query_batch_arrays(
            E.generate_query_vectors_batch_device(db, texts), top_k=TOP_K, n_valid=b), 5 if b <= 512 else 2)
        log(f"path E text device block: b={b} ms/batch={wall:.3f} q/s={b / wall * 1e3:.1f} [{card}]")
        parts, qh = text_stage_parts(db, texts)
        stage_breakdown(db, qh, wall, card, label="text device block", extra_parts=parts)
    wall = wall_ms(lambda: db.query_batch_arrays(
        E.generate_query_vectors_batch(db, q512), top_k=TOP_K), 5)
    log(f"path E text host path: b=512 ms/batch={wall:.3f} q/s={512 / wall * 1e3:.1f} [{card}]")
    parts, qh = text_stage_parts(db, q512)
    stage_breakdown(db, qh, wall, card, label="text host path", extra_parts=parts)

    def single():
        db.clear_cache()  # the LRU would answer a repeated query
        return db.query(q512[7], top_k=TOP_K)

    wall = wall_ms(single, 5)
    parts, _ = text_stage_parts(db, [q512[7]])
    log(f"path E text query: b=1 ms={wall:.3f} (tokenise {parts['tokenise(host)']:.3f}, encode "
        f"{parts['encode']:.3f}) [{card}]")
    return block, ids, vals


def phase_tokenise(enc, docs, words, seed: int, card: str) -> None:
    """E6: the encoder's host tokenisation (``_prep_batch``) of 512 texts
    with the C++ WordPiece on ASCII texts (the JAX package's rule) against
    the Python path for all, on path E's query texts and documents and on
    copies of them without their non-ASCII words; the ids must be equal."""
    from hyperdb_tpu_torch.core.chunker import document_text

    tok = enc._tokenizer
    sets = {
        "queries": zipf_texts(np.random.default_rng(seed + 90), words, 512, 8, 16),
        "documents": [document_text(d) for d in docs[:512]],
    }
    for name in list(sets):
        sets[f"{name} (ASCII words only)"] = [
            " ".join(w for w in t.split() if w.isascii()) for t in sets[name]]
    for name, texts in sets.items():
        times, ids = {}, {}
        for path in ("C++", "Python"):
            if path == "Python":
                tok.text_ids = tok._python_text_ids  # every text through Python
            try:
                ids[path] = enc._prep_batch(texts)[0]  # warms the word caches
                times[path] = wall_ms(lambda: enc._prep_batch(texts), 5)
            finally:
                if path == "Python":
                    del tok.text_ids
        if not np.array_equal(ids["C++"], ids["Python"]):
            raise AssertionError(f"path E tokenise {name}: C++ and Python ids differ")
        ascii_share = float(np.mean([t.isascii() for t in texts]))
        log(f"path E tokenise {name}: b=512, {ascii_share:.3f} of the texts ASCII (C++); encoder "
            f"tokenizer {times['C++']:.3f} ms, all in Python {times['Python']:.3f} ms; ids "
            f"identical [{card}]")


def phase_default_embedder(docs, words, seed: int, card: str) -> None:
    """E4: the default embedder (HYPERDB_DEFAULT_EMBEDDER unset: the hybrid
    of the local encoder and the 4096-d lexical hash, 4480-d) on the card,
    over 16384 documents; a b = 512 text batch on the plain route."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.query import engine as E

    from hyperdb_tpu_torch.models.embedder import default_embedder

    if "HYPERDB_DEFAULT_EMBEDDER" in os.environ:
        raise AssertionError("HYPERDB_DEFAULT_EMBEDDER is set: path E4 needs the default")
    t = time.perf_counter()
    emb = default_embedder(None, device="cuda")  # the instance the DB below gets (cached)
    resolve = time.perf_counter() - t
    acc = {"dense": 0.0, "lexical": 0.0}
    emb.dense.encode = timed(emb.dense.encode, acc, "dense")
    emb.lexical.encode = timed(emb.lexical.encode, acc, "lexical")
    try:
        t = time.perf_counter()
        db = HyperDB(docs[:DEFAULT_EMB_DOCS], fp_precision="float16")
        build = time.perf_counter() - t
    finally:
        del emb.dense.encode, emb.lexical.encode
    if db._embedder() is not emb or type(emb).__name__ != "HybridEmbedder" or db.dim != 384 + 4096:
        raise AssertionError(f"default embedder: {type(emb).__name__}, dim {db.dim}")
    log(f"path E default embedder: {type(emb).__name__} ({db.dim}-d, dense part on "
        f"{emb.dense.device}), resolved in {resolve:.2f} s; {DEFAULT_EMB_DOCS} documents in "
        f"{build:.2f} s = {DEFAULT_EMB_DOCS / build:.1f} docs/s: dense (tokenise + encode) "
        f"{acc['dense']:.2f} s, lexical hash (host) {acc['lexical']:.2f} s, rest "
        f"{build - acc['dense'] - acc['lexical']:.2f} s [{card}]")
    texts = zipf_texts(np.random.default_rng(seed + 95), words, 512, 8, 16)
    if E.generate_query_vectors_batch_device(db, texts) is not None:
        raise AssertionError("the hybrid embedder kept a block on the device")
    zero_launches(G)
    q = E.generate_query_vectors_batch(db, texts)
    ids, vals = db.query_batch_arrays(q, top_k=TOP_K)
    if any(G.LAUNCHES.values()):
        raise AssertionError(f"path E default embedder launched a kernel: {G.LAUNCHES}")
    plane = db._store.device_view(db.source_indices)["rows_norm"]
    swaps, err = check_ids("hybrid b=512", ids, vals, plane, db.size(), q, TOP_K)
    log(f"path E hybrid b=512 (plain route, no launch): ids tie-aware equal ({swaps} tied swaps, "
        f"score err {err:.3g})")
    embed = wall_ms(lambda: E.generate_query_vectors_batch(db, texts), 3)
    scan = wall_ms(lambda: db.query_batch_arrays(q, top_k=TOP_K), 5)
    log(f"path E hybrid text batch: b=512 ms/batch={embed + scan:.3f} (embed on host and card "
        f"{embed:.3f}, scan {scan:.3f}) [{card}]")
    del db
    torch.cuda.empty_cache()


def phase_persistence(db, block, ids, vals, card: str) -> None:
    """E5: the text DB saved as a checkpoint and as .pickle.gz, each loaded
    into a fresh DB on the card: the b = 512 block's ids and scores must
    equal the pre-save ones bit for bit."""
    import shutil
    from pathlib import Path

    from hyperdb_tpu_torch import HyperDB

    out = Path(__file__).resolve().parent / "build" / "smoke_persist"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        cases = (
            ("checkpoint", out / "text.ckpt", {"format": "checkpoint"}, {},
             {"format": "checkpoint", "preload_ann_into_memory": True}),
            ("pickle.gz", out / "text.pickle.gz", {}, {"fp_precision": "float16"}, {}),
        )
        for name, path, save_kw, make_kw, load_kw in cases:
            t = time.perf_counter()
            db.save(str(path), **save_kw)
            save_s = time.perf_counter() - t
            files = path.rglob("*") if path.is_dir() else out.glob(path.name + "*")  # + .ann
            size = sum(f.stat().st_size for f in files if f.is_file())
            fresh = HyperDB(device="cuda", **make_kw)
            t = time.perf_counter()
            fresh.load(str(path), **load_kw)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            got_ids, got_vals = fresh.query_batch_arrays(block, top_k=TOP_K, n_valid=512)
            if not (np.array_equal(got_ids, ids) and np.array_equal(got_vals, vals)):
                raise AssertionError(f"path E {name}: answers after the round trip differ")
            if fresh.documents != db.documents or fresh.split_info != db.split_info:
                raise AssertionError(f"path E {name}: state differs after the round trip")
            log(f"path E persistence {name}: save {save_s:.2f} s, load {load_s:.2f} s, "
                f"{size / 2**20:.1f} MiB; b=512 ids and scores bit-identical [{card}]")
            del fresh
    finally:
        shutil.rmtree(out, ignore_errors=True)


def path_text(kernels, seed: int, card: str) -> None:
    """Path E: the text path and persistence on the card."""
    from hyperdb_tpu_torch.models.minilm import MiniLMEmbedder

    words = vocab_words()
    t = time.perf_counter()
    enc = MiniLMEmbedder.from_local_assets(device="cuda")
    log(f"path E local-384 encoder: {len(words)} whole-word vocab entries; loaded on "
        f"{enc.device} in {time.perf_counter() - t:.2f} s")
    phase_encoder(enc, words, seed, card)
    t = time.perf_counter()
    docs = text_documents(np.random.default_rng(seed + 85), words, TEXT_DOCS)
    log(f"path E documents: {len(docs)} made in {time.perf_counter() - t:.1f} s")
    db = phase_ingest(enc, docs, card)
    block, ids, vals = phase_text_queries(db, words, kernels, seed, card)
    phase_persistence(db, block, ids, vals, card)
    phase_tokenise(enc, docs, words, seed, card)
    text_serve_phase(db, words, kernels, seed, card)  # path G3
    del db, block
    torch.cuda.empty_cache()
    phase_default_embedder(docs, words, seed, card)


# ---------------------------------------------------------------- path G: serving and the CLI


def serve_dir():
    """``build/smoke_serve/``, emptied: payloads, client results, checkpoints."""
    import shutil
    from pathlib import Path

    out = Path(ROOT) / "build" / "smoke_serve"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    return out


def native_stats(srv):
    """A snapshot of the native front end's per-flush accounting."""
    return {"flushes": srv.flushes, "queries": srv.flushed_queries, "engine_s": srv.engine_s,
            "complete_s": srv.complete_s, "idle_s": srv.idle_s, "max_flush": srv.max_flush}


class FlushSpy:
    """Counts the stdlib batcher's engine calls (``db.query_batch``): its
    flushes, their sizes and their time. Installed on the DB instance."""

    def __init__(self, db):
        self.db, self.real = db, db.query_batch
        self.flushes = self.queries = self.max_flush = 0
        self.engine_s = 0.0
        db.query_batch = self

    def __call__(self, q, **kw):
        t = time.perf_counter()
        out = self.real(q, **kw)
        self.engine_s += time.perf_counter() - t
        n = len(out)
        self.flushes += 1
        self.queries += n
        self.max_flush = max(self.max_flush, n)
        return out

    def stats(self):
        return {"flushes": self.flushes, "queries": self.queries, "engine_s": self.engine_s,
                "complete_s": None, "idle_s": None, "max_flush": self.max_flush}

    def remove(self):
        del self.db.query_batch  # the class's method again


def serve_phase(label, port, mode, payloads, conns, depth, work, card, stats, reset,
                unique=False):
    """Drive one front end with ``SERVE_CLIENTS`` load processes
    (``tools/serve_load.py``, each ``conns`` keep-alive connections with
    ``depth`` requests in flight): ``SERVE_WARMUP_S`` of warm-up, then
    ``SERVE_SECONDS`` measured. ``stats()`` snapshots the front end's flush
    accounting; ``reset()`` zeroes its max flush at the window's start.
    Prints one line; returns the merged samples [(client, payload index,
    ids, scores)]. Any failed request or client raises."""
    files = []
    for k, p in enumerate(payloads):
        path = work / f"{label}-{k}.{'json' if mode == 'text' else 'npy'}"
        if mode == "text":
            path.write_text(json.dumps(p))
        else:
            np.save(path, p)
        files.append(path)
    start_at = time.time() + 2.0
    procs = [
        subprocess.Popen([
            sys.executable, LOAD_TOOL, "--port", str(port), "--mode", mode,
            "--payloads", str(f), "--out", str(work / f"{label}-{k}.npz"),
            "--conns", str(conns), "--depth", str(depth), "--warmup", str(SERVE_WARMUP_S),
            "--seconds", str(SERVE_SECONDS), "--start-at", repr(start_at), "--top-k", str(TOP_K),
            "--sample", str(-(-SERVE_SAMPLE // (SERVE_CLIENTS * conns))),
        ] + (["--unique"] if unique else []))
        for k, f in enumerate(files)
    ]
    try:
        time.sleep(max(0.0, start_at + SERVE_WARMUP_S - time.time()))
        reset()
        s0, t0, me0 = stats(), time.perf_counter(), os.times()
        time.sleep(max(0.0, start_at + SERVE_WARMUP_S + SERVE_SECONDS - time.time()))
        s1, t1, me1 = stats(), time.perf_counter(), os.times()
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [np.load(work / f"{label}-{k}.npz") for k in range(len(procs))]
    for k, (rc, r) in enumerate(zip(rcs, results)):
        if rc or int(r["errors"]):
            raise AssertionError(f"path G {label}: client {k} exited {rc} with {int(r['errors'])} "
                                 f"failed requests: {r['first_error']}")
    count = sum(int(r["count"]) for r in results)
    lat = np.concatenate([r["lat_ms"] for r in results])
    if count == 0:
        raise AssertionError(f"path G {label}: no response in the measured window")
    flushes = s1["flushes"] - s0["flushes"]
    queries = s1["queries"] - s0["queries"]
    engine = s1["engine_s"] - s0["engine_s"]
    wall = t1 - t0
    if s0["idle_s"] is None:  # the stdlib front end has no single worker
        idle = f"1 - engine share {1.0 - engine / wall:.4f}"
    else:
        idle = (f"hand-back ms/flush "
                f"{1e3 * (s1['complete_s'] - s0['complete_s']) / max(flushes, 1):.3f}, "
                f"worker idle share {(s1['idle_s'] - s0['idle_s']) / wall:.4f}")
    server_cores = (me1.user + me1.system - me0.user - me0.system) / wall
    client_cores = sum(float(r["cpu_s"]) for r in results) / (SERVE_WARMUP_S + SERVE_SECONDS)
    log(f"path G {label}: q/s={count / SERVE_SECONDS:.1f} p50_ms={np.percentile(lat, 50):.3f} "
        f"p99_ms={np.percentile(lat, 99):.3f} ({len(procs)} clients x {conns} connections x "
        f"{depth} in flight); flushes {flushes}, mean flush {queries / max(flushes, 1):.1f}, "
        f"max flush {s1['max_flush']}, engine ms/flush {1e3 * engine / max(flushes, 1):.3f}, "
        f"{idle} over {wall:.3f} s; CPU: server process {server_cores:.2f} cores, clients "
        f"{client_cores:.2f} cores, of {os.cpu_count()} [{card}]")
    samples = [(k, int(i), ids, sc) for k, r in enumerate(results)
               for i, ids, sc in zip(r["sample_idx"], r["sample_ids"], r["sample_scores"])]
    if len(samples) < SERVE_SAMPLE:
        raise AssertionError(f"path G {label}: {len(samples)} sampled responses, "
                             f"{SERVE_SAMPLE} needed")
    return samples[:SERVE_SAMPLE]


def check_served(label, samples, want_ids, want_vals) -> None:
    """Served ids and scores against ``query_batch_arrays`` on the same
    block: tie-aware (where an id differs, the scores at that rank agree
    within ``SERVE_ATOL``), scores within ``SERVE_ATOL``, no id twice."""
    got_ids = np.stack([s[2] for s in samples])
    got_vals = np.stack([s[3] for s in samples])
    if got_ids.shape != want_ids.shape:
        raise AssertionError(f"path G {label}: served {got_ids.shape}, engine {want_ids.shape}")
    err = float(np.abs(got_vals - want_vals).max())
    if not np.isfinite(got_vals).all() or err > SERVE_ATOL:
        raise AssertionError(f"path G {label}: served scores off the engine's by {err:.3g}")
    srt = np.sort(got_ids, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError(f"path G {label}: a response holds an id twice")
    swaps = int((got_ids != want_ids).sum())
    log(f"path G {label}: {len(samples)} sampled responses tie-aware equal to "
        f"query_batch_arrays on the same block ({swaps} tied swaps, score err {err:.3g})")


def check_endpoints(label, port) -> dict:
    from hyperdb_tpu_torch.client import HyperDBClient

    with HyperDBClient("127.0.0.1", port, timeout=60) as c:
        if c.healthz() != {"ok": True}:
            raise AssertionError(f"path G {label}: /healthz")
        st = c.stats()
    if st.get("documents", 0) <= 0:
        raise AssertionError(f"path G {label}: /stats {st}")
    return st


def vector_samples_block(samples, payloads, f16: bool) -> np.ndarray:
    block = np.stack([payloads[k][i] for k, i, _, _ in samples])
    return block.astype(np.float16) if f16 else block


def path_serving(db, corpus, kernels, seed: int, card: str) -> None:
    """Path G1, G2 and G4 over the main path's DB: the native front end at
    max_batch 1024 and at the CLI default 256, the stdlib front end, and
    the CLI as subprocesses."""
    from hyperdb_tpu_torch.native.server import NativeQueryServer
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.server import make_server

    work = serve_dir()
    try:
        payloads = [make_queries(seed + 200 + k, 4096, corpus, plant=k == 0)
                    for k in range(SERVE_CLIENTS)]
        # G1: binary vectors through the native front end
        for max_batch in (1024, 256):
            label = f"G1 native binary max_batch={max_batch}"
            srv = NativeQueryServer(db, port=0, max_batch=max_batch, window_ms=SERVE_WINDOW_MS)
            try:
                if not srv.wire_f16:
                    raise AssertionError("path G1: a float16 DB must take the float16 wire")
                check_endpoints(label, srv.port)
                zero_launches(G)
                samples = serve_phase(label, srv.port, "binary", payloads, SERVE_CONNS, 32, work,
                                      card, lambda: native_stats(srv),
                                      lambda: setattr(srv, "max_flush", 0))
                launches = dict(G.LAUNCHES)
                st = check_endpoints(label, srv.port)
                with srv.lock:
                    want = db.query_batch_arrays(vector_samples_block(samples, payloads, True),
                                                 top_k=TOP_K)
            finally:
                srv.close()
            log(f"path G {label}: launches {json.dumps(launches)}; /stats native "
                f"{json.dumps(st['native'])}")
            if max_batch == 1024:
                if launches["gmax_f_sub"] < 1:
                    raise AssertionError("path G1: served traffic at max_batch=1024 did not "
                                         "launch gmax_f_sub")
                check_variant(G, "path G1")
                kernels["gmax_f_sub"]["launches"] += launches["gmax_f_sub"]
            check_served(label, samples, *want)

        # the engine alone at flush sizes on both sides of the kernel's threshold
        # (a block of 257-511 pads to 512, HYPERDB_BATCH_BUCKET)
        for b in (256, 512, 1024):
            q16 = payloads[0][:b].astype(np.float16)
            ms = wall_ms(lambda: db.query_batch_arrays(q16, top_k=TOP_K), 5)
            log(f"path G1 engine alone (query_batch_arrays on a float16 block, no server): "
                f"b={b} ms/batch={ms:.3f} [{card}]")

        # G2: JSON vectors through the stdlib front end and its batcher
        label = "G2 stdlib json max_batch=64"
        httpd = make_server(db, port=0, dynamic_batch_ms=SERVE_WINDOW_MS, max_batch=64)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        spy = FlushSpy(db)
        try:
            check_endpoints(label, httpd.server_address[1])
            samples = serve_phase(label, httpd.server_address[1], "json",
                                  [p[:1024] for p in payloads], SERVE_CONNS, 1, work, card,
                                  spy.stats, lambda: setattr(spy, "max_flush", 0))
            check_endpoints(label, httpd.server_address[1])
        finally:
            spy.remove()
            httpd.shutdown()
            httpd.batcher.close()
            httpd.server_close()
            th.join(timeout=30)
        check_served(label, samples, *db.query_batch_arrays(
            vector_samples_block(samples, payloads, True), top_k=TOP_K))

        # G4: the CLI, each command a process of its own on the card
        t = time.perf_counter()
        db.save(str(work / "main.ckpt"), format="checkpoint")
        log(f"path G4: the main path's DB saved as a checkpoint in {time.perf_counter() - t:.2f} s")
        path_cli(work, seed, card)
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)


def start_cli(*argv):
    """Start ``python -m hyperdb_tpu_torch <argv>`` (on the card)."""
    proc = subprocess.Popen([sys.executable, "-m", "hyperdb_tpu_torch", *argv], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, argv[0], time.perf_counter()


def finish_cli(started, timeout: float = 600):
    """Wait for a command of :func:`start_cli`: (stdout, wall s); raises
    with its error output if it failed."""
    proc, name, t = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        raise AssertionError(f"path G4: `{name}` exited {proc.returncode}:\n{err[-3000:]}")
    return out, time.perf_counter() - t


def run_cli(*argv):
    return finish_cli(start_cli(*argv))


def path_cli(work, seed: int, card: str) -> None:
    """G4: ``build`` of a 4096-document JSONL (default embedder, float16),
    ``stats`` and ``query --text`` on its checkpoint (side by side), then
    ``bench`` at b = 512 alone on the main path's checkpoint; each command's
    wall seconds, process start and CUDA set-up included."""
    words = vocab_words()
    docs = text_documents(np.random.default_rng(seed + 210), words, G4_DOCS)
    src, ckpt = work / "g4.jsonl", work / "g4.ckpt"
    src.write_text("\n".join(json.dumps(d) for d in docs) + "\n")
    _, wall = run_cli("build", "--input", str(src), "--output", str(ckpt),
                      "--fp-precision", "float16")
    log(f"path G4 CLI build: {G4_DOCS} documents in {wall:.2f} s wall [{card}]")
    text = docs[7]["info"]["description"]
    started = start_cli("stats", "--db", str(ckpt))
    query = start_cli("query", "--db", str(ckpt), "--text", text, "-k", str(TOP_K))
    try:
        out, wall = finish_cli(started)
        stats = json.loads(out)
        if stats["documents"] != G4_DOCS or stats["dtype"] != "float16":
            raise AssertionError(f"path G4: stats {stats}")
        log(f"path G4 CLI stats: {wall:.2f} s wall, {json.dumps(stats)}")
    except BaseException:
        query[0].kill()  # stop every process this script started
        query[0].wait()
        raise
    out, wall = finish_cli(query)
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    if len(rows) != TOP_K or rows[0]["index"] != 7:
        raise AssertionError(f"path G4: query --text of document 7's description gave "
                             f"{[r['index'] for r in rows]}")
    log(f"path G4 CLI query --text: {wall:.2f} s wall, top-1 document 7 (score "
        f"{rows[0]['score']})")
    out, wall = run_cli("bench", "--db", str(work / "main.ckpt"), "--batch", "512",
                        "--iters", "10", "-k", str(TOP_K))
    bench = json.loads(out.strip().splitlines()[-1])
    log(f"path G4 CLI bench --batch 512 --iters 10 on the main path's checkpoint: "
        f"{wall:.2f} s wall, {json.dumps(bench)} [{card}]")


def text_serve_phase(db, words, kernels, seed: int, card: str) -> None:
    """G3: text/plain queries through the native front end over path E's
    DB: one encoder pass per flush on the card (the port's C++ WordPiece
    on the host), chained into the scan. The flushes' query blocks are
    recorded, so each sampled response is held to ``query_batch_arrays``
    on the block its text was embedded in."""
    from hyperdb_tpu_torch.native.server import NativeQueryServer
    from hyperdb_tpu_torch.native.tokenizer import NativeWordPiece
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.query import engine as E

    enc, _ = E._default_embed_path(db)
    if not isinstance(enc._tokenizer._native, NativeWordPiece):
        raise AssertionError("path G3: the encoder's WordPiece did not take the C++ encoder")
    rng = np.random.default_rng(seed + 220)
    texts = list(dict.fromkeys(zipf_texts(rng, words, SERVE_CLIENTS * 16384, 8, 16)))
    per = len(texts) // SERVE_CLIENTS
    payloads = [texts[k * per:(k + 1) * per] for k in range(SERVE_CLIENTS)]
    seen: dict[str, tuple[int, int]] = {}
    blocks: list[torch.Tensor] = []
    real = E.generate_query_vectors_batch_device

    def recording(d, batch):
        block = real(d, batch)
        if block is not None:
            for row, t in enumerate(batch):
                seen.setdefault(t, (len(blocks), row))
            blocks.append(block.clone())
        return block

    work = serve_dir()
    label = "G3 native text max_batch=512"
    srv = NativeQueryServer(db, port=0, max_batch=512, window_ms=SERVE_WINDOW_MS)
    E.generate_query_vectors_batch_device = recording
    try:
        check_endpoints(label, srv.port)
        zero_launches(G)
        samples = serve_phase(label, srv.port, "text", payloads, SERVE_CONNS, 16, work, card,
                              lambda: native_stats(srv), lambda: setattr(srv, "max_flush", 0),
                              unique=True)
        launches = dict(G.LAUNCHES)
        st = check_endpoints(label, srv.port)
    finally:
        E.generate_query_vectors_batch_device = real
        srv.close()
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    log(f"path G {label}: launches {json.dumps(launches)}; /stats native "
        f"{json.dumps(st['native'])}; {len(blocks)} device blocks")
    check_variant(G, "path G3")
    kernels["gmax_f_sub"]["launches"] += launches["gmax_f_sub"]
    rows = [seen[payloads[k][i]] for k, i, _, _ in samples]
    block = torch.stack([blocks[f][r] for f, r in rows])
    check_served(label, samples, *db.query_batch_arrays(block, top_k=TOP_K, n_valid=len(rows)))
    del blocks
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- path H


class ShardSpy:
    """Kernel launches per shard: wraps the per-shard functions of
    ``parallel/distributed.py`` and takes the wrappers' counters (each adds
    one where it launches its kernel) before and after every shard's call."""

    def __init__(self, D, counters):
        self.D, self.counters = D, counters
        self.real = (D._local_top_k, D._local_top_k_int8)
        self.per_shard = {}
        D._local_top_k, D._local_top_k_int8 = (self._wrap(f) for f in self.real)

    def _wrap(self, fn):
        def run(shard, *args, **kw):
            before = self._snapshot()
            out = fn(shard, *args, **kw)
            counts = self.per_shard.setdefault(shard, {})
            for name, n in self._snapshot().items():
                counts[name] = counts.get(name, 0) + n - before[name]
            return out
        return run

    def _snapshot(self) -> dict:
        return {name: n for c in self.counters for name, n in c.items()}

    def reset(self) -> None:
        self.per_shard = {}

    def remove(self) -> None:
        self.D._local_top_k, self.D._local_top_k_int8 = self.real


def check_same_answers(name, ids, vals, want_ids, want_vals, atol) -> int:
    """Tie-aware: scores within ``atol`` of the other answer's at every
    rank; where an id differs, the two scores lie within ``atol``."""
    if ids.shape != want_ids.shape:
        raise AssertionError(f"{name}: answer shapes {ids.shape} and {want_ids.shape}")
    err = float(np.abs(vals - want_vals).max())
    if not np.isfinite(vals).all() or err > atol:
        raise AssertionError(f"{name}: scores off the single-device answer by {err:.3g} > {atol}")
    return int((ids != want_ids).sum())


def masked_reference(plane, q, rec=None, mask=None) -> Reference:
    """Exact cosine top-k over the bf16 plane (the unit query rounded to
    bf16) with recency and a row mask folded into one additive term."""
    qt = torch.from_numpy(q).cuda()
    norm = torch.sqrt((qt * qt).sum(-1, keepdim=True))
    qn = (qt / torch.where(norm == 0, torch.ones_like(norm), norm)).bfloat16()
    add = torch.zeros(plane.shape[0], dtype=torch.float32, device=plane.device)
    if rec is not None:
        add = add + rec
    if mask is not None:
        add = add.masked_fill(~mask, NEG_INF)
    return Reference(qn, plane, N_DOCS, TOP_K, rec=add)


def path_sharded_scan(db, corpus, kernels, seed: int, card: str):
    """Path H1: ``ShardedHyperDB`` over meshes of 1 and 4 shards on the
    card, every cell against an exact reference and the single-device
    answer on the same block; launches counted per shard. Returns the
    1-shard DB for H3."""
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.ops import l1 as L
    from hyperdb_tpu_torch.ops import quantized as Q
    from hyperdb_tpu_torch.parallel import distributed as D
    from hyperdb_tpu_torch.parallel.mesh import make_mesh
    from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB

    dv = db._store.device_view(db.source_indices)
    plane, n_pad = dv["rows_norm"], dv["n_pad"]
    q = {b: make_queries(seed + 300 + b % 97, b, corpus) for b in (64, 512, 1024, 4096, 16384)}
    rec = recency_vector(n_pad)
    ts_half = torch.from_numpy((np.arange(n_pad) % 1000 == 500) & (np.arange(n_pad) < N_DOCS)).cuda()
    filt = [("metadata", {"ts": 0.5})]
    int8_planes = {}

    def int8_ref(sdb, qb):
        key = id(sdb)
        if key not in int8_planes:
            int8_planes[key] = {"rowsn_q": torch.cat(sdb.rowsn_q.shards),
                                "rown_scales": torch.cat(sdb.rown_scales.shards)}
        return int8_reference(int8_planes[key], qb, TOP_K)

    # (label, batch, query kwargs, CONFIG knobs, kernel expected on every
    # shard or None, reference, tolerance, hold to the single-device answer)
    cells = [
        ("cosine b=512", 512, {}, {}, "gmax_f_sub", lambda b: cosine_reference(plane, N_DOCS, q[b], TOP_K), ATOL, True),
        ("cosine b=16384", 16384, {}, {}, "gmax_f_sub",
         lambda b: cosine_reference(plane, N_DOCS, q[b][:512], TOP_K), ATOL, True),
        ("cosine b=512 pallas_subgroup=0", 512, {}, {"pallas_subgroup": 0}, "gmax_f",
         lambda b: cosine_reference(plane, N_DOCS, q[b], TOP_K), ATOL, True),
        ("manhattan b=64 pallas_l1t=1", 64, {"metric": "manhattan_distance"}, {"pallas_l1t": 1},
         "gmax_l1t", lambda b: DocReference("manhattan", q[b], dv["rows"], N_DOCS, TOP_K), MANHATTAN_ATOL, True),
        ("manhattan b=64 pallas_l1t=0", 64, {"metric": "manhattan_distance"}, {"pallas_l1t": 0},
         "gmax_l1", lambda b: DocReference("manhattan", q[b], dv["rows"], N_DOCS, TOP_K), MANHATTAN_ATOL, True),
        ("euclidean b=512", 512, {"metric": "euclidean_metric"}, {}, None,
         lambda b: DocReference("euclidean", q[b], dv["rows"], N_DOCS, TOP_K), ATOL, False),
        ("jaccard b=512", 512, {"metric": "jaccard_similarity"}, {}, None,
         lambda b: metric_reference(db, "jaccard_similarity", q[b], TOP_K), METRIC_ATOL["jaccard_similarity"], True),
        ("cosine b=512 recency", 512, {"recency_bias": RECENCY_BIAS, "timestamp_key": "ts"}, {}, "gmax_f_sub",
         lambda b: masked_reference(plane, q[b], rec=rec), ATOL, True),
        ("cosine b=512 metadata filter", 512, {"filters": filt}, {}, "gmax_f_sub",
         lambda b: masked_reference(plane, q[b], mask=ts_half), ATOL, True),
    ]
    # int8-pure: gmax_int8 where the route's epilogue budget sends the shard
    # (b * n_local * 4 bytes > 2 GB): b = 1024 on one shard; 4096 on four
    int8_batches = {1: (1024,), 4: (1024, 4096)}
    spy = ShardSpy(D, (G.LAUNCHES, L.LAUNCHES))
    single = {}
    sdb1 = None
    try:
        for n_shards in (1, 4):
            t = time.perf_counter()
            mesh = make_mesh(n_shards)
            sdb = ShardedHyperDB(db, mesh)
            sdb8 = ShardedHyperDB(db, mesh, precision="int8-pure")
            torch.cuda.synchronize()
            log(f"path H1 S={n_shards}: shards of {sdb.n_pad // n_shards} rows on "
                f"{[str(d) for d in mesh.local_devices()]}, bf16 and int8-pure sets built in "
                f"{time.perf_counter() - t:.1f} s")
            shard_knobs = {}
            if sdb.n_pad // n_shards < CONFIG.grouped_topk_min_rows:
                # the JAX per-shard rule sends a shard under the grouped
                # threshold to the plain (B, n_local) scan; the cells lower it
                shard_knobs = {"grouped_topk_min_rows": H1_SHARD_MIN_ROWS}
                log(f"path H1 S={n_shards}: n_local {sdb.n_pad // n_shards} < grouped_topk_min_rows "
                    f"{CONFIG.grouped_topk_min_rows}, which sends every shard to the plain route; "
                    f"the cells below set it to {H1_SHARD_MIN_ROWS}")
            extra_cells = []
            if shard_knobs:
                # the default threshold too: every shard on the plain (b, n_local) scan
                extra_cells = [("cosine b=512 default grouped_topk_min_rows (plain shards)", 512, {},
                                {"grouped_topk_min_rows": CONFIG.grouped_topk_min_rows}, None,
                                lambda b: cosine_reference(plane, N_DOCS, q[b], TOP_K), ATOL, False)]
            all_cells = [(c, sdb) for c in cells + extra_cells] + [
                ((label, b, {}, {}, "gmax_int8" if b * (sdb8.n_pad // n_shards) * 4 > Q._EPILOGUE_BUDGET_BYTES
                  else None, None, INT8_ATOL, False), sdb8)
                for label, b in ((f"int8-pure b={b}", b) for b in int8_batches[n_shards])
            ]
            for (label, b, kw, knobs, kernel, make_ref, atol, hold), target in all_cells:
                knobs = {**shard_knobs, **knobs}
                saved = {k: getattr(CONFIG, k) for k in knobs}
                for k, v in knobs.items():
                    setattr(CONFIG, k, v)
                try:
                    zero_launches(G)
                    zero_launches(L)
                    spy.reset()
                    ids, vals = target.query_batch_arrays(q[b], top_k=TOP_K, **kw)
                    per_shard = {s: {k: v for k, v in c.items() if v} for s, c in sorted(spy.per_shard.items())}
                    if kernel is not None:
                        if len(per_shard) != n_shards or any(c.get(kernel, 0) != 1 for c in per_shard.values()):
                            raise AssertionError(f"path H1 S={n_shards} {label}: {kernel} not launched once "
                                                 f"on every shard: {per_shard}")
                        kernels[kernel]["launches"] += n_shards
                        if kernel.startswith("gmax_f") or kernel == "gmax_int8":
                            check_variant(G, f"path H1 {label}")
                    elif any(per_shard.values()):
                        raise AssertionError(f"path H1 S={n_shards} {label}: a plain route launched {per_shard}")
                    ref = make_ref(b) if make_ref is not None else int8_ref(sdb8, q[b][:512])
                    n_ref = min(b, 512)
                    swaps, err = check_top_k(f"H1 S={n_shards} {label}", ids[:n_ref], vals[:n_ref], ref, atol)
                    del ref
                    key = (label, b)
                    if key not in single:
                        wi, wv = db.query_batch_arrays(q[b], top_k=TOP_K, **kw) if target is sdb else (None, None)
                        single[key] = (wi, wv, run_batch(db, q[b], f"path H1 single-device {label}", card, **kw)
                                       if target is sdb else None)
                    wi, wv, single_ms = single[key]
                    note = ""
                    if wi is not None:
                        d_ids = int((ids != wi).sum())
                        d_err = float(np.abs(vals - wv).max())
                        if hold:
                            check_same_answers(f"H1 S={n_shards} {label}", ids, vals, wi, wv, atol)
                            note = f"; tie-aware equal to the single-device answer ({d_ids} tied swaps)"
                        else:
                            note = (f"; against the single-device answer: {d_ids} ids differ, scores "
                                    f"within {d_err:.3g}")
                    ms = run_batch(target, q[b], f"path H1 S={n_shards} {label}", card, **kw)
                    log(f"path H1 S={n_shards} {label}: per-shard launches {json.dumps(per_shard)}; ids "
                        f"tie-aware equal to the exact reference ({swaps} tied swaps, score err {err:.3g}, "
                        f"tol {atol}){note}; ms/batch {ms:.3f} sharded against "
                        f"{'path A' if single_ms is None else f'{single_ms:.3f}'} single-device [{card}]")
                finally:
                    for k, v in saved.items():
                        setattr(CONFIG, k, v)
            del sdb8
            int8_planes.clear()
            if n_shards == 1:
                sdb1 = sdb
            else:
                del sdb
            torch.cuda.empty_cache()
    finally:
        spy.remove()
    return sdb1


def path_sharded_serving(sdb, db, corpus, seed: int, card: str) -> None:
    """Path H3: ``serve --sharded``'s shape: the native front end over the
    1-shard ShardedHyperDB with G1's traffic at max_batch 1024, a shorter
    window; 512 served answers held to its ``query_batch_arrays``."""
    global SERVE_SECONDS
    from hyperdb_tpu_torch.native.server import NativeQueryServer
    from hyperdb_tpu_torch.ops import gmax as G

    work = serve_dir()
    seconds = SERVE_SECONDS
    SERVE_SECONDS = H3_SECONDS
    try:
        payloads = [make_queries(seed + 200 + k, 4096, corpus, plant=k == 0)
                    for k in range(SERVE_CLIENTS)]
        label = "H3 native binary sharded S=1 max_batch=1024"
        srv = NativeQueryServer(sdb, port=0, max_batch=1024, window_ms=SERVE_WINDOW_MS)
        try:
            if not srv.wire_f16:
                raise AssertionError("path H3: a float16 DB must take the float16 wire")
            st = check_endpoints(label, srv.port)
            if st.get("sharded") is not True:
                raise AssertionError(f"path H3: /stats does not say sharded: {st}")
            zero_launches(G)
            samples = serve_phase(label, srv.port, "binary", payloads, SERVE_CONNS, 32, work, card,
                                  lambda: native_stats(srv), lambda: setattr(srv, "max_flush", 0))
            launches = dict(G.LAUNCHES)
            check_endpoints(label, srv.port)
            with srv.lock:
                want = sdb.query_batch_arrays(vector_samples_block(samples, payloads, True), top_k=TOP_K)
        finally:
            srv.close()
        log(f"path {label}: launches {json.dumps(launches)}")
        if launches["gmax_f_sub"] < 1:
            raise AssertionError("path H3: served traffic did not launch gmax_f_sub")
        check_served(label, samples, *want)
    finally:
        SERVE_SECONDS = seconds
        import shutil

        shutil.rmtree(work, ignore_errors=True)


def path_sharded_lifecycle(db, corpus, seed: int, card: str) -> None:
    """Path H2 (it mutates the main path's DB, so it runs after path G):
    a 4-shard ShardedHyperDB with reserved capacity; add 4096 rows,
    remove 1000 documents, compact, each held at b = 512 to a HyperDB
    rebuilt from the same documents; then ``from_checkpoint`` through
    ``load_sharded_vectors`` from a sharded checkpoint of the DB as it was."""
    import shutil
    from pathlib import Path

    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.parallel.mesh import make_mesh
    from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB

    work = Path(ROOT) / "build" / "smoke_sharded"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rng = np.random.default_rng(seed + 330)
    q = make_queries(seed + 331, 512, corpus)
    mesh = make_mesh(4)
    try:
        t = time.perf_counter()
        db.save(str(work / "ckpt"), format="checkpoint", rows_per_shard=1 << 18)
        log(f"path H2: sharded checkpoint of the main DB saved in {time.perf_counter() - t:.2f} s")
        want_i, want_v = db.query_batch_arrays(q, top_k=TOP_K)
        t = time.perf_counter()
        sdb = ShardedHyperDB(db, mesh, capacity_rows=N_DOCS + 8192)
        torch.cuda.synchronize()
        log(f"path H2: 4-shard set with capacity {sdb.n_pad} rows built in "
            f"{time.perf_counter() - t:.2f} s")

        def against_rebuilt(step: str, seconds: float) -> None:
            t0 = time.perf_counter()
            fresh = HyperDB.from_state({
                "vectors": db.vectors, "documents": db.documents,
                "source_indices": db.source_indices, "metadata_keys": ["ts"],
                "fp_precision": np.float16, "ann_metric": "cosine",
            })
            wi, wv = fresh.query_batch_arrays(q, top_k=TOP_K)
            rebuild_s = time.perf_counter() - t0
            gi, gv = sdb.query_batch_arrays(q, top_k=TOP_K)
            swaps = check_same_answers(f"H2 {step}", gi, gv, wi, wv, ATOL)
            log(f"path H2 {step}: {seconds:.3f} s; b=512 answers tie-aware equal to a HyperDB "
                f"rebuilt from the same documents ({swaps} tied swaps; the rebuild and its first "
                f"batch {rebuild_s:.2f} s); {sdb.n} rows, {sdb.tombstoned_rows} tombstoned, "
                f"{sdb.capacity_remaining} free [{card}]")

        new_rows = rng.standard_normal((4096, DIM), dtype=np.float32).astype(np.float16)
        t = time.perf_counter()
        sdb.add([{"ts": 0.999} for _ in range(4096)], vectors=new_rows)
        torch.cuda.synchronize()
        against_rebuilt("add of 4096 rows into reserved capacity", time.perf_counter() - t)
        victims = np.sort(rng.choice(len(db.documents), size=1000, replace=False)).tolist()
        t = time.perf_counter()
        sdb.remove_document(victims)
        against_rebuilt("remove_document of 1000 documents", time.perf_counter() - t)
        t = time.perf_counter()
        sdb.compact()
        torch.cuda.synchronize()
        against_rebuilt("compact", time.perf_counter() - t)
        del sdb
        torch.cuda.empty_cache()

        t = time.perf_counter()
        sck = ShardedHyperDB.from_checkpoint(str(work / "ckpt"), mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        if sck.n != N_DOCS or sck.rows.dtype != torch.bfloat16:
            raise AssertionError(f"path H2 from_checkpoint: {sck.n} rows of {sck.rows.dtype}")
        gi, gv = sck.query_batch_arrays(q, top_k=TOP_K)
        swaps, err = check_ids("H2 from_checkpoint", gi, gv, torch.cat(sck.rows_norm.shards), N_DOCS, q, TOP_K)
        same = float((gi == want_i).mean())
        log(f"path H2 from_checkpoint through load_sharded_vectors: {load_s:.2f} s for {N_DOCS} rows "
            f"in 4 shards; b=512 ids tie-aware equal to the exact reference over its own plane "
            f"({swaps} tied swaps, score err {err:.3g}); {same:.4f} of the ids equal the host-built "
            f"DB's (its bf16 rows are normalized on the card, the host's f16 rows on the host), "
            f"scores within {float(np.abs(gv - want_v).max()):.3g} [{card}]")
        del sck
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def path_multiprocess(card: str) -> None:
    """Path H4: the multi-process launchers on the card, each rank a process
    of its own: two ranks sharing the one card over gloo, each holding half
    of a 1M x 384 corpus; world size 1 over nccl; the hung follower."""
    tools = os.path.join(ROOT, "hyperdb_tpu_torch", "tools")
    runs = [
        ("2 ranks, gloo, 1M x 384", "multihost_serve_dryrun.py",
         ["--device", "cuda", "--procs", "2", "--local-shards", "1", "--backend", "gloo", "--rows", str(N_DOCS),
          "--dim", str(DIM), "--batch", "512", "-k", str(TOP_K), "--docs2", str(H4_DOCS2),
          "--atol", str(ATOL), "--timeout", "400"],
         "MULTIHOST SERVE DRYRUN: OK (launcher)"),
        # no --device, no --backend: the launcher's defaults, the card over nccl
        ("world size 1, nccl", "multihost_serve_dryrun.py",
         ["--procs", "1", "--local-shards", "2", "--timeout", "200"],
         "MULTIHOST SERVE DRYRUN: OK (launcher)"),
        ("hung follower, gloo", "multihost_fault_dryrun.py",
         ["--device", "cuda", "--procs", "2", "--local-shards", "1", "--backend", "gloo", "--ack-timeout", "5",
          "--raise-deadline", "30", "--timeout", "200"],
         "MULTIHOST FAULT DRYRUN: OK (launcher)"),
    ]
    for label, script, argv, ok in runs:
        t = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.join(tools, script), *argv],
                             capture_output=True, text=True, timeout=480, cwd=ROOT)
        dt = time.perf_counter() - t
        keep = [line for line in out.stdout.splitlines()
                if any(w in line for w in ("ms", "OK", "raised", "rc=", "set-up", "total"))]
        for line in keep[-30:]:
            log(f"path H4 {label}: {line.strip()}")
        if out.returncode != 0 or ok not in out.stdout:
            raise AssertionError(f"path H4 {label}: exit {out.returncode}\n{out.stdout[-3000:]}"
                                 f"\n{out.stderr[-2000:]}")
        log(f"path H4 {label}: passed in {dt:.1f} s [{card}]")


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

    # 14. path H1: the sharded exact scan over 1 and 4 shards of the same DB
    t = time.perf_counter()
    sdb1 = path_sharded_scan(db, corpus, kernels, args.seed, card)
    log(f"path H1: {time.perf_counter() - t:.1f} s")

    # 13. path G1, G2, G4: serving and the CLI over the main path's DB
    path_serving(db, corpus, kernels, args.seed, card)

    # 14. path H3 (serving the 1-shard DB), then H2 (which mutates the DB)
    t = time.perf_counter()
    path_sharded_serving(sdb1, db, corpus, args.seed, card)
    del sdb1
    torch.cuda.empty_cache()
    path_sharded_lifecycle(db, corpus, args.seed, card)
    log(f"path H2-H3: {time.perf_counter() - t:.1f} s")
    del db, dv, plane
    torch.cuda.empty_cache()

    # 12. path F: the IVF and projscan indexes
    path_indexes(docs, kernels, args.seed, card)

    # 10. path D: the chunked doc-level branch
    path_chunked(corpus, args.seed, card)
    del corpus, docs

    # 11. path E: text and persistence
    path_text(kernels, args.seed, card)

    # 14. path H4: the multi-process launchers
    t = time.perf_counter()
    path_multiprocess(card)
    log(f"path H4: {time.perf_counter() - t:.1f} s")

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
