"""Drive the PyTorch/CUDA port (``hyperdb_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one line each on standard output:

1. environment: the card's name and power limit (``nvidia-smi``), the torch
   and nvcc versions, and the time the kernels took to build;
2. every kernel of the path (``gmax_f_sub`` single and dual, ``gmax_f``)
   against its plain PyTorch version at the main path's shapes: a 2^20-row,
   d = 384 bf16 plane, b = 512, with masked rows, recency, a NaN row, a
   NaN group and duplicated rows. Tolerance 1e-5 absolute on unit-norm operands (the
   kernel and the plain f32 matmul sum the same exact bf16 products in
   different orders); -inf positions must match exactly. Each is timed
   (median of CUDA-event times after warm-up) beside its bound and the time
   of ``torch.mm`` with f32 output plus ``amax`` over the same product;
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
   route, with the same check.

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
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


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


def scan_bound_ms(b: int, n: int, d: int, out_cols: int) -> tuple[float, str]:
    """Least time for one stage-1 scan: the larger of its operations over the
    bf16 peak and its bytes (q, v, extra read once, maxes written once) over
    the memory rate."""
    flops = 2.0 * b * n * d
    nbytes = 2.0 * (b * d + n * d) + 4.0 * n + 4.0 * b * out_cols
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


# ---------------------------------------------------------------- data


def make_corpus(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((N_DOCS, DIM), dtype=np.float32).astype(np.float16)
    v[17] = v[4]  # exact duplicate rows: the lower id must win the tie
    return v


def make_queries(seed: int, b: int, corpus: np.ndarray) -> np.ndarray:
    q = np.random.default_rng(seed).standard_normal((b, DIM), dtype=np.float32)
    q[0] = corpus[4].astype(np.float32)
    return q


def reference_top_k(plane: torch.Tensor, n: int, q: np.ndarray, k: int):
    """Exact cosine top-k over the bf16 plane: the query normalized in f32
    and rounded to bf16, f32 matmul over the upcast plane, padding rows at
    -inf, then a stable descending sort (ties to the lower id)."""
    qt = torch.from_numpy(q).cuda()
    norm = torch.sqrt((qt * qt).sum(-1, keepdim=True))
    qn = (qt / torch.where(norm == 0, torch.ones_like(norm), norm)).bfloat16().float()
    v32 = plane.float()
    vals, ids = [], []
    for a in range(0, qn.shape[0], 64):
        s = qn[a : a + 64] @ v32.T
        s[:, n:] = float("-inf")
        s = s.masked_fill(torch.isnan(s), float("-inf"))
        sv, si = torch.sort(s, dim=-1, descending=True, stable=True)
        vals.append(sv[:, :k])
        ids.append(si[:, :k])
    return torch.cat(vals), torch.cat(ids), qn


def check_ids(name, got_ids, got_vals, plane, n, q, k):
    """Tie-aware: at every rank, the returned id's exact score and the
    returned score lie within ATOL of the reference's score at that rank;
    where an id differs from the reference's, the two rows' scores lie
    within ATOL of each other; no query returns an id twice."""
    ref_vals, ref_ids, qn = reference_top_k(plane, n, q, k)
    gi = torch.from_numpy(np.ascontiguousarray(got_ids)).cuda()
    gv = torch.from_numpy(np.ascontiguousarray(got_vals)).cuda()
    if gi.shape != ref_ids.shape or int(gi.max()) >= n or int(gi.min()) < 0:
        raise AssertionError(f"{name}: ids out of range or of the wrong shape")
    if not torch.isfinite(gv).all():
        raise AssertionError(f"{name}: non-finite scores")
    rows = plane[gi].float()  # (B, k, d)
    exact = torch.einsum("bd,bkd->bk", qn, rows)
    err_exact = float((exact - ref_vals).abs().max())
    err_score = float((gv - ref_vals).abs().max())
    swapped = gi != ref_ids
    swaps = int(swapped.sum())
    if err_exact > ATOL or err_score > ATOL:
        raise AssertionError(
            f"{name}: scores off the reference (ids {err_exact:.3g}, scores "
            f"{err_score:.3g} > {ATOL})"
        )
    if swaps:
        ref_rows = plane[ref_ids[swapped]].float()  # (swaps, d)
        qs = qn[swapped.nonzero()[:, 0]]
        ref_exact = (qs * ref_rows).sum(-1)
        err_swap = float((exact[swapped] - ref_exact).abs().max())
        if err_swap > ATOL:
            raise AssertionError(
                f"{name}: an id differs from the reference's at a score gap "
                f"of {err_swap:.3g} > {ATOL}"
            )
    uniq = torch.sort(gi, dim=1).values
    if (uniq[:, 1:] == uniq[:, :-1]).any():
        raise AssertionError(f"{name}: a query returned the same id twice")
    return swaps, err_score


# ---------------------------------------------------------------- phases


def phase_kernels(plane: torch.Tensor, n: int, seed: int):
    """Every kernel against its plain version at the main path's shapes."""
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

    results = {}
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
    del gm_d, sm_d, want_sm, want_gm

    def library(width):
        s = torch.mm(q, v.T, out_dtype=torch.float32)
        return s.view(b, n_pad // width, width).amax(-1)

    timings = {
        "gmax_f_sub": (
            lambda: G.gmax_f_sub(q, v, extra, sub=SUB, dual=False),
            lambda: G.gmax_f_sub_plain(q, v, extra, sub=SUB),
            lambda: library(SUB),
            n_pad // SUB,
            err_sub,
            "hyperdb_tpu/ops/pallas_gmax.py:265",
        ),
        "gmax_f": (
            lambda: G.gmax_f(q, v, extra),
            lambda: G.gmax_f_plain(q, v, extra),
            lambda: library(G.GROUP),
            n_pad // G.GROUP,
            err_f,
            "hyperdb_tpu/ops/pallas_gmax.py:217",
        ),
    }
    for name, (kern, plain, lib, cols, err, replaces) in timings.items():
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=10, warmup=1)
        lib_ms = cuda_ms(lib, reps=10, warmup=1)
        bound, bound_by = scan_bound_ms(b, n_pad, DIM, cols)
        results[name] = {
            "name": name, "route": "cuda", "source": "hyperdb_tpu_torch/csrc/gmax.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms,
        }
        log(
            f"kernel {name}: b={b} n={n_pad} d={DIM} max_abs_err={err:.3g} (tol {ATOL}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound:.4f} ({bound_by}) bound/ms={bound / ms:.3f}"
        )
    dual_ms = cuda_ms(lambda: G.gmax_f_sub(q, v, extra, sub=SUB, dual=True), reps=20)
    log(f"kernel gmax_f_sub dual: max_abs_err={err_dual:.3g} ms={dual_ms:.4f}")

    # the main path's large batch: kernel time beside its bound
    qb = q.repeat(32, 1)
    ms_big = cuda_ms(lambda: G.gmax_f_sub(qb, v, extra, sub=SUB, dual=False), reps=10)
    bound, bound_by = scan_bound_ms(qb.shape[0], n_pad, DIM, n_pad // SUB)
    log(
        f"kernel gmax_f_sub: b={qb.shape[0]} ms={ms_big:.4f} bound_ms={bound:.4f} "
        f"({bound_by}) bound/ms={bound / ms_big:.3f}"
    )
    del qb, v
    torch.cuda.empty_cache()
    return results


def run_batch(db, q, label, card):
    """One query_batch_arrays at the batch of ``q``, checked and timed."""
    ids, vals = db.query_batch_arrays(q, top_k=TOP_K, metric="cosine_similarity")
    reps = 5 if q.shape[0] <= 1024 else 3
    ms = wall_ms(
        lambda: db.query_batch_arrays(q, top_k=TOP_K, metric="cosine_similarity"), reps
    )
    log(f"{label}: b={q.shape[0]} ms/batch={ms:.3f} q/s={q.shape[0] / ms * 1e3:.1f} [{card}]")
    return ids, vals, ms


def stage_breakdown(db, q: np.ndarray, wall: float, card: str) -> None:
    """Device time of each stage of one main-path batch (the functions the
    route calls, on the same inputs), beside the batch's host-clock time;
    the difference is host work and transfers."""
    from hyperdb_tpu_torch.ops import gmax as G
    from hyperdb_tpu_torch.ops import metrics as M

    dv = db._store.device_view(db.source_indices)
    plane, n = dv["rows_norm"], dv["n_pad"]
    b, k = q.shape[0], 16  # k padded to a power of two, as the engine does
    qt = torch.from_numpy(q).cuda()
    qq = M._match_low_precision(M.normalize(qt), plane)
    extra = G.make_extra(n, dv["row_valid"], None, device=plane.device)
    gm, sm = G.gmax_f_sub(qq, plane, extra, sub=SUB, dual=False)
    sidx = G._select_subgroups(gm, sm, b, n, k, SUB)
    cs = G._rescore(qq, plane, extra, sidx, SUB)
    parts = {
        "normalize": cuda_ms(lambda: M._match_low_precision(M.normalize(qt), plane), 3, 1),
        "stage1": cuda_ms(lambda: G.gmax_f_sub(qq, plane, extra, sub=SUB, dual=False), 3, 1),
        "stage2": cuda_ms(lambda: G._select_subgroups(gm, sm, b, n, k, SUB), 3, 1),
        "stage3_rescore": cuda_ms(lambda: G._rescore(qq, plane, extra, sidx, SUB), 3, 1),
        "stage3_topk": cuda_ms(lambda: G._finish_candidates(cs, sidx, b, k, SUB), 3, 1),
    }
    device = sum(parts.values())
    items = " ".join(f"{name}={ms:.3f}" for name, ms in parts.items())
    log(
        f"breakdown b={b} (device ms): {items} sum={device:.3f}; batch wall={wall:.3f} "
        f"-> host+transfers={wall - device:.3f} [{card}]"
    )


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
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc_version()}")
    t = time.perf_counter()
    libs = cuda_build.build()
    log(f"kernel build: {time.perf_counter() - t:.2f} s for {sorted(libs)}")

    # 3 (data first: phase 2 runs on the main path's own plane)
    t = time.perf_counter()
    corpus = make_corpus(args.seed)
    db = HyperDB(documents=list(range(N_DOCS)), vectors=corpus, fp_precision="float16")
    dv = db._store.device_view(db.source_indices)
    plane, n_pad = dv["rows_norm"], dv["n_pad"]
    torch.cuda.synchronize()
    log(f"db build: {N_DOCS} x {DIM} f16 -> {tuple(plane.shape)} {plane.dtype} plane "
        f"on {plane.device}, {time.perf_counter() - t:.1f} s")

    # 2. kernels against their plain versions
    kernels = phase_kernels(plane, N_DOCS, args.seed)

    # 3. the main path: launch counts from this run only
    q512 = make_queries(args.seed + 2, 512, corpus)
    q16k = make_queries(args.seed + 3, 16384, corpus)
    for key in G.LAUNCHES:
        G.LAUNCHES[key] = 0
    i512, v512 = db.query_batch_arrays(q512, top_k=TOP_K, metric="cosine_similarity")
    i16k, v16k = db.query_batch_arrays(q16k, top_k=TOP_K, metric="cosine_similarity")
    launches = dict(G.LAUNCHES)
    log(f"main path launches: {json.dumps(launches)}")
    if launches["gmax_f_sub"] < 2:
        raise AssertionError("the main path did not launch gmax_f_sub at both batches")
    kernels["gmax_f_sub"]["launches"] = launches["gmax_f_sub"]
    swaps, err = check_ids("b=512", i512, v512, plane, N_DOCS, q512, TOP_K)
    if list(i512[0, :2]) != [4, 17]:
        raise AssertionError(f"duplicate rows 4/17 not first in lower-id order: {i512[0, :2]}")
    log(f"main b=512: ids tie-aware equal to the reference ({swaps} tied swaps, score err {err:.3g})")
    swaps, err = check_ids("b=16384", i16k[:512], v16k[:512], plane, N_DOCS, q16k[:512], TOP_K)
    log(f"main b=16384: first 512 ids tie-aware equal ({swaps} tied swaps, score err {err:.3g})")
    _, _, wall = run_batch(db, q512, "main path", card)
    stage_breakdown(db, q512, wall, card)
    _, _, wall = run_batch(db, q16k, "main path", card)
    stage_breakdown(db, q16k, wall, card)
    del i16k, v16k

    # 4. gmax_f through the entry point
    sub = CONFIG.pallas_subgroup
    CONFIG.pallas_subgroup = 0
    for key in G.LAUNCHES:
        G.LAUNCHES[key] = 0
    ids, vals = db.query_batch_arrays(q512, top_k=TOP_K, metric="cosine_similarity")
    launches_f = dict(G.LAUNCHES)
    log(f"gmax_f path launches: {json.dumps(launches_f)}")
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

    log(json.dumps({"kernels": [kernels["gmax_f_sub"], kernels["gmax_f"]]}))
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
