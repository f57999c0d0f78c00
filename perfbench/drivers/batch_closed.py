"""Closed-loop batches: one caller submits a batch of ``batch`` float32 query
vectors through ``HyperDB.query_batch_arrays`` and submits the next when the
answer (ids and scores, read back to the host) is in its hands.

The batches come in turn from the seeded pool of ``pool`` distinct queries.
``queries/s`` is every query answered in the window over the window's
length, from the first submission to the last read-back. A traced run puts
its first ``profile_batches`` batches of the window under the profiler.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import program
from perfbench.data import sub_seed
from perfbench.trace import Profile, summary, warm


def run(ctx: dict) -> dict:
    cfg, tr, dev = ctx["config"], ctx["traffic"], ctx["device"]
    k, metric, b = int(cfg["top_k"]), cfg["metric"], int(tr["batch"])
    pool = ctx["pool"]
    batches = [pool[a : a + b] for a in range(0, len(pool) - b + 1, b)]
    db, build_s = program.build_db(ctx["master"], pool[0], cfg, dev)
    for q in batches[: int(tr["warmup_batches"])]:
        db.query_batch_arrays(q, top_k=k, metric=metric)

    if ctx["trace"]:
        warm(dev)
    answers = []

    def one() -> float:
        j = len(answers) % len(batches)
        ids, scores = db.query_batch_arrays(batches[j], top_k=k, metric=metric)
        answers.append((j, ids, scores))
        return time.perf_counter()

    trace = None
    start = end = time.perf_counter()
    if ctx["trace"]:
        with Profile(dev) as prof:
            for _ in range(int(tr["profile_batches"])):
                end = one()
        trace = summary(prof)
    while end - start < ctx["seconds"]:
        end = one()
    peak = program.memory_peak(dev)
    del db
    program.free(dev)

    rng = np.random.default_rng(sub_seed(ctx["seed"], "sample"))
    pick = np.sort(rng.choice(len(answers) * b, min(int(tr["sample_queries"]), len(answers) * b), replace=False))
    qs = np.stack([batches[answers[p // b][0]][p % b] for p in pick])
    ids = np.stack([answers[p // b][1][p % b] for p in pick])
    scores = np.stack([answers[p // b][2][p % b] for p in pick])
    n_q = len(answers) * b
    return {
        "window_start": start,
        "e2e": {"qps": n_q / (end - start)},
        "attempted": n_q,
        "failed": 0,
        "sample": (qs, ids, scores),
        "memory_peak_bytes": peak,
        "layer_ctx": {
            "trace": trace,
            "batches": int(tr["profile_batches"]),
            "shape": {"b": b, "n": int(cfg["rows"]), "d": int(cfg["dim"])},
            "store_build_s": build_s,
        },
        "lines": [f"window: {len(answers)} batches of {b} in {end - start:.6f} s"],
    }

