"""Find the highest rate a served cell sustains: one set-up, then the
cell's open loop (``drivers/serve_open.py``) at each rate in turn.

    python3 perfbench/sweep_serve.py --workload <served cell> --seed N \
        --seconds S --rates 500 1000 2000

For each rate it prints one JSON line: requests offered and completed in
the window, completed per second, p50 and p99, and the median latency of
the requests due in the window's first and last second. A rate is
sustained where completed keeps pace with offered and the last second is
no slower than the first (no growing backlog). The cell's traffic file
then takes a fixed rate below that.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import numpy as np
    import torch

    from hyperdb_tpu_torch.native.server import NativeQueryServer
    from perfbench import program
    from perfbench.data import Corpus, sub_seed
    from perfbench.drivers.serve_open import drive, pin_process, placement
    from perfbench.run import set_environment
    from perfbench.spec import load_cell

    p = argparse.ArgumentParser(description="rate sweep of a served cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    a = p.parse_args(argv)
    set_environment()
    spec = load_cell(a.workload)
    cfg, tr = spec["config"], spec["traffic"]
    dev = torch.device("cuda", 0)
    place = placement(tr)
    pin_process(place["server"])
    corpus = Corpus(cfg, a.seed, dev)
    pool = corpus.queries(int(tr["pool"]))
    db, build_s = program.build_db(corpus.host_master(), pool[0], cfg, dev)
    server = NativeQueryServer(db, host="127.0.0.1", port=0, max_batch=int(tr["max_batch"]),
                               window_ms=float(tr["window_ms"]))
    try:
        db.warmup(top_ks=(int(cfg["top_k"]),), metric=cfg["metric"], max_batch=int(tr["max_batch"]),
                  dtypes=["float16" if server.wire_f16 else "float32"])
        print(json.dumps({"store_build_s": build_s}), flush=True)
        for rate in a.rates:
            f0, q0 = server.flushes, server.flushed_queries
            rng = np.random.default_rng(sub_seed(a.seed, "sweep", rate))
            with tempfile.TemporaryDirectory(prefix="perfbench-sweep-") as tmp:
                r = drive(server.port, pool, tr, rate, a.seconds, rng, Path(tmp), int(cfg["top_k"]), cfg["metric"],
                          place)
            lat = r["lat_ms"][np.isfinite(r["lat_ms"])]
            late = r["lateness_ms"][np.isfinite(r["lateness_ms"])]
            flushes = server.flushes - f0
            print(json.dumps({
                "rate": rate, "offered": r["attempted"], "failed": r["failed"],
                "completed_per_s": lat.size / a.seconds,
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
                "first_second_median_ms": r["window_lat_first_last_s"][0],
                "last_second_median_ms": r["window_lat_first_last_s"][1],
                "lateness_p99_ms": float(np.percentile(late, 99)) if late.size else None,
                "lateness_max_ms": float(np.max(late)) if late.size else None,
                "mean_flush": (server.flushed_queries - q0) / max(1, flushes),
            }), flush=True)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
