"""The control of a cell's comparison: the reference put in the program's
place and ranking in int8 (one scale per row and per query), the precision
below the configuration's float16, read by the same numbers as a run's
answers. The benchmark's own runs never run it; it is run on the card at
the cell's own size to set the upper end of each limit:

    python3 perfbench/controls.py --workload <cell> --seeds 11 12 13 [--out f.jsonl]

For each seed it makes the cell's corpus and query pool as a run does,
draws as many queries from the pool as a run judges, and prints one JSON
line with the control's ``bad_answers``, ``rank_gap`` and ``score_err``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(spec: dict, seed: int, device) -> dict:
    import numpy as np

    from perfbench import check
    from perfbench.data import Corpus, sub_seed
    from perfbench.reference.exact import scan_corpus

    cfg, tr = spec["config"], spec["traffic"]
    n, k = int(cfg["rows"]), int(cfg["top_k"])
    corpus = Corpus(cfg, seed, device)
    pool = corpus.queries(int(tr["pool"]))
    s = int(tr.get("sample_queries", tr.get("sample_requests")))
    rng = np.random.default_rng(sub_seed(seed, "control"))
    qs = pool[np.sort(rng.choice(len(pool), min(s, len(pool)), replace=False))]
    ref = scan_corpus(corpus, qs, k, control=True)
    return check.measures(ref["control_ids"], ref["control_scores"], ref["top"], ref["control_true"], n, k)


def main(argv=None) -> int:
    import torch

    from perfbench.spec import load_cell

    p = argparse.ArgumentParser(description="the int8 control of a cell, over seeds")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    spec = load_cell(a.workload)
    device = torch.device(a.device)
    for seed in a.seeds:
        t0 = time.perf_counter()
        line = {"workload": a.workload, "seed": seed, "control": "int8",
                **control_numbers(spec, seed, device), "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
