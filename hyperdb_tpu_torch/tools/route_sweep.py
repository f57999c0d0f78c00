"""Time the grouped dot route on one card: stage-1 kernels against the plain route.

    python3 hyperdb_tpu_torch/tools/route_sweep.py [--out results.jsonl] [--widths D ...] [--rows N ...]

For each width d (768, 1536 unless ``--widths``), each corpus of N bf16
rows (2^18, 2^20, 2,097,152, 8,388,608 unless ``--rows``; multiples of
256) and each query count b in (1, 8, 32, 64, 128, 256, 511), at k = 128
(top_k 100 padded as the engine pads it), it times one call of

- ``plain``: ``ranking.rank_top_k_grouped`` (f32 upcast of the plane, one
  (b, N) f32 score matrix, group maxes), the route the router takes
  without the kernels;
- ``sub``: ``gmax.rank_top_k_grouped_gmax`` with 32-row subgroups (stage 1
  on ``gmax_f_sub``, two-level selection, stage 3 over 32-row runs);
- ``single``: the same with ``pallas_subgroup`` 0 (``gmax_f``, stage 3 over
  whole 128-row groups);

as the device time between two CUDA events around ``REPS`` calls in a row,
after two warm-up calls, over ``REPS``. A route that runs out of device
memory reads ``null``. Prints one JSON line a shape (also to ``--out``),
then the card's name and power limit. Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from hyperdb_tpu_torch.config import CONFIG  # noqa: E402
from hyperdb_tpu_torch.ops import gmax as G  # noqa: E402
from hyperdb_tpu_torch.ops import ranking as R  # noqa: E402

WIDTHS = (768, 1536)
ROWS = (1 << 18, 1 << 20, 2_097_152, 8_388_608)
BATCHES = (1, 8, 32, 64, 128, 256, 511)
K = 128
REPS = 5


def time_ms(fn) -> float | None:
    """Device ms a call of ``fn``, or None where it runs out of memory."""
    try:
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None


def routes(q, v):
    def plain():
        return R.rank_top_k_grouped(q, v, K, group=R._auto_group(q.shape[0]))

    def kernel(sub):
        def run():
            CONFIG.pallas_subgroup = sub
            return G.rank_top_k_grouped_gmax(q, v, K)

        return run

    return {"plain": plain, "sub": kernel(32), "single": kernel(0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--widths", type=int, nargs="+", default=WIDTHS)
    p.add_argument("--rows", type=int, nargs="+", default=ROWS)
    a = p.parse_args(argv)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    saved = CONFIG.pallas_subgroup
    lines = []
    try:
        for d in a.widths:
            for n in a.rows:
                v = torch.randn(n, d, device=dev, dtype=torch.bfloat16, generator=gen).mul_(d ** -0.5)
                for b in BATCHES:
                    q = torch.randn(b, d, device=dev, dtype=torch.bfloat16, generator=gen).mul_(d ** -0.5)
                    row = {"d": d, "n": n, "b": b, "k": K}
                    row.update({name: time_ms(fn) for name, fn in routes(q, v).items()})
                    lines.append(json.dumps(row))
                    print(lines[-1], flush=True)
                del v
                torch.cuda.empty_cache()
    finally:
        CONFIG.pallas_subgroup = saved
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    lines.append(json.dumps({"card": card, "torch": torch.__version__, "launches": G.LAUNCHES}))
    print(lines[-1], flush=True)
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
