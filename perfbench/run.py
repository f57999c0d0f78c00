"""Run one cell of the benchmark of ``hyperdb_tpu_torch`` and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the cell needs is found by name from ``BENCHMARK.json``
(``perfbench/spec.py``). A run makes the corpus and the query pool from the
seed on the card, hands them to the system under test through its traffic's
driver (``perfbench/drivers/``), measures for ``--seconds`` seconds, and then
judges a sample of the answers given in the window against the plain
reference (``perfbench/reference/``). With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled stretch of the window by ``perfbench/layers/<metric>.py``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit);
the last lines of standard error repeat the checks. Without a CUDA card (or
with fewer than the cell asks for), without the package under test, or with
JAX or the JAX package loaded once the window has closed, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is measured from the start of the process

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "hyperdb_tpu", "hyperdb")


class NoDevice(RuntimeError):
    pass


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def set_environment(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and keep
    libraries from loading JAX on their own."""
    cache = root / "build" / "perfbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_device(chips: int):
    """Card 0 when CUDA has at least ``chips`` cards; else :class:`NoDevice`."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, torch.cuda.device_count() is {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` among :data:`FORBIDDEN`, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _value(v):
    return None if v is None else float(v)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device) -> tuple[dict, list[str]]:
    """Run the cell ``spec`` (:func:`perfbench.spec.load_cell`) on ``device``:
    returns (the result object, the check lines)."""
    import torch

    from perfbench import check
    from perfbench.data import Corpus
    from perfbench.reference.exact import scan_corpus
    from perfbench.spec import layer_reader

    cfg, tr, cell = spec["config"], spec["traffic"], spec["cell"]
    n, k = int(cfg["rows"]), int(cfg["top_k"])
    t_data = time.perf_counter()
    corpus = Corpus(cfg, seed, device)
    master = corpus.host_master()
    pool = corpus.queries(int(tr["pool"]))
    data_s = time.perf_counter() - t_data
    say(f"data: {n} x {cfg['dim']} float16 rows and {len(pool)} queries made in {data_s:.3f} s")
    driver = importlib.import_module(f"perfbench.drivers.{tr['driver']}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = driver.run({
        "config": cfg, "traffic": tr, "cell": cell, "seed": seed, "seconds": seconds,
        "trace": trace, "device": device, "master": master, "pool": pool,
    })
    setup_s = out["window_start"] - T_PROCESS
    build_s = out["layer_ctx"]["store_build_s"]
    say(f"setup: {setup_s:.3f} s; {t_data - T_PROCESS:.3f} s to reach the card, {data_s:.3f} s data, "
        f"{build_s:.3f} s store build, {setup_s - (t_data - T_PROCESS) - data_s - build_s:.3f} s warm-up and start")
    del master
    for line in out["lines"]:
        say(line)

    # judge the sampled answers of the window against the plain reference
    t0 = time.perf_counter()
    qs, ids, scores = out["sample"]
    if ids is None or len(ids) == 0:
        numbers = {}
    else:
        ref = scan_corpus(corpus, qs, k, probe=ids)
        numbers = check.measures(ids, scores, ref["top"], ref["probed"], n, k)
    numbers["failed"] = out["failed"]
    correct, checks = check.judge(numbers, {**spec["limits"], "failed": 0})
    say(f"reference: {len(qs)} sampled queries judged in {time.perf_counter() - t0:.3f} s; "
        f"widest rank gap {numbers.get('rank_gap')}, widest score gap {numbers.get('score_err')} (not compared)")

    if trace:
        lctx = {**out["layer_ctx"], "config": cfg, "traffic": tr, "cell": cell}
        metrics = {}
        for m in spec["per_layer"]:
            v = layer_reader(m["name"])(lctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {**out["e2e"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": _value(e2e.get(m["name"])), "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(out["memory_peak_bytes"]),
    }
    result = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    tsum = out["layer_ctx"].get("trace")
    if trace and tsum:
        dev["busy_s"] = tsum["busy_s"]
        dev["window_s"] = tsum["window_s"]
        result["breakdown"] = {"device_ops": tsum["device_ops"], "idle_gaps": tsum["idle_gaps"]}
    result["checks"] = checks
    lines = [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="run one cell of the benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from perfbench.roofline import card
    from perfbench.spec import SpecError, load_cell

    try:
        spec = load_cell(a.workload)
    except (SpecError, KeyError, ValueError) as e:
        say(f"perfbench: {e}")
        return 2
    set_environment()
    try:
        device = require_device(int(spec["cell"]["chips"]))
    except NoDevice as e:
        say(f"perfbench: {e}; no result")
        return 2
    try:
        importlib.import_module("hyperdb_tpu_torch")
    except ImportError as e:
        say(f"perfbench: the system under test does not import ({e}); no result")
        return 2
    info = card()
    say(f"card: {info.get('name', '?')}, power limit {info.get('power_limit', '?')}; "
        f"cell {a.workload}, seed {a.seed}, {a.seconds} s, trace {a.trace}")

    result, checks = run_cell(spec, a.seed, a.seconds, bool(a.trace), device)

    bad = forbidden_modules()
    say(f"imports: {len({m.split('.', 1)[0] for m in list(sys.modules)})} top-level modules loaded; "
        f"forbidden among them: {', '.join(bad) or 'none'}")
    if bad:
        say(f"perfbench: {', '.join(bad)} loaded in this process; no result")
        return 3
    print(json.dumps(result), flush=True)
    for line in checks:
        say(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
