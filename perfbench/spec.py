"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, named after it:

- ``configs/<config>.json``: the configuration (the ``file`` of its entry);
- ``traffic/<traffic>.json``: the mix's parameters, naming its driver in
  ``drivers/<driver>.py``;
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``;
- ``layers/<metric>.py``: the reader of one per-layer metric.

Adding a cell, a configuration, a mix or a metric is adding files and
entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(ValueError):
    """A name in ``BENCHMARK.json`` that finds no file, or a malformed file."""


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"{path} not found")
    return json.loads(path.read_text())


def _entry(entries, name: str, kind: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {kind} named {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path.relative_to(ROOT) if path.is_relative_to(ROOT) else path} not found")
    return json.loads(path.read_text())


def applies(metric: dict, cell: dict, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its ``workloads``,
    or, without that key, every cell that reports the end-to-end metric it
    moves (an end-to-end metric itself: every cell, unless it lists some)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return applies(_entry(bench["end_to_end"], moves, "end-to-end metric"), cell, bench)


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> dict:
    """Everything a run of cell ``name`` reads: the cell, its configuration,
    its traffic mix, its limits and the metrics it reports."""
    bench = load_benchmark(root) if bench is None else bench
    cell = _entry(bench["workloads"], name, "workload")
    cfg_entry = _entry(bench["configs"], cell["config"], "config")
    config = _json(root / cfg_entry["file"])
    traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    if not (HERE / "drivers" / f"{traffic['driver']}.py").is_file():
        raise SpecError(f"traffic {cell['traffic']!r} names driver {traffic['driver']!r}, which has no file")
    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "limits": _json(HERE / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, cell, bench)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, cell, bench)],
    }


def layer_module(metric: str):
    """The module ``layers/<metric>.py``."""
    path = HERE / "layers" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"per-layer metric {metric!r} has no reader at layers/{metric}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_layer_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layer_reader(metric: str):
    """The ``read(ctx)`` function of ``layers/<metric>.py``: the metric's
    value, or None where the run gives it nothing to read."""
    return layer_module(metric).read
