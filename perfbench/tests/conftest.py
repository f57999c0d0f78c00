"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest perfbench/tests``; ``-m cuda`` on the card)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_spec(cell: str, rows: int = 8192, dim: int = 768, **traffic) -> dict:
    """A cell's spec cut to a size a CPU test holds: ``rows`` rows at the
    given width, and the traffic's pool and batch shrunk."""
    from perfbench.spec import load_cell

    spec = copy.deepcopy(load_cell(cell))
    spec["config"].update(rows=rows, dim=dim)
    spec["config"]["generator"]["block_rows"] = 2048
    tr = spec["traffic"]
    if tr["driver"] == "batch_closed":
        tr.update(pool=1024, batch=256, sample_queries=128, profile_batches=2)
    else:
        tr.update(pool=256, rate_per_s=150, warm_s=0.5, start_delay_s=0.5, sample_requests=64,
                  connections=2, profile_s=0.3, client_processes=2)
    tr.update(traffic)
    return spec


@pytest.fixture
def tiny(monkeypatch):
    # a served run pins its own process to the server's CPUs; in a test that
    # process is the test runner, which keeps every CPU
    monkeypatch.setattr("perfbench.drivers.serve_open.pin_process", lambda cpus: None)
    return tiny_spec
