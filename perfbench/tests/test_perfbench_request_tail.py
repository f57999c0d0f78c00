"""The reader of ``request.p99_ms.serve``: the served run's tail as the
driver hands it over, and silence in a run that serves no requests."""

from __future__ import annotations

import numpy as np

from perfbench.spec import layer_reader


def test_reads_the_window_tail():
    lat = np.arange(1, 1001, dtype=np.float64)
    ctx = {"latency": {"p99_ms": float(np.percentile(lat, 99))}, "native": None}
    assert layer_reader("request.p99_ms.serve")(ctx) == np.percentile(lat, 99)


def test_silent_without_served_requests():
    reader = layer_reader("request.p99_ms.serve")
    assert reader({"trace": None, "store_build_s": 1.0}) is None  # a batch cell's context
    assert reader({"latency": None}) is None  # a served window with no answer
