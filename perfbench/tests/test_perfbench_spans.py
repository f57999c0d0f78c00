"""The readers of the program's spans (``layers/engine.*``, ``route.stage*``,
``route.merge_ms.batch``, ``native.queue_ms.serve``,
``native.worker_idle_share.serve``, ``store.planes_s``): their arithmetic on
synthetic span records, their silence where the program records no spans
(as a program without the span facility does), and a traced CPU run of each
cell reporting the host-side ones."""

from __future__ import annotations

import types

import pytest
import torch

from perfbench.run import run_cell
from perfbench.spec import layer_reader

CPU = torch.device("cpu")
TRACED = {"trace": {"busy_s": 0.0, "window_s": 1.0, "kernel_s": {}}, "store_build_s": 1.0}


class Rec:
    """A span record as ``hyperdb_tpu_torch.utils.trace`` keeps it."""

    def __init__(self, name, start, end, device_ms=None, **attrs):
        self.name, self.start, self.end, self.attrs = name, start, end, attrs
        self._device_ms = device_ms

    def device_ms(self):
        return self._device_ms


@pytest.fixture
def spans(monkeypatch):
    """Make the program's trace module hand out the given records."""
    from hyperdb_tpu_torch.utils import trace

    def give(stretch=(), setup=None):
        monkeypatch.setattr(trace, "stretch", lambda: list(stretch))
        monkeypatch.setattr(trace, "setup_record", lambda name: setup if name == "store.planes" else None)

    return give


def _batches(n, **per_batch):
    """``n`` engine batches, each with one span per name in ``per_batch``:
    (host seconds, device ms)."""
    out = []
    for i in range(n):
        out.append(Rec("engine.batch", i, i + 0.9))
        for name, (host_s, dev_ms) in per_batch.items():
            out.append(Rec(name, i + 0.1, i + 0.1 + host_s, dev_ms))
    return out


def test_host_readers_sum_per_batch(spans):
    spans(_batches(4, **{"engine.mask": (0.005, None), "engine.upload": (0.001, None)}))
    assert layer_reader("engine.mask_ms.batch")(TRACED) == pytest.approx(5.0)
    assert layer_reader("engine.upload_ms.batch")(TRACED) == pytest.approx(1.0)


def test_device_readers_sum_planes_per_batch(spans):
    recs = _batches(2, **{"route.stage2": (0.0, 2.5), "route.stage3": (0.0, 18.0), "route.merge": (0.0, 0.25)})
    recs += [Rec("route.stage2", 0.2, 0.3, 1.5), Rec("route.stage3", 0.3, 0.4, 4.0)]  # a second plane
    spans(recs)
    assert layer_reader("route.stage2_ms.batch")(TRACED) == pytest.approx((2 * 2.5 + 1.5) / 2)
    assert layer_reader("route.stage3_ms.batch")(TRACED) == pytest.approx((2 * 18.0 + 4.0) / 2)
    assert layer_reader("route.merge_ms.batch")(TRACED) == pytest.approx(0.25)


def test_device_readers_silent_without_events(spans):
    spans(_batches(2, **{"route.stage2": (0.001, None)}))
    assert layer_reader("route.stage2_ms.batch")(TRACED) is None
    assert layer_reader("route.merge_ms.batch")(TRACED) is None


def test_native_readers(spans):
    recs = [
        Rec("native.wait", 0.0, 0.02),
        Rec("native.flush", 0.02, 0.20, requests=200, queue_s=16.0, queue_max_s=0.1),
        Rec("native.wait", 0.20, 0.21),
        Rec("native.flush", 0.21, 0.40, requests=100, queue_s=5.0, queue_max_s=0.09),
    ]
    spans(recs)
    assert layer_reader("native.queue_ms.serve")(TRACED) == pytest.approx(1e3 * 21.0 / 300)
    assert layer_reader("native.worker_idle_share.serve")(TRACED) == pytest.approx(100 * 0.03 / 0.40)


def test_store_planes_reads_the_newest_set_up_span(spans):
    spans(setup=Rec("store.planes", 10.0, 37.5))
    assert layer_reader("store.planes_s")(TRACED) == pytest.approx(27.5)
    assert layer_reader("store.planes_s")({}) is None


@pytest.mark.parametrize("metric", ["engine.mask_ms.batch", "engine.upload_ms.batch", "route.stage2_ms.batch",
                                    "route.stage3_ms.batch", "route.merge_ms.batch", "native.queue_ms.serve",
                                    "native.worker_idle_share.serve", "store.planes_s"])
def test_silent_where_the_program_records_nothing(metric, spans, monkeypatch):
    spans()
    assert layer_reader(metric)(TRACED) is None
    # a program whose trace module has no span facility at all
    import hyperdb_tpu_torch.utils as utils

    monkeypatch.setattr(utils, "trace", types.ModuleType("hyperdb_tpu_torch.utils.trace"))
    monkeypatch.setitem(__import__("sys").modules, "hyperdb_tpu_torch.utils.trace", utils.trace)
    assert layer_reader(metric)(TRACED) is None


WIDTH = {"cohere768-10m.batch": 768, "openai1536-5m.batch": 1536, "cohere768-10m.serve": 768}
HOST_METRICS = {
    "cohere768-10m.batch": {"engine.mask_ms.batch", "engine.upload_ms.batch", "store.planes_s"},
    "openai1536-5m.batch": {"engine.mask_ms.batch", "engine.upload_ms.batch", "store.planes_s"},
    "cohere768-10m.serve": {"native.queue_ms.serve", "native.worker_idle_share.serve", "store.planes_s",
                            "request.p99_ms.serve"},
}


@pytest.mark.parametrize("cell", list(HOST_METRICS))
def test_traced_cpu_run_reports_the_host_spans(cell, tiny):
    """On the CPU the route readers have no device events to read; the
    host-side ones read the spans of the profiled stretch."""
    extra = {"rate_per_s": 700} if cell.endswith(".serve") else {}
    result, _ = run_cell(tiny(cell, rows=8192, dim=WIDTH[cell], **extra), 2**32 + 21, 1.0, True, CPU)
    assert result["correct"], result["checks"]
    got = {name for name, m in result["metrics"].items() if m["value"] is not None}
    assert HOST_METRICS[cell] <= got
    assert not {"route.stage2_ms.batch", "route.stage3_ms.batch", "route.merge_ms.batch"} & got
    for name in HOST_METRICS[cell]:
        assert result["metrics"][name]["value"] >= 0
