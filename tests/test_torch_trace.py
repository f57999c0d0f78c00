"""Spans of the port (``hyperdb_tpu_torch/utils/trace.py``) on the CPU.

A span records only while a torch profiler records in the process, which
the port reads from torch's private flag
``torch.autograd.profiler._is_profiler_enabled`` (pinned here on the
installed torch). With no profiler a span site reads no clock, makes no
span and opens no ``record_function``. Under a CPU profiler an engine batch
records its root and its host phases, the grouped and planar routes their
stages and merge, and the native front end its flushes, waits and
hand-backs; the leaf spans appear in the Chrome trace as ``hyperdb.*``
``user_annotation`` ranges and the roots do not. The plane build is a
set-up span, recorded with no profiler. No JAX here: the spans have no
twin in the JAX package.
"""

import http.client
import itertools
import json
import tracemalloc
from collections import deque

import numpy as np
import pytest
import torch
from torch.autograd import profiler as torch_profiler

from hyperdb_tpu_torch import HyperDB
from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.utils import trace

CPU = [torch.profiler.ProfilerActivity.CPU]
ENGINE_LEAVES = {"engine.prepare", "engine.mask", "engine.upload", "engine.readback"}


@pytest.fixture
def device_route(monkeypatch):
    """Small CPU corpora take the engine's device branch and the grouped routes."""
    monkeypatch.setattr(CONFIG, "host_path_max_cells", 0)
    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 512)


def _db(rows: int, dim: int, dtype=np.float32, seed: int = 0):
    v = np.random.default_rng(seed).standard_normal((rows, dim)).astype(dtype)
    fp = "float16" if dtype == np.float16 else "float32"
    return HyperDB(documents=[{}] * rows, vectors=v, fp_precision=fp, device="cpu"), v


def _annotations(prof, tmp_path) -> set:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_profiler_flag_is_the_one_torch_sets(tmp_path):
    assert torch_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=CPU):
        assert torch_profiler._is_profiler_enabled is True
    assert torch_profiler._is_profiler_enabled is False
    with trace.profiler_trace(str(tmp_path / "t.json")):
        assert torch_profiler._is_profiler_enabled is True
    assert torch_profiler._is_profiler_enabled is False
    assert (tmp_path / "t.json").is_file()


def test_without_a_profiler_a_span_site_does_nothing(device_route, monkeypatch):
    db, v = _db(4096, 16)
    want = db.query_batch_arrays(v[:3], top_k=5)  # builds the planes first
    ring, setup = list(trace._ring), list(trace._setup)

    def boom(*args, **kwargs):
        raise AssertionError("a span site did work with no profiler")

    monkeypatch.setattr(trace, "_clock", boom)
    monkeypatch.setattr(trace.Span, "__init__", boom)
    monkeypatch.setattr(torch_profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    got = db.query_batch_arrays(v[:3], top_k=5)
    np.testing.assert_array_equal(got[0], want[0])
    assert list(trace._ring) == ring and list(trace._setup) == setup

    # no allocation either: 10,000 sites peak under one object's size
    on = torch.zeros(4)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 10_000):
            with trace.span("engine.mask", on):
                pass
            with trace.root_span("engine.batch"):
                pass
        peak = tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()
    assert peak < 1024


def test_engine_batch_records_its_phases_under_one_root(device_route, tmp_path):
    db, v = _db(4096, 16)
    want = db.query_batch_arrays(v[:3], top_k=5)
    with torch.profiler.profile(activities=CPU) as prof:
        got = db.query_batch_arrays(v[:3], top_k=5)
    np.testing.assert_array_equal(got[0], want[0])
    spans = trace.stretch()
    (root,) = [s for s in spans if s.name == "engine.batch"]
    assert root.parent == 0 and root.root == root.id
    assert root.attrs == {"batch": 3, "padded": 4}
    leaves = [s for s in spans if s is not root]
    assert ENGINE_LEAVES <= {s.name for s in leaves}
    for s in leaves:
        assert s.root == root.id and s.parent == root.id, s
        assert root.start <= s.start <= s.end <= root.end
        assert s.device_ms() is None  # a CPU store records no device events
    names = _annotations(prof, tmp_path)
    assert {"hyperdb." + n for n in ENGINE_LEAVES} <= names
    assert "hyperdb.engine.batch" not in names


def test_routes_record_stages_per_plane_and_the_merge(device_route, monkeypatch, tmp_path):
    """A planar float16 corpus at b = 512 takes the stage-1 route (plain on
    the CPU) on each of three planes, then the merge."""
    monkeypatch.setattr(CONFIG, "plane_rows", 2048)
    db, v = _db(6144, 16, dtype=np.float16, seed=1)
    q = v[:512].astype(np.float32)
    want = db.query_batch_arrays(q, top_k=5)
    planes = trace.setup_record("store.planes")
    assert planes is not None and planes.attrs == {"rows": 6144, "planes": 3}
    with torch.profiler.profile(activities=CPU) as prof:
        got = db.query_batch_arrays(q, top_k=5)
    np.testing.assert_array_equal(got[0], want[0])
    spans = trace.stretch()
    (root,) = [s for s in spans if s.name == "engine.batch"]
    count = {n: sum(s.name == n for s in spans) for n in ("route.stage2", "route.stage3", "route.merge")}
    assert count == {"route.stage2": 3, "route.stage3": 3, "route.merge": 1}
    assert all(s.root == root.id for s in spans)
    names = _annotations(prof, tmp_path)
    assert {"hyperdb.route.stage2", "hyperdb.route.stage3", "hyperdb.route.merge"} <= names


def test_stretch_is_the_newest_recording():
    with torch.profiler.profile(activities=CPU):
        with trace.span("test.first"):
            pass
    with trace.span("test.between"):  # a site with no profiler ends the stretch
        pass
    with torch.profiler.profile(activities=CPU):
        with trace.root_span("test.root"):
            with trace.span("test.second"):
                pass
    assert [s.name for s in trace.stretch()] == ["test.second", "test.root"]


def test_ring_stays_bounded(monkeypatch):
    assert trace._ring.maxlen == trace.RING_SIZE
    assert trace._setup.maxlen == trace.SETUP_SIZE
    monkeypatch.setattr(trace, "_ring", deque(maxlen=8))
    with torch.profiler.profile(activities=CPU):
        for i in range(20):
            with trace.span("test.many") as s:
                s.attrs["i"] = i
    assert len(trace._ring) == 8
    assert [s.attrs["i"] for s in trace.stretch()] == list(range(12, 20))


def test_store_planes_recorded_without_a_profiler(device_route):
    before = trace.setup_record("store.planes")
    ring = list(trace._ring)
    db, v = _db(4096, 16, seed=2)
    db.query_batch_arrays(v[:2], top_k=3)
    rec = trace.setup_record("store.planes")
    assert rec is not None and rec is not before
    assert rec.seconds > 0 and rec.attrs == {"rows": 4096, "planes": 1}
    assert list(trace._ring) == ring


def test_native_flush_spans_carry_the_queue_wait():
    """The worker thread records a flush root per flush (its requests and
    queue wait), the engine batch beneath it, the hand-back, and its waits
    in ``hdb_srv_next``."""
    from hyperdb_tpu_torch.native.server import NativeQueryServer

    db, v = _db(256, 8, seed=3)
    with NativeQueryServer(db, port=0, max_batch=32, window_ms=2.0) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)

        def ask(i):
            conn.request("POST", "/query?top_k=3", v[i].tobytes(),
                         {"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            assert resp.status == 200, resp.read()
            resp.read()

        ask(0)
        with torch.profiler.profile(activities=CPU):
            for i in range(1, 4):
                ask(i)
        conn.close()
    spans = trace.stretch()
    flushes = [s for s in spans if s.name == "native.flush"]
    assert len(flushes) == 3
    for f in flushes:
        assert f.attrs["requests"] == 1
        assert 2e-3 <= f.attrs["queue_s"] == f.attrs["queue_max_s"]
        kids = {s.name for s in spans if s.root == f.id and s is not f}
        assert {"engine.batch", "native.complete"} <= kids
    assert sum(s.name == "native.wait" for s in spans) >= 2
