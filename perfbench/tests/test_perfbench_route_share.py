"""The reader of ``route.kernel_share.serve``: its arithmetic on synthetic
span records, and its silence where the program records neither
``route.stage2`` nor ``route.plain`` (as a program without the plain
route's span does) or has no span facility at all."""

from __future__ import annotations

import sys
import types

import pytest

from perfbench.spec import layer_reader

TRACED = {"trace": {"busy_s": 0.0, "window_s": 1.0, "kernel_s": {}}, "store_build_s": 1.0}


class Rec:
    """A span record as ``hyperdb_tpu_torch.utils.trace`` keeps it."""

    def __init__(self, name, start, end):
        self.name, self.start, self.end, self.attrs = name, start, end, {}


@pytest.fixture
def read(monkeypatch):
    """The reader, after making the program's trace module hand out the
    given records."""
    from hyperdb_tpu_torch.utils import trace

    reader = layer_reader("route.kernel_share.serve")

    def give(names):
        recs = [Rec(name, 0.1 * i, 0.1 * i + 0.05) for i, name in enumerate(names)]
        monkeypatch.setattr(trace, "stretch", lambda: recs)
        return reader(TRACED)

    return give


@pytest.mark.parametrize("names, share", [
    (["route.stage2", "route.stage3", "route.stage2", "route.stage3"], 100.0),
    (["route.stage2", "route.stage3", "route.plain"], 50.0),
    (["route.plain", "route.plain"], 0.0),
    (["engine.batch", "route.plain", "route.stage2", "route.stage2", "route.plain", "route.stage2"], 60.0),
])
def test_share_of_kernel_scans(read, names, share):
    assert read(names) == pytest.approx(share)


@pytest.mark.parametrize("names", [[], ["native.wait", "native.flush", "route.merge"]])
def test_silent_without_either_span(read, names):
    assert read(names) is None


def test_silent_outside_a_traced_run_or_without_the_facility(monkeypatch):
    reader = layer_reader("route.kernel_share.serve")
    assert reader({}) is None
    import hyperdb_tpu_torch.utils as utils

    monkeypatch.setattr(utils, "trace", types.ModuleType("hyperdb_tpu_torch.utils.trace"))
    monkeypatch.setitem(sys.modules, "hyperdb_tpu_torch.utils.trace", utils.trace)
    assert reader(TRACED) is None
