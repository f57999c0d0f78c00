"""A run driven past the look for a card, on the CPU at a small size, with
the timed path broken underneath: ``correct`` comes out false for each fault
a search cell can have, and true without one. The int8 control fails the
cells' limits at the same size."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.controls import control_numbers
from perfbench.run import run_cell

CPU = torch.device("cpu")
CELLS = ["cohere768-10m.batch", "openai1536-5m.batch", "cohere768-10m.serve"]
WIDTH = {"cohere768-10m.batch": 768, "openai1536-5m.batch": 1536, "cohere768-10m.serve": 768}


def altered(orig, db, q, **kw):
    """An answer altered where it is produced: each best id moved to its neighbour."""
    ids, scores = orig(db, q, **kw)
    ids = ids.copy()
    ids[:, 0] = (ids[:, 0] + 1) % len(db.documents)
    return ids, scores


def half_batch(orig, db, q, **kw):
    """Half of the batch left out: the first half's answers stand for all."""
    b = len(q)
    if b < 2:
        return orig(db, q, **kw)
    ids, scores = orig(db, q[: b // 2], **kw)
    reps = -(-b // len(ids))
    return np.tile(ids, (reps, 1))[:b], np.tile(scores, (reps, 1))[:b]


def stale(orig, db, q, **kw):
    """The state left unchanged: the previous call's answers returned again
    (repeated or cut to this call's batch, as served flushes differ in size)."""
    got = orig(db, q, **kw)
    prev = getattr(db, "_fault_prev", None)
    db._fault_prev = got
    if prev is None:
        return got
    b, reps = len(q), -(-len(q) // len(prev[0]))
    return np.tile(prev[0], (reps, 1))[:b], np.tile(prev[1], (reps, 1))[:b]


def _patch(monkeypatch, fault):
    from hyperdb_tpu_torch.core.db import HyperDB

    orig = HyperDB.query_batch_arrays

    def broken(self, q, **kw):
        return fault(orig, self, q, **kw)

    monkeypatch.setattr(HyperDB, "query_batch_arrays", broken)


def _spec(tiny, cell):
    extra = {"rate_per_s": 700} if cell.endswith(".serve") else {}
    return tiny(cell, rows=8192, dim=WIDTH[cell], **extra)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny):
    result, lines = run_cell(_spec(tiny, cell), 2**32 + 11, 1.0, False, CPU)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and len(lines) == len(result["checks"])


@pytest.mark.parametrize("fault", [altered, half_batch, stale], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_incorrect(cell, fault, tiny, monkeypatch):
    _patch(monkeypatch, fault)
    result, _ = run_cell(_spec(tiny, cell), 2**32 + 12, 1.0, False, CPU)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_int8_control_fails_the_limits(cell, tiny):
    spec = _spec(tiny, cell)
    numbers = control_numbers(spec, 2**32 + 13, CPU)
    ok, checks = check.judge(numbers, spec["limits"])
    assert not ok, checks
