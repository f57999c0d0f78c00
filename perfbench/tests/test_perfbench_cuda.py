"""On the card (``python -m pytest -m cuda perfbench/tests``): a batch cell
cut to 300000 rows still takes the stage-1 kernels, comes out correct, and
its traced run reads the kernels by name; the int8 control fails there."""

from __future__ import annotations

import pytest

from perfbench import check
from perfbench.controls import control_numbers
from perfbench.run import run_cell

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell,dim,kernel", [("cohere768-10m.batch", 768, "gmax_wgmma_roofline"),
                                             ("openai1536-5m.batch", 1536, "gmax_stream_roofline")])
def test_small_batch_cell_on_the_card(cell, dim, kernel, tiny, card):
    spec = tiny(cell, rows=300_000, dim=dim, pool=4096, batch=1024, profile_batches=3, sample_queries=256)
    result, _ = run_cell(spec, 2**33 + 1, 2.0, True, card)
    assert result["correct"], result["checks"]
    share = result["metrics"][kernel]["value"]
    assert 0 < share <= 100
    assert result["device"]["busy_s"] > 0
    ok, checks = check.judge(control_numbers(spec, 2**33 + 2, card), spec["limits"])
    assert not ok, checks
