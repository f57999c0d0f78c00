"""The roofline arithmetic on shapes worked by hand, and the stage-1 reader."""

from __future__ import annotations

import pytest

from perfbench import roofline
from perfbench.spec import layer_reader


def test_cohere_batch_is_compute_bound():
    # 2 * 1024 * 10M * 768 = 1.572864e13 operations over 989e12 / s: 15.9 ms
    t, bound = roofline.scan_least_s(1024, 10_000_000, 768)
    assert bound == "compute"
    assert t == pytest.approx(1.572864e13 / 989e12)
    assert t == pytest.approx(0.0159035, rel=1e-5)


def test_bytes_count_each_input_once():
    # (n d + b d) * 2 bytes: 10M x 768 rows and 1024 queries in bf16
    assert roofline.scan_bytes(1024, 10_000_000, 768) == (10_000_000 * 768 + 1024 * 768) * 2


def test_small_batch_is_memory_bound():
    # b = 1: 2 * 5M * 1536 = 1.536e10 operations (15.5 us) against
    # (5M * 1536 + 1536) * 2 bytes = 1.5360003e10 B over 3.35e12 B/s (4.585 ms)
    t, bound = roofline.scan_least_s(1, 5_000_000, 1536)
    assert bound == "memory"
    assert t == pytest.approx((5_000_000 * 1536 + 1536) * 2 / 3.35e12)


def test_stage1_share_reads_only_named_kernels():
    read = layer_reader("gmax_stream_roofline")
    least, _ = roofline.scan_least_s(1024, 5_000_000, 1536)
    trace = {"kernel_s": {"void gmax_stream_kernel(CUtensorMap_st, CUtensorMap_st, ScanArgs)": 4 * least,
                          "at::native::elementwise_kernel": 1.0},
             "busy_s": 1.0, "window_s": 2.0}
    ctx = {"trace": trace, "batches": 2, "shape": {"b": 1024, "n": 5_000_000, "d": 1536}}
    assert read(ctx) == pytest.approx(50.0)
    other = layer_reader("route.other_kernels_ms.batch")(ctx)
    assert other == pytest.approx(500.0)
    assert layer_reader("device.idle_share.batch")(ctx) == pytest.approx(50.0)
    assert layer_reader("gmax_wgmma_roofline")(ctx) is None  # not this cell's kernel
    trace["kernel_s"] = {"at::native::elementwise_kernel": 1.0}
    assert read(ctx) is None
