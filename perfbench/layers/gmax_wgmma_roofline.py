"""``gmax_wgmma_kernel``'s share of its roofline in a batch cell, in %: the
least time of the profiled batches' scans (``perfbench/roofline.py``,
reckoned from the cell's real rows, batch and width) over the summed device
time of the kernels named below in the trace. Nothing when none ran in the
profiled window (rows deeper than 1536 bytes take ``gmax_stream_kernel``)."""

from perfbench.roofline import scan_least_s

KERNELS = ("gmax_wgmma_kernel",)


def kernel_s(trace: dict) -> float:
    return sum(s for name, s in trace["kernel_s"].items() if any(k in name for k in KERNELS))


def read(ctx: dict):
    trace = ctx.get("trace")
    t = kernel_s(trace) if trace else 0.0
    if t <= 0:
        return None
    shape = ctx["shape"]
    least, _bound = scan_least_s(shape["b"], shape["n"], shape["d"])
    return 100.0 * least * ctx["batches"] / t
