"""Device time of every kernel but stage 1's, per batch, in ms: the grouped
routes' stages 2 and 3, the router's normalisation and casts, the final
top-k and the planar merge, from the profiled batches' trace. Stage 1's
kernels are those the ``*_roofline`` readers name."""

from perfbench.spec import layer_module

STAGE1 = [layer_module(m).kernel_s for m in ("gmax_wgmma_roofline", "gmax_stream_roofline")]


def read(ctx: dict):
    trace = ctx.get("trace")
    if not trace or not trace["kernel_s"]:
        return None
    other = sum(trace["kernel_s"].values()) - sum(f(trace) for f in STAGE1)
    return 1e3 * other / ctx["batches"]
