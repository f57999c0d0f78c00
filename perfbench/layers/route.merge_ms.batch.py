"""Device time of the planar merge (the per-plane winners concatenated and
ranked once more), per batch, in ms: the device time between the two CUDA
events of each ``route.merge`` span of the profiled batches, summed, over
the count of their ``engine.batch`` roots. Nothing outside a traced run,
where the program records no spans, or where the corpus is one plane."""

from perfbench.spec import layer_module

device_ms_per_batch = layer_module("route.stage2_ms.batch").device_ms_per_batch


def read(ctx: dict):
    return device_ms_per_batch(ctx, "route.merge")
