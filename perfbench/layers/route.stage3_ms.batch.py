"""Device time of stage 3 of the grouped routes (the candidates' gather,
their f32 rescore and the final top-k), per batch, in ms: the device time
between the two CUDA events of each ``route.stage3`` span of the profiled
batches (one a plane), summed, over the count of their ``engine.batch``
roots. Nothing outside a traced run, where the program records no spans,
or where a span holds no device events."""

from perfbench.spec import layer_module

device_ms_per_batch = layer_module("route.stage2_ms.batch").device_ms_per_batch


def read(ctx: dict):
    return device_ms_per_batch(ctx, "route.stage3")
