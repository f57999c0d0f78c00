"""Device time of stage 2 of the grouped routes (the selection of the
top-k groups and subgroups after stage 1), per batch, in ms: the device
time between the two CUDA events of each ``route.stage2`` span of the
profiled batches (one a plane), summed, over the count of their
``engine.batch`` roots. Nothing outside a traced run, where the program
records no spans, or where a span holds no device events (a CPU store)."""

from perfbench.spec import layer_module

records = layer_module("engine.mask_ms.batch").records


def device_ms_per_batch(ctx: dict, name: str):
    """Summed device time of the spans ``name`` over the engine batches, in ms."""
    spans = records(ctx)
    if not spans:
        return None
    batches = sum(s.name == "engine.batch" for s in spans)
    times = [s.device_ms() for s in spans if s.name == name]
    if not batches or not times or any(t is None for t in times):
        return None
    return sum(times) / batches


def read(ctx: dict):
    return device_ms_per_batch(ctx, "route.stage2")
