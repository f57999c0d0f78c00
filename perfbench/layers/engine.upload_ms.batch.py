"""Host time a batch spends in the engine's uploads, in ms: the program's
``engine.upload`` spans (the query block's ``torch.from_numpy(q).to(device)``
and any row-mask or recency upload) of the profiled batches, summed, over
the count of their ``engine.batch`` roots. Nothing outside a traced run, or
where the program records no spans."""

from perfbench.spec import layer_module

host_ms_per_batch = layer_module("engine.mask_ms.batch").host_ms_per_batch


def read(ctx: dict):
    return host_ms_per_batch(ctx, "engine.upload")
