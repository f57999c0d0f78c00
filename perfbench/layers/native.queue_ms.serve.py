"""The native batcher's queue wait per request, in ms: from the moment the
I/O thread queues a request to the moment the worker takes its flush,
summed over the requests of the ``native.flush`` spans recorded in the
profiled stretch (their ``queue_s`` attribute, the C++ counter) over the
requests they hold. Nothing outside a traced run, or where the program
records no such spans."""

from perfbench.spec import layer_module

records = layer_module("engine.mask_ms.batch").records


def read(ctx: dict):
    spans = records(ctx)
    flushes = [s for s in spans or () if s.name == "native.flush" and "queue_s" in s.attrs]
    requests = sum(s.attrs["requests"] for s in flushes)
    if not requests:
        return None
    return 1e3 * sum(s.attrs["queue_s"] for s in flushes) / requests
