"""Host time a batch spends in the engine's mask phase, in ms: the program's
``engine.mask`` spans (the base mask, its copy, the filters, ``any``,
``count_nonzero``, then ``all`` and the row mask in ``_rank_block``) of the
profiled batches, summed, over the count of their ``engine.batch`` roots.

The spans are read through ``hyperdb_tpu_torch.utils.trace`` (``stretch``:
the spans recorded while the profiler ran). Nothing outside a traced run,
or where the program records no spans."""


def records(ctx: dict):
    """The program's spans of the newest recording stretch, or None."""
    if not ctx.get("trace"):
        return None
    try:
        from hyperdb_tpu_torch.utils import trace
    except ImportError:
        return None
    read = getattr(trace, "stretch", None)
    return read() if read is not None else None


def host_ms_per_batch(ctx: dict, name: str):
    """Summed host time of the spans ``name`` over the engine batches, in ms."""
    spans = records(ctx)
    if not spans:
        return None
    batches = sum(s.name == "engine.batch" for s in spans)
    times = [s.end - s.start for s in spans if s.name == name]
    if not batches or not times:
        return None
    return 1e3 * sum(times) / batches


def read(ctx: dict):
    return host_ms_per_batch(ctx, "engine.mask")
