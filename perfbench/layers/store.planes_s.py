"""Seconds on the host clock of the store's host-side plane build (the
float planes made a chunk of rows at a time on the host and copied to the
device, at the first query): the newest ``store.planes`` set-up span, which
the program records every time. The rest of ``store.build_s`` is the
constructor, the device view's row pass and the first query itself.
Nothing where no store was built, or where the program records no such
span."""


def read(ctx: dict):
    if ctx.get("store_build_s") is None:
        return None
    try:
        from hyperdb_tpu_torch.utils import trace
    except ImportError:
        return None
    find = getattr(trace, "setup_record", None)
    rec = find("store.planes") if find is not None else None
    return None if rec is None else rec.end - rec.start
