"""The native front end's own clock around its engine call, per flush, in
ms: the difference of ``NativeQueryServer.engine_s`` over the difference of
its ``flushes``, read at the window's start and end (the counters ``/stats``
reports under ``native``)."""


def read(ctx: dict):
    native = ctx.get("native")
    return None if not native else native["engine_ms"]
