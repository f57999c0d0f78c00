"""The native front end's hand-back of a flush (``hdb_srv_batch_complete``:
format and queue every response), per flush, in ms: the difference of
``NativeQueryServer.complete_s`` over that of its ``flushes`` across the
window."""


def read(ctx: dict):
    native = ctx.get("native")
    return None if not native else native["complete_ms"]
