"""Seconds on the host clock from before ``HyperDB(documents=[{}] * n,
vectors=..., fp_precision=...)`` to the read-back of its first answer (one
query, which builds the device planes): the store's set-up."""


def read(ctx: dict):
    return ctx.get("store_build_s")
