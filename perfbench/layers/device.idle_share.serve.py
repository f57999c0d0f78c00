"""Share of the profiled stretch of a served cell's window in which no
operation ran on the device (kernels, copies, memsets; their intervals'
union), in %."""


def read(ctx: dict):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
