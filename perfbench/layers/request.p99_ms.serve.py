"""The 99th percentile of the latency of the requests due in a traced
run's window before its profiled stretch, in ms, timed as ``p50_ms`` is:
from its due time to the last byte of its answer, on the load processes'
clock. It ends where the native counters' stretch ends, since stopping the
profiler holds the server's worker for seconds at the window's end. On the
benchmark's hosts this tail swings from run to run with the host's stalls by
more than any bound the check allows, so it is read here, with no bound, and
not end to end."""


def read(ctx: dict):
    latency = ctx.get("latency")
    return None if not latency else latency["p99_ms"]
