"""Share of the profiled stretch of a served cell in which the native
front end's worker thread sat blocked in ``hdb_srv_next`` with no flush to
run, in %: the summed ``native.wait`` spans over the stretch from the
first recorded span's start to the last one's end. Headroom before the
knee: it falls toward 0 as the offered rate nears what the server
sustains. Nothing outside a traced run, or where the program records no
such spans."""

from perfbench.spec import layer_module

records = layer_module("engine.mask_ms.batch").records


def read(ctx: dict):
    spans = records(ctx)
    waits = [s.end - s.start for s in spans or () if s.name == "native.wait"]
    if not waits:
        return None
    stretch = max(s.end for s in spans) - min(s.start for s in spans)
    return 100.0 * sum(waits) / stretch if stretch > 0 else None
