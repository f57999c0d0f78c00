"""Share of the grouped dot scans of the profiled stretch of a served cell
that ran on the stage-1 kernels, in %: the count of ``route.stage2`` spans
(one a plane scanned by a kernel route) over that count plus the count of
``route.plain`` spans (one a plane scanned by the plain grouped route).
Nothing outside a traced run, or where the program records neither span."""

from perfbench.spec import layer_module

records = layer_module("engine.mask_ms.batch").records


def read(ctx: dict):
    spans = records(ctx) or ()
    kernel = sum(s.name == "route.stage2" for s in spans)
    plain = sum(s.name == "route.plain" for s in spans)
    if not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)
