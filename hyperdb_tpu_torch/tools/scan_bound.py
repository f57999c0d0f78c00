"""The least time one H100 could take for a stage-1 scan, from its shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), which
assume the full 700 W power limit. ``chip_smoke.py`` and
``tools/gmax_variants.py`` print every kernel time beside this bound.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def scan_bound_ms(b: int, n: int, d: int, out_cols: int, kind: str = "bf16"):
    """Least time for one stage-1 scan: the larger of its operations over
    the tensor-core peak of its operand type and its bytes (every input read
    once, the maxes written once) over the memory rate. ``kind`` is "bf16"
    (q, v, extra), "int8" (one-byte q and v, plus q_scale, v_scales, extra)
    or "jaccard" (bf16 q and v, plus q_sum, aux, extra). Returns (ms,
    "operations" | "bytes")."""
    flops = 2.0 * b * n * d
    width = 1.0 if kind == "int8" else 2.0
    nbytes = width * (b * d + n * d) + 4.0 * n + 4.0 * b * out_cols
    if kind != "bf16":
        nbytes += 4.0 * (b + n)
    peak = PEAK_INT8_OPS if kind == "int8" else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
