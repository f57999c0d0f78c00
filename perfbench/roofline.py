"""The least time one card could take for a scan, from the cell's shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), which
assume the full 700 W power limit; ``power_limit_w`` reads the card's own
so that every share is printed beside it.

The work is reckoned from the cell's own shapes: the real row count, the
batch and the width, never the program's padded planes, so a share reads
the same work whatever route or padding the program picks. Each input
byte is counted once.
"""

from __future__ import annotations

import subprocess

# operations a second by operand type (int8: operations a second too), and
# bytes a second of HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "int8": 1979e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bf16": 2, "fp16": 2, "int8": 1, "fp32": 4}


def scan_flops(b: int, n: int, d: int) -> float:
    """Multiply-adds of a (b, d) x (n, d) score matrix, as operations."""
    return 2.0 * b * n * d


def scan_bytes(b: int, n: int, d: int, dtype: str = "bf16") -> float:
    """Input bytes of the scan: every corpus row and every query once."""
    return float(n * d + b * d) * ELEM_BYTES[dtype]


def scan_least_s(b: int, n: int, d: int, dtype: str = "bf16") -> tuple[float, str]:
    """(seconds, "compute" | "memory"): the larger of operations over peak
    FLOP/s and bytes over peak bandwidth, and which of the two it is."""
    t_c = scan_flops(b, n, d) / PEAK_FLOPS[dtype]
    t_m = scan_bytes(b, n, d, dtype) / PEAK_BYTES_PER_S
    return (t_c, "compute") if t_c >= t_m else (t_m, "memory")


def card() -> dict:
    """Name and power limit of card 0 from ``nvidia-smi`` (empty if it cannot
    be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, _, limit = out[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}
