"""Tracing / profiling utilities.

- :class:`Stats` — cheap counters + EWMA latencies, attached to each DB
  (``db.stats``) and updated by the query engine.
- :func:`profiler_trace` — wraps ``torch.profiler`` and writes a Chrome
  trace of host and CUDA activity.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Stats:
    """Per-DB counters: call counts, cumulative + EWMA wall times by phase."""

    def __init__(self, ewma_alpha: float = 0.2):
        self._alpha = ewma_alpha
        self.counts: dict[str, int] = defaultdict(int)
        self.total_s: dict[str, float] = defaultdict(float)
        self.ewma_ms: dict[str, float] = {}

    def record(self, name: str, seconds: float) -> None:
        self.counts[name] += 1
        self.total_s[name] += seconds
        ms = seconds * 1e3
        prev = self.ewma_ms.get(name)
        self.ewma_ms[name] = ms if prev is None else (
            self._alpha * ms + (1 - self._alpha) * prev
        )

    def bump(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def snapshot(self) -> dict:
        out = {}
        for name in sorted(self.counts):
            entry = {"count": self.counts[name]}
            if name in self.total_s:
                total = self.total_s[name]
                entry["total_s"] = round(total, 6)
                if self.counts[name]:
                    entry["mean_ms"] = round(total / self.counts[name] * 1e3, 3)
            if name in self.ewma_ms:
                entry["ewma_ms"] = round(self.ewma_ms[name], 3)
            out[name] = entry
        return out

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - start)


@contextlib.contextmanager
def profiler_trace(trace_path: str):
    """Profile the enclosed block (host and, where present, CUDA activity)
    and write a Chrome trace to ``trace_path``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(trace_path)
