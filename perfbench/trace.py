"""The device trace of a traced run, read from ``torch.profiler``.

``Profile`` wraps a ``torch.profiler.profile`` over host and CUDA activity
and times its window on the host clock from after the profiler has started
to before it stops, so the profiler's own start and stop are outside it.
``summary`` (not the stop, which may run where time is measured) exports the
trace as a Chrome trace to a temporary directory and reduces it to plain
lists:

- ``device``: every device operation (kernels, copies, memsets) as
  ``(name, start_us, dur_us, cat)``;
- ``host``: host operations and runtime calls as ``(name, start_us, dur_us)``.

``summary`` derives ``busy_s`` (the union of the device operations'
intervals), the time of each kernel by name and the idle gaps between
device operations, each named by the host activity that overlaps it most.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 160


class Profile:
    def __init__(self, device):
        self.device = device
        self.window_s = 0.0
        self.device_ops: list[tuple[str, float, float, str]] = []
        self.host_ops: list[tuple[str, float, float]] = []

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def read(self) -> None:
        """Fill ``device_ops`` and ``host_ops`` from the stopped profiler."""
        if self.device_ops or self.host_ops:
            return
        with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device_ops.append((e.get("name", "?"), float(e["ts"]), float(e["dur"]), cat))
            elif cat in HOST_CATS:
                self.host_ops.append((e.get("name", "?"), float(e["ts"]), float(e["dur"])))


def warm(device) -> None:
    """One tiny profiled operation, in set-up: the first profiler session of
    a process pays the tracer's start-up, which must not fall in a window."""
    import torch

    with Profile(device):
        torch.ones(8, device=device).add_(1)


def _union(intervals):
    """Merged (start, end) intervals of (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_label(a: float, b: float, host_ops) -> str:
    """The host activity overlapping (a, b) the most."""
    best, best_ov = "host: no op recorded", 0.0
    for name, ts, dur in host_ops:
        ov = min(b, ts + dur) - max(a, ts)
        if ov > best_ov:
            best, best_ov = name, ov
    return best[:NAME_CHARS]


def summary(profile: Profile, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``kernel_s`` (seconds by kernel name),
    ``device_ops`` and ``idle_gaps`` (each at most ``top`` [name, seconds])."""
    profile.read()
    ops = profile.device_ops
    merged = _union((ts, ts + dur) for _n, ts, dur, _c in ops)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    by_name = defaultdict(float)
    kernel_s = defaultdict(float)
    for name, _ts, dur, cat in ops:
        by_name[name[:NAME_CHARS]] += dur * 1e-6
        if cat == "kernel":
            kernel_s[name] += dur * 1e-6
    gaps = sorted(
        ((b0, a1) for (_a0, b0), (a1, _b1) in zip(merged, merged[1:])),
        key=lambda g: g[0] - g[1],
    )[:top]
    host = sorted(profile.host_ops, key=lambda h: h[1])
    return {
        "busy_s": busy_s,
        "window_s": profile.window_s,
        "kernel_s": dict(kernel_s),
        "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[_host_label(a, b, host), (b - a) * 1e-6] for a, b in gaps],
    }
