"""Tracing / profiling utilities.

- :class:`Stats` — cheap counters + EWMA latencies, attached to each DB
  (``db.stats``) and updated by the query engine.
- :func:`profiler_trace` — wraps ``torch.profiler`` and writes a Chrome
  trace of host and CUDA activity.
- Spans (:func:`span`, :func:`root_span`, :func:`setup_span`) — named,
  nested phases at the port's layer boundaries, kept in a bounded ring in
  memory and read back with :func:`stretch` and :func:`setup_record`.

Spans record only while a torch profiler records in this process
(``torch.profiler.profile``, or :func:`profiler_trace`); there is no other
switch. Whether a span records is decided when it opens. While nothing
records, a span site checks one flag, notes that it found it off (that
ends the current recording stretch) and returns a shared object that does
nothing: no clock read, no allocation, no ``record_function``.

A recording span keeps its name, start and end (``time.perf_counter``), its
own id, its parent's id, the id of the outermost recording span around it
(``root``: every span of one engine batch, or of one native flush, shares
it) and a few numeric ``attrs``. Leaf spans also open
``torch.profiler.record_function("hyperdb.<name>")``, so each sits in the
profiler's trace as a ``user_annotation`` beside the kernels, on the
profiler's clock; root spans (``engine.batch``, ``native.flush``) stay in
memory only. A span given a CUDA tensor (``on``) records a pair of timing
events on the current stream, resolved only when :meth:`Span.device_ms`
reads them. Set-up spans (``store.planes``) record every time, whether or
not a profiler runs, into a ring of their own.

Operators: wrap the calls of interest in ``profiler_trace(path)``; the
Chrome trace written to ``path`` holds the ``hyperdb.*`` ranges beside the
kernels, and ``stretch()`` returns the spans of that recording, root spans
included.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from time import perf_counter as _clock

import torch
from torch.autograd import profiler as _profiler


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
    and write a Chrome trace to ``trace_path``. The port's leaf spans appear
    in it as ``hyperdb.*`` ranges; :func:`stretch` returns its spans."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(trace_path)


# ---------------------------------------------------------------- spans

RING_SIZE = 1 << 14  # recorded spans kept, newest last
SETUP_SIZE = 64  # set-up spans kept

_ring: deque = deque(maxlen=RING_SIZE)
_setup: deque = deque(maxlen=SETUP_SIZE)
_ids = itertools.count(1)
_local = threading.local()
_stretch = 0  # number of the newest recording stretch
_between = True  # a span site found the profiler off since the last recording span
_stretch_lock = threading.Lock()


def _stack() -> list:
    """This thread's open recording spans, outermost first."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Off:
    """What a span site gets while nothing records: one shared object that
    does nothing, and is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


_OFF = _Off()


class Span:
    """One recording span (see the module docstring)."""

    __slots__ = ("name", "start", "end", "id", "parent", "root", "stretch", "attrs",
                 "_annotate", "_on", "_setup", "_range", "_events")

    def __init__(self, name: str, annotate: bool, on=None, setup: bool = False):
        global _stretch, _between
        self.name = name
        self.id = next(_ids)
        self.attrs: dict = {}
        self._annotate = annotate
        self._on = on
        self._setup = setup
        self._range = self._events = None
        self.start = self.end = 0.0
        self.parent = self.root = 0
        if setup:
            self.stretch = 0
            return
        if _between:
            with _stretch_lock:
                if _between:
                    _stretch += 1
                    _between = False
        self.stretch = _stretch

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.root = self.id
        stack.append(self)
        if self._annotate:
            self._range = _profiler.record_function("hyperdb." + self.name)
            self._range.__enter__()
        on, self._on = self._on, None
        if on is not None and on.is_cuda:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        if self._events is not None:
            self._events[1].record()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _stack().pop()
        (_setup if self._setup else _ring).append(self)
        return False

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def device_ms(self):
        """Device time between the span's two events, in ms (waits for the
        second); None for a span that recorded none."""
        if self._events is None:
            return None
        first, last = self._events
        last.synchronize()
        return first.elapsed_time(last)

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"{1e3 * self.seconds:.4f} ms, {self.attrs})")


def span(name: str, on=None):
    """A leaf span ``name``: records while a profiler records, as a
    ``hyperdb.<name>`` range too; with ``on`` a CUDA tensor, also the
    device time between its ends on the current stream."""
    global _between
    if not _profiler._is_profiler_enabled:
        _between = True
        return _OFF
    return Span(name, True, on)


def root_span(name: str):
    """A span around a whole unit of work (an engine batch, a native
    flush): records while a profiler records, in memory only."""
    global _between
    if not _profiler._is_profiler_enabled:
        _between = True
        return _OFF
    return Span(name, False)


def setup_span(name: str) -> Span:
    """A set-up span: recorded every time (a ``hyperdb.<name>`` range too
    while a profiler records), kept apart from the ring."""
    return Span(name, bool(_profiler._is_profiler_enabled), setup=True)


def stretch() -> list:
    """The finished spans of the newest recording stretch (one stretch:
    the spans opened between two span sites that found no profiler), in
    the order they ended."""
    spans = list(_ring)
    if not spans:
        return []
    newest = max(s.stretch for s in spans)
    return [s for s in spans if s.stretch == newest]


def setup_record(name: str):
    """The newest finished set-up span ``name``, or None."""
    for s in reversed(list(_setup)):
        if s.name == name:
            return s
    return None
