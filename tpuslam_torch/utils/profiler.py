"""Named-section wall-time profiler (the port's copy of
``tpuslam/utils/profiler.py``).

The semantics of Thirdparty/tictoc_profiler (tic/toc pairs aggregated by
name, profiler.hpp:54-84) with a context-manager API, plus
:func:`device_trace`, a ``torch.profiler`` capture for device-side
analysis, and :class:`Spans`, the program's own stage timers: host wall
ms per stage summed into a dict its owner holds, each stage shown in a
``torch.profiler`` trace as a ``tpuslam/<key>`` range while one records.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def aggregate(self):
        out = {}
        for name, ts in self.times.items():
            n = len(ts)
            total = sum(ts)
            out[name] = {
                "count": n,
                "total_s": total,
                "mean_ms": 1000.0 * total / max(n, 1),
                "max_ms": 1000.0 * max(ts) if ts else 0.0,
            }
        return out

    def print_aggregated(self, file=None):
        """Same shape as ca::Profiler::print_aggregated (profiler.hpp:77-84)."""
        agg = self.aggregate()
        if not agg:
            return
        width = max(len(k) for k in agg)
        for name in sorted(agg):
            a = agg[name]
            print(
                f"{name:<{width}}  calls {a['count']:>6}  total {a['total_s']:.3f}s"
                f"  mean {a['mean_ms']:.2f}ms  max {a['max_ms']:.2f}ms",
                file=file,
            )


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block, host activity and,
    with a card present, the card's kernels and copies, into
    ``<logdir>/trace.json`` (Chrome trace format; chrome://tracing or
    Perfetto open it)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


TRACE_PREFIX = "tpuslam/"


def _range_enter(prefix: str, key: str):
    """A ``record_function`` range named ``tpuslam/<prefix><key>``, entered
    only while a profiler records (entering one costs ~15 µs of host time
    even with none running); None otherwise."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = record_function(TRACE_PREFIX + prefix + key)
    rf.__enter__()
    return rf


class _Span:
    __slots__ = ("spans", "key", "rf", "t0")

    def __init__(self, spans, key: str):
        self.spans, self.key = spans, key

    def __enter__(self):
        self.rf = _range_enter(self.spans.prefix, self.key)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter() - self.t0) * 1e3
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.spans.add(self.key, dt)
        return False


class _Laps:
    """Sequential stages of one block: :meth:`next` closes the open stage,
    adding its ms, and opens the named one at the same instant; :meth:`end`
    closes it.  A stage still open when the ``with`` block is left (an
    early return) is dropped: its range closes, its time is not added."""

    def __init__(self, spans, key: str):
        self.spans = spans
        self.key, self.rf, self.t0 = key, None, 0.0

    def _close(self, add: bool) -> float:
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        if add and self.key is not None:
            self.spans.add(self.key, (t1 - self.t0) * 1e3)
        self.key = None
        return t1

    def _open(self, key: str, t0: float):
        self.key = key
        self.rf = _range_enter(self.spans.prefix, key)
        self.t0 = t0

    def __enter__(self):
        self._open(self.key, time.perf_counter())
        return self

    def next(self, key: str):
        self._open(key, self._close(add=True))

    def end(self):
        self._close(add=True)

    def __exit__(self, *exc):
        if self.key is not None:
            self._close(add=False)
        return False


class Spans:
    """The program's stage timers.  ``ms`` is the owner's dict of host wall
    ms per key, summed over every span of that key; ``count`` how many
    spans of each key closed.  While a ``torch.profiler`` capture records,
    each span also opens a ``record_function`` range named
    ``tpuslam/<prefix><key>``: ``prefix`` is the name the owner's keys get
    in merged reports (the loop closer's ``loop_``)."""

    def __init__(self, ms: dict = None, prefix: str = ""):
        self.ms = {} if ms is None else ms
        self.count = {}
        self.prefix = prefix

    def add(self, key: str, ms: float) -> None:
        self.ms[key] = self.ms.get(key, 0.0) + ms
        self.count[key] = self.count.get(key, 0) + 1

    def span(self, key: str):
        """``with spans.span(key):`` times the block; spans nest."""
        return _Span(self, key)

    def laps(self, key: str):
        """``with spans.laps(first) as lap:`` opens stage ``first``;
        ``lap.next(key)`` and ``lap.end()`` as :class:`_Laps` says."""
        return _Laps(self, key)


class _NoSpans:
    """The recorder the frame program's functions take by default: it
    times nothing."""

    def span(self, key: str):
        return contextlib.nullcontext()


NO_SPANS = _NoSpans()
