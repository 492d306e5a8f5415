"""Named-section wall-time profiler (the port's copy of
``tpuslam/utils/profiler.py``).

The semantics of Thirdparty/tictoc_profiler (tic/toc pairs aggregated by
name, profiler.hpp:54-84) with a context-manager API, plus
:func:`device_trace`, a ``torch.profiler`` capture for device-side
analysis.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


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
