"""Named-section wall-time profiler (the port's copy of
``tpuslam/utils/profiler.py:Profiler``).

The semantics of Thirdparty/tictoc_profiler (tic/toc pairs aggregated by
name, profiler.hpp:54-84) with a context-manager API.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


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
