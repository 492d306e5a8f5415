"""The traced run: a ``torch.profiler`` capture of a bounded stretch of
frames, and its reduction to the device's busy time, the kernels' device
time and the idle gaps named by what the host was doing.

The busy arithmetic is ``chip_smoke.trace_summary``'s (copied): the union
of the device's kernels, copies and sets over the span of every event.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
NAME_CHARS = 120  # a kernel's demangled name is cut to this in the breakdown


class Stretch:
    """Profiles the first session's frames from the first one after it has
    made a keyframe of its own until a further keyframe has been made and at
    least ``min_frames`` frames have run (at most ``max_frames``)."""

    def __init__(self, prog, min_frames: int = 3, max_frames: int = 12):
        self.prog, self.min_frames, self.max_frames = prog, min_frames, max_frames
        self.prof = None
        self.frames = 0
        self.kf0 = 0
        self.done = False

    def on_frame(self, session, rec):
        if self.done or session.index != 0:
            return
        if self.prof is None:
            if rec.tracking and rec.kf_before >= 1:
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                self.prof = torch.profiler.profile(activities=acts)
                self.prof.start()
                self.kf0 = rec.kf_before
                self.frames = 1
            return
        if (rec.kf_before > self.kf0 and self.frames >= self.min_frames) or self.frames >= self.max_frames:
            self.stop()
        else:
            self.frames += 1

    def stop(self):
        if self.prof is not None and not self.done:
            torch.cuda.synchronize()
            self.prof.stop()
            self.done = True

    def export(self) -> dict:
        """Write the trace to a fresh directory under ``TMPDIR``, reduce it,
        delete it.  Returns the summary with the trace's size and the
        seconds its export and its reading took."""
        if self.prof is None:
            return {}
        self.stop()
        tmp = tempfile.mkdtemp(prefix="slambench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            t0 = time.perf_counter()
            self.prof.export_chrome_trace(path)
            t1 = time.perf_counter()
            out = summarize(path)
            out.update(frames=self.frames, trace_bytes=os.path.getsize(path), export_s=t1 - t0,
                       read_s=time.perf_counter() - t1)
            return out
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(path: str, top: int = 10) -> dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    return reduce_events(events, top)


def reduce_events(events, top: int = 10) -> dict:
    """From Chrome-trace ``X`` events (microseconds): ``window_s``,
    ``busy_s``, ``kernels`` {name: [seconds, calls]} over the device's
    events, ``device_ops`` (the ``top`` names by device seconds) and
    ``idle_gaps`` (the ``top`` longest gaps between device work, each named
    by the innermost host event that spans its middle)."""
    if not events:
        return {}
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    merged = _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy = sum(b - a for a, b in merged)
    kernels = {}
    for e in dev:
        k = kernels.setdefault(e["name"], [0.0, 0])
        k[0] += float(e["dur"]) / 1e6
        k[1] += 1
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:top]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") in HOST_CATS)
    starts = [h[0] for h in host]
    named = []
    for length, a in gaps:
        mid = a + length / 2
        spans = [h for h in host[:bisect.bisect_right(starts, mid)] if h[1] >= mid]
        name = min(spans, key=lambda h: h[1] - h[0])[2] if spans else "(no host op: Python between ops)"
        named.append([name, length / 1e6])
    return {
        "window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6, "kernels": kernels,
        "device_ops": [[n[:NAME_CHARS], v[0]] for n, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]],
        "idle_gaps": named,
        "kernel_launches": sum(1 for e in events if e.get("cat") == "kernel"),
        "api_calls": sum(e.get("cat") in ("cuda_runtime", "cuda_driver") for e in events),
    }


def kernel_call_s(summary: dict, name: str):
    """(device seconds per call, calls) of the kernels whose name holds
    ``name``, or None when the trace has none."""
    total, calls = 0.0, 0
    for k, (s, n) in summary.get("kernels", {}).items():
        if name in k:
            total, calls = total + s, calls + n
    return (total / calls, calls) if calls else None
