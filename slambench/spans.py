"""The traced stretch per program span: the port's ``tpuslam/<key>`` ranges
(``tpuslam_torch/utils/profiler.Spans``; ``<key>`` as in the ``Tracker``'s
``stage_ms``, the loop closer's as ``loop_<stage>``) and what the device
did, or did not do, under each.

Per key: the ranges' count and host ms (each range whole, nested ranges
inside it included), then, put down to the innermost range open at the
time, the kernel launches (each kernel by the runtime or driver call that
launched it, joined by ``args.correlation``), those kernels' device ms,
and the device's idle ms (each gap between device work, as
``tracing.reduce_events`` finds them, by its middle).  A row
``(outside every span)`` takes the rest, so the launches add up to the
stretch's ``kernel_launches`` and the idle to ``window_s - busy_s``.
``launches_under`` counts a launch under every range open around it.

The benchmark's own traced run does not reduce its trace per span yet.
This module is its reduction and a tool that runs a cell traced, as
``run.py --trace 1`` does, and prints the table after ``run.py``'s lines:

    python3 slambench/spans.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slambench import tracing  # noqa: E402

PREFIX = "tpuslam/"
OUTSIDE = "(outside every span)"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the spans that tile a hot call: the frame program's top-level stages and the host's waits
HOT_CALL_KEYS = ("frame_extract", "frame_motion", "frame_ref", "frame_localmap", "wait_event", "wait_read")


def _innermost(ranges, points):
    """For each time in ``points``, the stack of ``ranges`` ((start, end,
    key), properly nested) open at it, outermost first; returned in the
    order of ``points``."""
    order = sorted(range(len(points)), key=points.__getitem__)
    ranges = sorted(ranges)
    out = [()] * len(points)
    stack, i = [], 0
    for q in order:
        t = points[q]
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = tuple(r[2] for r in stack)
    return out


def reduce_spans(events) -> dict:
    """{key: {"ranges", "host_ms", "launches", "launches_under", "device_ms",
    "idle_ms"}} over Chrome-trace ``X`` events (microseconds), with the
    ``(outside every span)`` row; {} without events."""
    if not events:
        return {}
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):]) for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]
    table = {}

    def row(key):
        return table.setdefault(key, {"ranges": 0, "host_ms": 0.0, "launches": 0, "launches_under": 0,
                                      "device_ms": 0.0, "idle_ms": 0.0})

    for a, b, key in ranges:
        r = row(key)
        r["ranges"] += 1
        r["host_ms"] += (b - a) / 1e3
    row(OUTSIDE)

    launch_ts = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launch_ts.setdefault(corr, float(e["ts"]))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    at = [launch_ts.get(e.get("args", {}).get("correlation")) for e in kernels]
    stacks = _innermost(ranges, [t if t is not None else float("-inf") for t in at])
    for e, t, stack in zip(kernels, at, stacks):
        stack = stack if t is not None else ()
        r = row(stack[-1] if stack else OUTSIDE)
        r["launches"] += 1
        r["device_ms"] += float(e["dur"]) / 1e3
        for key in set(stack):
            row(key)["launches_under"] += 1

    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    merged = tracing._merge((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                            if e.get("cat") in tracing.DEVICE_CATS)
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    for (a, b), stack in zip(gaps, _innermost(ranges, [(a + b) / 2 for a, b in gaps])):
        row(stack[-1] if stack else OUTSIDE)["idle_ms"] += (b - a) / 1e3
    return table


def frame_launches(table: dict):
    """Kernel launches under the frame program's ``frame_*`` spans per
    ``frame_extract`` range (one per tracked image); None without one."""
    n = table.get("frame_extract", {}).get("ranges", 0)
    if not n:
        return None
    return sum(r["launches"] for k, r in table.items() if k.startswith("frame_")) / n


def launches_per_range(table: dict, key: str):
    """Kernel launches under ``key``'s ranges, nested spans included, per
    range; None without one."""
    r = table.get(key)
    return r["launches_under"] / r["ranges"] if r and r["ranges"] else None


def format_table(table: dict) -> list:
    """The table as text lines, the longest host time first."""
    head = f"{'span':<22} {'ranges':>6} {'host_ms':>10} {'ms/range':>9} {'launches':>9} {'under':>9} " \
           f"{'device_ms':>10} {'idle_ms':>10}"
    lines = [head]
    for key, r in sorted(table.items(), key=lambda kv: -kv[1]["host_ms"]):
        per = r["host_ms"] / r["ranges"] if r["ranges"] else 0.0
        lines.append(f"{key:<22} {r['ranges']:>6} {r['host_ms']:>10.1f} {per:>9.2f} {r['launches']:>9} "
                     f"{r['launches_under']:>9} {r['device_ms']:>10.2f} {r['idle_ms']:>10.1f}")
    return lines


def hot_call_share(snapshots) -> dict:
    """The share of the hot calls' time that :data:`HOT_CALL_KEYS` cover.
    ``snapshots`` are (frame record, the port's ``stage_ms`` as the call
    began, seconds of the harness's own hook in the call) in call order,
    the last one taken as the call after them began.  ``run_loop`` times
    the hook with the call, and the hook starts the profiler, so the
    hook's seconds are left out of the call."""
    covered = total = 0.0
    n = 0
    for (rec, before, hook_s), (_, after, _) in zip(snapshots, snapshots[1:]):
        if rec.kind != "hot":
            continue
        covered += sum(after.get(k, 0.0) - before.get(k, 0.0) for k in HOT_CALL_KEYS)
        total += (rec.call_s - hook_s) * 1e3
        n += 1
    return {"hot_calls": n, "hot_call_ms_mean": total / n if n else None,
            "covered_ms_mean": covered / n if n else None, "covered_share": covered / total if total else None}


def main(argv=None) -> int:
    """``run.py --trace 1`` with its trace reduced per span as well: prints
    run.py's two lines, the table, and a JSON line with the table, the
    launch readings and the hot calls' covered share."""
    import argparse

    from slambench import run

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    captured, snapshots = {}, []
    summarize, stretch = tracing.summarize, tracing.Stretch

    def with_spans(path, top=10):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
        out = tracing.reduce_events(events, top)
        return {**out, "spans": reduce_spans(events)} if out else out

    class Stretch(stretch):
        def on_frame(self, session, rec):
            was = self.prof is not None and not self.done
            t = time.perf_counter()
            super().on_frame(session, rec)
            hook_s = time.perf_counter() - t
            if was or (self.prof is not None and not self.done):
                snapshots.append((rec, dict(self.prog.counters(session.tracker)["stage_ms"]), hook_s))

        def export(self):
            out = super().export()
            captured.update(out)
            return out

    tracing.summarize, tracing.Stretch = with_spans, Stretch
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"])
    finally:
        tracing.summarize, tracing.Stretch = summarize, stretch
    table = captured.get("spans", {})
    for line in format_table(table):
        print(line)
    print(json.dumps({"spans": table, "frame_launches": frame_launches(table),
                      "map_ba_launches_per_kf": launches_per_range(table, "map_ba"),
                      "kernel_launches": captured.get("kernel_launches"), "window_s": captured.get("window_s"),
                      "busy_s": captured.get("busy_s"), "trace_bytes": captured.get("trace_bytes"),
                      **hot_call_share(snapshots)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
