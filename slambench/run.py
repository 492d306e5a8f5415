"""Run one cell of the port's benchmark once.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: import the port, load (or build) its CUDA kernels, render the
cell's clip for the seed, and warm up with one session over the clip that
stops once the tracker has made the mix's ``warmup_keyframes`` keyframes
(initialization, then each keyframe's chain: the semantic step, mapping,
the local BA with every bundle, keyframe culling, the loop detector).
Then the window: sessions of a fresh ``Tracker`` over the clip, back to
back, for ``--seconds``, with a sample of kernel K2's calls recorded
(every ``K2_STRIDE``-th from an offset drawn from the seed).  After it:
the device's peak memory, the no-JAX check, and ``correct`` from the plain
references (``slambench/reference``).

The last line of standard output is the result's JSON; an earlier line
holds the set-up's parts, the sample counts and, with ``--trace 1``, the
traced stretch's size.  The compared numbers, each with its limit, are the
last lines of standard error and the result's last key.  ``--precision
tf32`` runs the window one precision below the configuration's (the
control; the benchmark's own runs never pass it).

Exit codes: 0 with a result; 2 without a card (or fewer than the cell
asks for), with no result; 3 when a JAX module is loaded, with no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuslam")
K2_STRIDE, K2_CAP = 8, 24  # kernel K2's sampled calls: every 8th, at most 24


def process_start() -> float:
    """Wall time at which this process started (Linux: from /proc), else the
    time this module began."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return min(btime + start_ticks / os.sysconf("SC_CLK_TCK"), T_PROCESS)
    except (OSError, ValueError, StopIteration, IndexError):
        return T_PROCESS


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is a JAX
    one or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", default="", help="tf32: the control, one step below the configuration's")
    return ap.parse_args(argv)


def judge(numbers: dict, limits: dict):
    """(correct, {name: [value, limit]}) over the cell's limits; a number
    the run could not read (absent or not finite) fails and prints as
    null."""
    checks = {k: [numbers.get(k), lim] for k, lim in limits.items()}
    for c in checks.values():
        if c[0] is not None and not math.isfinite(c[0]):
            c[0] = None
    return all(v is not None and v <= lim for v, lim in checks.values()), checks


def measure(cell, seed: int, seconds: float, trace: bool, device, precision: str = "", setup=None, clock=None):
    """Set-up, window, checks.  Returns (result dict, earlier-line dict)."""
    import torch

    from slambench import clip as clip_mod
    from slambench import harness, program, tracing
    from slambench.reference import checks

    clock = clock or time.perf_counter
    setup = setup if setup is not None else {}
    on_card = torch.device(device).type == "cuda"
    if "process_start" in setup:  # the interpreter, torch and BENCHMARK.json
        setup["start_s"] = time.time() - setup["process_start"]
    t = time.perf_counter()
    program.import_program()
    program.set_precision(cell.config["precision"])
    setup["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)
    setup["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    program.load_kernels(device)
    setup["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    clip = clip_mod.make_clip(cell.config, cell.traffic, seed, device, detections=program.detections)
    setup["render_s"] = time.perf_counter() - t
    if precision:
        program.set_precision(precision)
    t = time.perf_counter()
    warm = harness.Session(index=-1)
    warm.run(program, program.make_tracker(cell.config, device), clip, float("inf"), clock,
             until_keyframes=int(cell.traffic["warmup_keyframes"]))
    warm_kf, warm_frames = warm.counters["keyframes"], warm.attempted
    del warm
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup["warmup_s"] = time.perf_counter() - t
    setup["warmup_keyframes"] = warm_kf
    setup["warmup_frames"] = warm_frames

    stretch = tracing.Stretch(program) if trace else None
    t_window = time.time()
    with program.K2Samples(K2_STRIDE, seed, K2_CAP) as k2:
        win = harness.run_window(program, cell.config, clip, seconds, device, clock,
                                 on_frame=stretch.on_frame if stretch else None)
    if stretch:
        stretch.stop()
    setup["setup_s"] = t_window - setup.get("process_start", t_window)
    mem = torch.cuda.max_memory_allocated(device) if on_card else 0
    if not any(s.completed for s in win.sessions):  # the map is judged whole: finish the first session late
        win.sessions[0].finish(program, clip, clock)
    program.set_precision(cell.config["precision"])

    e2e = harness.end_to_end(win)
    calls = win.calls()
    counters = win.counters()
    results = []
    for s in win.sessions:
        results.append({**program.session_result(s.tracker), "epochs": s.epochs(), "kinds": s.kinds(),
                        "completed": s.completed, "whole": s.completed or s.late})
        s.tracker = None
    trace_summary = stretch.export() if stretch else {}
    if on_card:
        torch.cuda.empty_cache()
    numbers = checks.numbers(results, clip, cell.config, device, k2_samples=k2.host())
    numbers["lost_frames"] = float(win.failed())
    correct, compared = judge(numbers, cell.limits)

    earlier = {
        "setup": setup, "sessions": len(win.sessions), "poses_in_window": e2e["poses"],
        "pose_ms_p50": e2e["pose_ms_p50"], "kinds": {k: sum(f.kind == k for f in calls)
                                                     for k in ("init", "hot", "keyframe")},
        "keyframes": counters["keyframes"], "per_session": [s.summary() for s in win.sessions],
        "k2_calls": k2.calls, "start_deg": clip.start_deg, "precision": precision or
        cell.config["precision"], "numbers": {k: v if math.isfinite(v) else None for k, v in numbers.items()},
    }
    run = {"calls": calls, "counters": counters, "trace": trace_summary, "config": cell.config, "window": win}
    if trace:
        from slambench import cells

        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        earlier["trace"] = {k: trace_summary.get(k) for k in ("frames", "trace_bytes", "export_s", "read_s",
                                                              "kernel_launches", "api_calls", "window_s",
                                                              "busy_s")}
    else:
        values = {"frames_per_s": e2e["frames_per_s"], "pose_ms_p90": e2e["pose_ms_p90"],
                  "setup_s": setup["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(mem)}
    result = {"correct": bool(correct), "attempted": win.attempted(), "failed": win.failed(),
              "metrics": metrics, "device": device_info}
    if trace and trace_summary:
        device_info["busy_s"] = trace_summary["busy_s"]
        device_info["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {"device_ops": trace_summary["device_ops"], "idle_gaps": trace_summary["idle_gaps"]}
    result["checks"] = compared
    return result, earlier


def main(argv=None) -> int:
    args = parse_args(argv)
    setup = {"process_start": process_start()}
    import torch

    from slambench import cells

    bench = cells.load_benchmark()
    cell = cells.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: the cell needs {cell.chips} CUDA card(s), this machine has {n}; no result",
              file=sys.stderr)
        return 2
    result, earlier = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", args.precision, setup)
    bad = forbidden_modules()
    if bad:
        print(f"slambench: JAX modules loaded in the measuring process: {bad}; no result", file=sys.stderr)
        return 3
    earlier["card"] = power_limit()
    print(json.dumps(earlier), flush=True)
    for name, (value, limit) in result["checks"].items():
        ok = value is not None and value <= limit
        print(f"check {name} {value!r} <= {limit!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
