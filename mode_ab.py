#!/usr/bin/env python3
"""The 560-frame CLI replays of ``bench_torch.py`` with torch's
deterministic mode off and on, in one process on one CUDA card.

    python3 mode_ab.py

Writes the golden sequence once (``io.synth.write_sequence``), then runs
``bench_torch.py``'s flagship replay (``mono_icl --planes --objects``) with
the mode off, then on, and its points-only replay on, then off, and prints
one ``ab`` JSON line per run: the mode, the run, and ``bench_torch``'s
``golden_*`` keys (frames/s over the CLI's wall, tracked, ATE, per-keyframe
stage ms).  ``apps/common.make_tracker`` leaves the mode off; with it on,
torch swaps its scatter-adds for sorted ones, which the port's fixed-order
sums make redundant.  Exits with 2 without a card.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("mode_ab: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    import bench_torch
    import chip_smoke
    import tpuslam_torch  # noqa: F401  (pins float32 matmuls)
    from tpuslam_torch.io import synth

    dev = torch.device("cuda", 0)
    print("card: " + chip_smoke.card_line(), flush=True)
    folder = tempfile.mkdtemp(prefix="tpuslam_golden_ab_")
    try:
        t0 = time.perf_counter()
        synth.write_sequence(folder, n_frames=bench_torch.GOLDEN_FRAMES,
                             total_angle_deg=bench_torch.GOLDEN_ANGLE_DEG, device=dev)
        print(f"write_sequence: {time.perf_counter() - t0:.1f} s", flush=True)
        flagship = ("", ["--planes", "--objects"])
        points = ("ptsonly", [])
        for (prefix, extra), mode in ((flagship, False), (flagship, True), (points, True), (points, False)):
            chip_smoke.deterministic(mode)
            out = {}
            try:
                bench_torch._golden_replay(folder, bench_torch.GOLDEN_FRAMES, out, prefix, extra, dev)
            finally:
                chip_smoke.deterministic(False)
            print("ab " + json.dumps({"deterministic": mode, "run": prefix or "flagship", **out}), flush=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
