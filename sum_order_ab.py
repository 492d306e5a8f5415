#!/usr/bin/env python3
"""Two trees of the repository on one CUDA card: phase 6's card-vs-CPU
readings and the generic BA path's time per LM iteration.

    python3 sum_order_ab.py --parent DIR

``DIR`` holds another tree of the repository (a ``git archive`` of an
earlier commit, unpacked); the tree this script sits in is the change.  Each
measurement runs in a process of its own whose imports come from one tree
(its ``tpuslam_torch`` and ``chip_smoke``):

* ``spread``, once per tree (parent, then change): ``chip_smoke.py`` phase
  6's replay (the first 48 golden frames at 320x240, 512 features, loops
  off) on the card twice, once with the local BA's point step halved and
  once with its pose step halved (``lm.retract_state`` wrapped: faults
  injected to see what the readings can detect), and on the CPU with torch
  at 8, 4 and 2 threads.  Each card run is held to each CPU run as phase 6
  holds them (``chip_smoke.replay_agreement`` up to the first keyframe
  decision that differs): the largest camera-centre distance after Sim3
  alignment, the largest rotation angle and the initialization keyframe's
  angle, against ``SMALL_CENTRE_TOL``, ``SMALL_ANGLE_TOL`` and
  ``SMALL_INIT_ANGLE_TOL``.  The two sound card runs must be equal.
* ``generic``, in turns (parent, change, change, parent): bench.py's
  local-BA window (``workload.build_ba_window``) solved with 30 LM
  iterations three times by the generic assembly (``reproj_n=0``) and three
  times by the kf-major one; device ms per LM iteration (CUDA events around
  each solve, median), and whether the three generic solves are equal bit
  for bit.

Prints one JSON line per measurement, the card's name and power limit, and
a summary line.  Exits with 2 without a card, 1 if a measurement failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
THREADS = (8, 4, 2)


def _setup(tree: str):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke
    import tpuslam_torch  # noqa: F401  (pins float32 matmuls)

    return chip_smoke


def _agreement(cs, tr_a, tr_b) -> dict:
    """Phase 6's readings of two runs of the small replay."""
    dec_a = {f: made for f, _, made in tr_a.kf_decisions}
    dec_b = {f: made for f, _, made in tr_b.kf_decisions}
    split = min([f for f in dec_a if f in dec_b and dec_a[f] != dec_b[f]], default=None)
    same = [f for f, _ in tr_a.trajectory] == [f for f, _ in tr_b.trajectory]
    out = {"same_frames": same, "split_frame": split}
    if same:
        agree = cs.replay_agreement(tr_a.trajectory, tr_b.trajectory, split if split is not None else cs.SMALL_FRAMES)
        out.update({k: agree[k] for k in ("centre_max", "angle_max", "init_angle")})
    return out


def spread(tree: str) -> dict:
    import numpy as np
    import torch

    cs = _setup(tree)
    from tpuslam_torch.apps import golden
    from tpuslam_torch.graph import lm

    dev = torch.device("cuda", 0)
    cspec, _ = golden.golden_setup(small=True)
    rendered = golden.render_golden(cs.SMALL_FRAMES, cspec, "cpu")
    retract = lm.retract_state

    def card_run(point=1.0, pose=1.0):
        def scaled(state, data, delta_c, delta_l, *a, **kw):
            K = state.poses.shape[0]
            dc = torch.cat([delta_c[:6 * K] * pose, delta_c[6 * K:]])
            return retract(state, data, dc, delta_l * point, *a, **kw)

        lm.retract_state = scaled
        try:
            return golden.run_golden(cs.SMALL_FRAMES, dev, small=True, rendered=rendered)[1]
        finally:
            lm.retract_state = retract

    card = {"sound_1": card_run(), "sound_2": card_run(), "point_step_x0.5": card_run(point=0.5),
            "pose_step_x0.5": card_run(pose=0.5)}
    cpu = {}
    threads = torch.get_num_threads()
    for n in THREADS:
        torch.set_num_threads(n)
        cpu[f"cpu_{n}_threads"] = golden.run_golden(cs.SMALL_FRAMES, "cpu", small=True, rendered=rendered)[1]
    torch.set_num_threads(threads)
    s1, s2 = (np.stack([T for _, T in card[k].trajectory]) for k in ("sound_1", "sound_2"))
    readings = {f"{a} vs {b}": _agreement(cs, card[a], cpu[b]) for a in card for b in cpu}
    return {"tree": tree, "card_runs_equal": bool(np.array_equal(s1, s2)), "readings": readings,
            "limits": {"centre": cs.SMALL_CENTRE_TOL, "angle": cs.SMALL_ANGLE_TOL,
                       "init_angle": cs.SMALL_INIT_ANGLE_TOL}}


def generic(tree: str) -> dict:
    import numpy as np
    import torch

    cs = _setup(tree)
    from tpuslam_torch import workload
    from tpuslam_torch.graph import lm

    dev = torch.device("cuda", 0)
    n, iters = workload.BA_N, workload.BA_ITERS
    st, d = workload.build_ba_window(0, dev)
    w = lm.BAWeights()
    out = {"tree": tree, "lm_iters": iters}
    for name, rn in (("generic", 0), ("kf_major", n)):
        lm.lm_iterations(st, d, w, 1, reproj_n=rn)  # warm-up
        runs = [cs.event_call(lambda: lm.lm_iterations(st, d, w, iters, reproj_n=rn)) for _ in range(3)]
        ms = [t / iters for _, t in runs]
        out[f"{name}_ms_per_iter"] = ms
        out[f"{name}_median_ms_per_iter"] = float(np.median(ms))
        out[f"{name}_equal_bit_for_bit"] = all(cs.same_state(runs[0][0][0], s) and torch.equal(runs[0][0][1], c)
                                               for (s, c), _ in runs[1:])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--worker", choices=("spread", "generic"))
    ap.add_argument("--tree", type=Path)
    args = ap.parse_args()
    if args.worker:
        print("sum_order_ab " + json.dumps((spread if args.worker == "spread" else generic)(str(args.tree))),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("sum_order_ab: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    if args.parent is None:
        ap.error("--parent is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    trees = {"parent": str(args.parent.resolve()), "change": str(HERE)}
    order = [("spread", "parent"), ("spread", "change"), ("generic", "parent"), ("generic", "change"),
             ("generic", "change"), ("generic", "parent")]
    results, failed = [], 0
    for worker, side in order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", worker, "--tree",
                               trees[side]], capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("sum_order_ab ")]
        if proc.returncode or not lines:
            failed += 1
            print(f"sum_order_ab: {worker} on the {side} tree failed (rc {proc.returncode}):\n"
                  + proc.stderr[-4000:], flush=True)
            continue
        res = {"side": side, "worker": worker, **json.loads(lines[-1][len("sum_order_ab "):])}
        results.append(res)
        print(json.dumps(res), flush=True)
    print(card)
    summary = {side: {k: [r[k] for r in results if r["side"] == side and r["worker"] == "generic"]
                      for k in ("generic_median_ms_per_iter", "kf_major_median_ms_per_iter",
                                "generic_equal_bit_for_bit")} for side in trees}
    print("sum_order_ab summary " + json.dumps({"card": card, **summary}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
