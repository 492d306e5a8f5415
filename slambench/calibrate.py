"""Readings that a cell's limits are set from: the compared numbers of whole
sessions over many seeds, sound and under the control, in one process.

    python3 slambench/calibrate.py --workload <cell> --seeds 0-11 [--control-seeds 0-2]
        [--faults frozen_pose,ba_unchanged --fault-seeds 0-2] [--dump DIR]

Each seed renders its clip and runs one session of the whole clip through
the same session code as the window (``harness.Session``, kernel K2's
calls sampled as in a run), after one warm-up.  One JSON line per seed,
sound, under the control (TF32 matmuls) or with a planted fault: the
numbers of ``reference/checks.py``, the session's frames, poses and
keyframes.  With ``--dump`` each session's returned poses, call kinds,
scale epochs and final map (keyframe poses, points, planes, cuboids) go to
``DIR/<cell>_<label>_<seed>.npz``, so that a number can be worked out again
on the host.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="0-11")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="comma-separated faults of faults.py to plant")
    ap.add_argument("--fault-seeds", default="0-2")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--frames", type=int, default=0, help="> 0: sessions of the clip's first frames only")
    ap.add_argument("--dump", default="", help="directory for each session's poses and map (.npz)")
    args = ap.parse_args(argv)

    import torch

    import numpy as np

    from slambench import cells, clip as clip_mod, faults, harness, program, run
    from slambench.reference import checks

    cell = cells.find_cell(cells.load_benchmark(), args.workload)
    dev = args.device
    program.import_program()
    program.load_kernels(dev)

    def session(seed, precision, label="sound"):
        program.set_precision(precision)
        c = clip_mod.make_clip(cell.config, cell.traffic, seed, dev, detections=program.detections,
                               n_frames=args.frames)
        s = harness.Session(index=0)
        t = time.perf_counter()
        with program.K2Samples(run.K2_STRIDE, seed, run.K2_CAP) as k2:
            s.run(program, program.make_tracker(cell.config, dev), c, float("inf"), time.perf_counter)
        wall = time.perf_counter() - t
        res = {**program.session_result(s.tracker), "epochs": s.epochs(), "kinds": s.kinds(),
               "completed": s.completed}
        s.tracker = None
        program.set_precision(cell.config["precision"])
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        nums = checks.numbers([res], c, cell.config, dev, k2_samples=k2.host())
        nums["lost_frames"] = float(s.failed())
        if args.dump:
            traj = res["trajectory"]
            np.savez_compressed(
                Path(args.dump) / f"{cell.name}_{label}_{seed}.npz",
                fids=np.array([f for f, _ in traj], np.int64), poses=np.array([T for _, T in traj]).reshape(-1, 4, 4),
                kinds=np.array([res["kinds"].get(f, "") for f, _ in traj]),
                epochs=np.array([res["epochs"].get(f, -1) for f, _ in traj]),
                kf_valid=res["kf_valid"], kf_pose=res["kf_pose"], kf_frame_id=res["kf_frame_id"],
                pt_pos=res["pt_pos"], plane_coef=res["plane_coef"], plane_obs=res["plane_obs"], cub_pose=res["cub_pose"],
                rescales=res["rescales"], gt_cw=c.gt_cw)
        return {"seed": seed, "precision": precision, "label": label, "start_deg": c.start_deg, "wall_s": wall,
                "poses": len(res["trajectory"]), "keyframes": s.counters["keyframes"], "k2_calls": k2.calls,
                "numbers": nums}

    if args.dump:
        Path(args.dump).mkdir(parents=True, exist_ok=True)
    warm = session(seeds(args.seeds)[0], cell.config["precision"], "warmup")
    print(json.dumps({"warmup": warm}), flush=True)
    for seed in seeds(args.seeds):
        print(json.dumps(session(seed, cell.config["precision"])), flush=True)
    for seed in seeds(args.control_seeds):
        print(json.dumps(session(seed, "tf32", "control")), flush=True)
    for name in filter(None, args.faults.split(",")):
        for seed in seeds(args.fault_seeds):
            with faults.FAULTS[name]():
                print(json.dumps({**session(seed, cell.config["precision"], name), "fault": name}), flush=True)


if __name__ == "__main__":
    main()
