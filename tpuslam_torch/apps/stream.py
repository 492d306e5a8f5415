"""Online streaming front end (port of ``tpuslam/apps/stream.py``): the
transport-agnostic analogue of the reference's ROS nodes
(Examples/ROS/ORB_SLAM2/src/ros_mono.cc, ros_rgbd.cc, ros_stereo.cc: an
ImageGrabber callback feeding System::Track* and publishing the pose).  It
speaks a line protocol any process can drive:

  stdin, one frame per line:
      <frame_id> <image_path>                      (mono)
      <frame_id> <image_path> <depth_path>         (rgbd)
      <frame_id> <left_path> <right_path>          (stereo)
  stdout, one line per processed frame:
      {"frame_id": ..., "state": "OK"|"LOST"|"INIT", "pose": [16 floats] | null,
       "n_inliers": ..., "n_kf": ..., "n_pt": ...}

A line with the wrong number of fields or a frame id that is not an integer
gets an ``{"error": ..., "line": ...}`` line and is skipped.  A blank line or
EOF ends the stream; the trajectory and map files are dumped like the
dataset apps' and the JSON report is printed last; the profiler's table goes
to stderr.  Images are read with ``io/png.py`` (``cv2.imread`` in the
reference), depth divided by ``--depth-factor``.  The ``Tracker`` is built
as the dataset CLIs build it (``common.make_tracker``).

Usage:
  ls frames/*.png | awk '{print NR" "$0}' | python -m tpuslam_torch.apps.stream --sensor mono
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..core.camera import Camera
from ..core.config import SlamConfig
from ..frontend.tracking import Tracker
from ..io import png
from ..utils.profiler import Profiler
from .common import LoopTimes, apply_features, finish, make_tracker, native_io

_STATE_NAME = {0: "INIT", 1: "OK", 2: "LOST"}


def _read_gray(path: str, native: bool) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return png.imread_gray(path, native)


def _read_depth(path: str, depth_factor: float, native: bool) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return png.imread_unchanged(path, native).astype(np.float32) / np.float32(depth_factor)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sensor", choices=("mono", "rgbd", "stereo"), default="mono")
    ap.add_argument("--fx", type=float, default=500.0)
    ap.add_argument("--fy", type=float, default=500.0)
    ap.add_argument("--cx", type=float, default=320.0)
    ap.add_argument("--cy", type=float, default=240.0)
    ap.add_argument("--bf", type=float, default=40.0)
    ap.add_argument("--depth-factor", type=float, default=5000.0, help="raw depth units per metre (TUM convention)")
    ap.add_argument("--features", type=int, default=0)
    ap.add_argument("--out", default=".")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--resume", default="")
    ap.add_argument("--localization-only", action="store_true", help="freeze the map and only localize against it")
    ap.add_argument("--save-kitti", action="store_true")
    ap.add_argument("--vocab", default="",
                    help="ORBvoc .txt/.bin vocabulary path, or 'lsh' ('train' is not available in streaming mode: "
                    "frames arrive online)")
    ap.add_argument("--device", default="cuda:0", help="torch device the Tracker runs on (cuda:0, or cpu)")
    args = ap.parse_args(argv)

    cam = Camera.make(args.fx, args.fy, args.cx, args.cy, args.device, bf=args.bf)
    cfg = apply_features(SlamConfig().replace(sensor=args.sensor), args.features or 1024)
    tracker = make_tracker(args, cam, cfg)
    native = native_io(args)

    prof = Profiler()
    frame_times = []
    t_loop = time.perf_counter()
    n_fields = {"mono": 2, "rgbd": 3, "stereo": 3}[args.sensor]
    for line in sys.stdin:
        line = line.strip()
        if not line:
            break
        parts = line.split()
        if len(parts) != n_fields:
            print(json.dumps({
                "error": f"{args.sensor} frames need {n_fields} fields "
                         f"(<frame_id> <path>{' <path2>' if n_fields == 3 else ''}), got {len(parts)}",
                "line": line}), flush=True)
            continue
        try:
            fid = int(parts[0])
        except ValueError:
            print(json.dumps({"error": f"frame id must be an integer, got {parts[0]!r}", "line": line}), flush=True)
            continue
        t0 = time.perf_counter()
        with prof.section("time single frame"):
            if args.sensor == "stereo":
                tracker.process_stereo_pair(_read_gray(parts[1], native), _read_gray(parts[2], native), fid)
            elif args.sensor == "rgbd":
                tracker.process_image(_read_gray(parts[1], native), fid,
                                      depth=_read_depth(parts[2], args.depth_factor, native))
            else:
                tracker.process_image(_read_gray(parts[1], native), fid)
        frame_times.append(time.perf_counter() - t0)
        pose = np.asarray(tracker.T_cur).reshape(-1).tolist() if tracker.state == Tracker.OK else None
        print(json.dumps({"frame_id": fid, "state": _STATE_NAME[tracker.state], "pose": pose,
                          "n_inliers": int(tracker.n_inliers), "n_kf": tracker.n_kf, "n_pt": tracker.n_pt}),
              flush=True)

    report = finish(tracker, LoopTimes(frame_times, time.perf_counter() - t_loop), out_dir=args.out,
                    metric=args.sensor != "mono", save_kitti_traj=args.save_kitti, checkpoint=args.checkpoint)
    print(json.dumps(report), flush=True)
    # stdout carries the machine-readable JSON; the profiler's table goes to stderr
    prof.print_aggregated(file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
