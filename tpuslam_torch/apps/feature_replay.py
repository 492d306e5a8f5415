"""Feature-level replay of the port: ``Tracker.process_frame`` driven by the
synthetic room of ``io/synthetic.py``, with no image in the loop.

    python -m tpuslam_torch.apps.feature_replay --frames 120            # mono, on cuda:0
    python -m tpuslam_torch.apps.feature_replay --frames 60 --rgbd      # RGB-D, planes and cuboids
    python -m tpuslam_torch.apps.feature_replay --frames 24 --device cpu

The configuration is the golden one at full width: the golden ``ICL.yaml``
camera (640x480, fx = fy = 520, bf = 39), 1024 features, the default
capacities (512 keyframes, 32768 points) and the default flags (loop
closing on).  The room holds ``N_POINTS`` points, so that every frame of the
trajectory sees more than 1024 of them and every frame is full
(``tests/test_torch_synthetic.py`` checks it).  All frames are rendered on
the device before the loop.

``--rgbd`` gives each frame its noisy depth and right-view u
(``render_frame(with_depth=True)``), the room its three wall planes and two
cuboids, and each frame their detections (``render_plane_detections``,
``render_cuboid_detections``); the flags add ``rgbd_icl --planes --objects``'s
semantic ones, so that the plane and cuboid bundles run in the local BA.

The report is ``apps/common.finish``'s (the raw ATE is Sim3-aligned for
mono, SE3 for RGB-D) plus the first tracked frame, the keyframes' frame ids
and the valid factors per bundle over the local BAs.
``jax_golden_reference.py --synthetic`` runs the JAX package's ``Tracker``
on the same frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..core.camera import Camera
from ..core.config import FeatureFlags, SlamConfig
from ..frontend.tracking import Tracker
from ..io import synthetic
from ..utils.profiler import Profiler
from .common import finish, run_loop

N_POINTS = 2500
SEED = 0
CAMERA = dict(fx=520.0, fy=520.0, cx=319.5, cy=239.5, width=640, height=480, bf=39.0)


def config(rgbd: bool = False) -> SlamConfig:
    """The replay's configuration."""
    flags = FeatureFlags()
    if rgbd:
        flags = dataclasses.replace(flags, detect_plane=True, detect_object=True, optimize_with_plane_3d=True,
                                    optimize_with_cuboid_2d=True)
    return SlamConfig().replace(sensor="rgbd" if rgbd else "mono", flags=flags)


def render(n_frames: int, device, rgbd: bool = False):
    """(scene, camera, the ``Frame`` of each view on ``device``, per frame
    the (plane, cuboid) detections or None)."""
    cfg, kw = config(rgbd), CAMERA
    cam = Camera.make(kw["fx"], kw["fy"], kw["cx"], kw["cy"], device, width=kw["width"], height=kw["height"],
                      bf=kw["bf"])
    scene = synthetic.make_room_scene(N_POINTS, n_frames, SEED, with_planes=rgbd, with_cuboids=rgbd)
    caps = cfg.caps
    frames = [synthetic.render_frame(scene, f, cam, n_features=cfg.orb.n_features, with_depth=rgbd, device=device)
              for f in range(n_frames)]
    dets = None
    if rgbd:
        dets = [(synthetic.render_plane_detections(scene, f, caps.max_planes_per_frame, device=device),
                 synthetic.render_cuboid_detections(scene, f, cam, caps.max_cuboids_per_frame, device=device))
                for f in range(n_frames)]
    return scene, cam, frames, dets


def run(n_frames: int, device="cuda:0", rgbd: bool = False):
    """Render, track, report.  Returns (report, tracker)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    scene, cam, frames, dets = render(n_frames, device, rgbd)
    tracker = Tracker(cam, config(rgbd), device=device)
    per_frame = (lambda item: dets[item[0]]) if rgbd else None
    times = run_loop(tracker, enumerate(frames), Profiler(), per_frame=per_frame)
    gt = scene.poses.astype(np.float64)
    rep = finish(tracker, times, gt=gt, metric=rgbd)
    rep.update(first_tracked=tracker.trajectory[0][0] if tracker.trajectory else None,
               median_frame_ms=1e3 * rep["median_frame_s"],
               kf_frame_ids=[int(f) for f in tracker._kf_fids],
               **{f"ba_{k}_factors": int(v) for k, v in tracker.ba_factors.items()})
    return rep, tracker


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--rgbd", action="store_true", help="RGB-D with plane and cuboid detections")
    args = ap.parse_args(argv)
    rep, _ = run(args.frames, args.device, rgbd=args.rgbd)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
