#!/usr/bin/env python3
"""Points-only golden replay with the JAX package, on the CPU: the reference
numbers that the PyTorch port's golden replay is held to.

    JAX_PLATFORMS=cpu python jax_golden_reference.py --frames 200

It renders the first ``--frames`` frames of the bench's golden trajectory
(560 frames, 400 degrees, ``bench.py:bench_golden``) in memory with
``synth.make_batch_renderer``, truncates them to uint8 as ``write_sequence``
stores its PNGs, and drives ``tpuslam.frontend.tracking.Tracker`` mono,
points-only, loop closing off, at the default capacities, with the camera of
the golden ``ICL.yaml``.  The report (frames tracked, the first tracked
frame, keyframes created and live, live points, raw / corrected / keyframe
ATE) is printed as one JSON line; ``chip_smoke.py``'s ``JAX_GOLDEN_200``
holds the one of ``--frames 200``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("TPUSLAM_NO_COMPILE_CACHE", "1")
os.environ.setdefault("TPUSLAM_FORCE_LOCAL_BA", "1")

import numpy as np  # noqa: E402

from tpuslam.apps.common import _corrected_trajectory  # noqa: E402
from tpuslam.core.camera import Camera  # noqa: E402
from tpuslam.core.config import Capacities, FeatureFlags, OrbConfig, SlamConfig  # noqa: E402
from tpuslam.frontend.tracking import Tracker  # noqa: E402
from tpuslam.io import synth  # noqa: E402
from tpuslam.io.trajectory import ate_rmse  # noqa: E402

GOLDEN_FRAMES = 560
GOLDEN_ANGLE_DEG = 400.0


def render(n: int, cam: synth.CameraSpec, total: int = GOLDEN_FRAMES,
           angle: float = GOLDEN_ANGLE_DEG):
    spec = synth.SceneSpec()
    poses = synth.trajectory(total, spec, total_angle_deg=angle)[:n]
    r = synth.make_batch_renderer(cam, spec)
    out = [np.asarray(r(poses[i:i + 8])[0]).astype(np.uint8) for i in range(0, n, 8)]
    return np.concatenate(out), poses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--small", action="store_true",
                    help="320x240, fx 260, 512 features, the capacities of tests/test_long_replay.py")
    args = ap.parse_args(argv)
    if args.small:
        cspec = synth.CameraSpec(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)
        caps = Capacities(max_keypoints=512, max_keyframes=256, max_points=8192, local_ba_points=2048)
        orb = OrbConfig(n_features=512)
    else:
        cspec, caps, orb = synth.CameraSpec(), Capacities(), OrbConfig()
    cfg = SlamConfig().replace(sensor="mono", caps=caps, orb=orb,
                               flags=FeatureFlags(enable_loop_closing=False))
    frames, poses_wc = render(args.frames, cspec)
    cam = Camera.make(cspec.fx, cspec.fy, cspec.cx, cspec.cy, width=cspec.width,
                      height=cspec.height, bf=cspec.fx * cspec.baseline)
    tracker = Tracker(cam, cfg)
    times, first = [], None
    t_all = time.perf_counter()
    for fid, gray in enumerate(frames):
        t0 = time.perf_counter()
        T = tracker.process_image(gray, fid)
        times.append(time.perf_counter() - t0)
        if T is not None and first is None:
            first = fid
    tracker.flush()
    wall = time.perf_counter() - t_all
    gt = [np.linalg.inv(np.asarray(p, np.float64)) for p in poses_wc]
    corrected = _corrected_trajectory(tracker)
    rep = {
        "frames": len(frames),
        "tracked": len(tracker.trajectory),
        "first_tracked": first,
        "keyframes_created": len(tracker._kf_fids),
        "keyframes_live": int(np.asarray(tracker.map.kf_valid).sum()),
        "kf_frame_ids": [int(f) for f in tracker._kf_fids],
        "points": tracker.live_points(),
        "wall_s": wall,
        "median_frame_ms": 1e3 * float(np.median(times)),
    }
    if corrected:
        rep["ate_raw_m"] = ate_rmse([p for _, p in tracker.trajectory],
                                    [gt[f] for f, _ in tracker.trajectory])[0]
        rep["ate_m"] = ate_rmse([p for _, p in corrected], [gt[f] for f, _ in corrected])[0]
        kv = np.asarray(tracker.map.kf_valid)
        fid = np.asarray(tracker.map.kf_frame_id)
        pose = np.asarray(tracker.map.kf_pose)
        sel = [s for s in np.flatnonzero(kv) if np.isfinite(pose[s]).all()]
        if len(sel) >= 3:
            rep["kf_ate_m"] = ate_rmse([pose[s] for s in sel], [gt[int(fid[s])] for s in sel])[0]
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
