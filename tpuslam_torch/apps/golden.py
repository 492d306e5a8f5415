"""Golden-sequence replay of the port (counterpart of
``bench.py:bench_golden`` / ``_golden_replay`` with ``mono_icl``).

    python -m tpuslam_torch.apps.golden --frames 200              # on cuda:0
    python -m tpuslam_torch.apps.golden --frames 200 --flagship   # planes and objects
    python -m tpuslam_torch.apps.golden --frames 48 --small --device cpu

The bench's golden trajectory (560 frames, 400 degrees) is rendered on the
device, truncated to uint8 as the PNG frames of ``write_sequence`` hold it,
and kept in pinned host memory; ``run_loop`` feeds the first ``--frames``
of it to a mono ``Tracker`` with loop closing off, at the capacities of
``--small`` or the defaults, and ``finish`` reports with the reference's
keys.  The camera is the golden ``ICL.yaml`` one (fx = fy = 520, bf = 39).

``--flagship`` is ``mono_icl --planes --objects`` on that ``ICL.yaml``,
which sets none of the optional keys (bench.py's first golden
configuration): each frame's offline plane and cuboid detections are made in
memory from the renderer's per-primitive counts and face sums, as
``write_sequence`` writes them and ``mono_icl`` reads them, and a per-frame
hook hands them to the ``Tracker``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.camera import Camera
from ..core.config import Capacities, FeatureFlags, OrbConfig, SlamConfig
from ..frontend.tracking import Tracker
from ..io import synth
from ..utils.profiler import Profiler
from .common import finish, run_loop

GOLDEN_FRAMES = 560
GOLDEN_ANGLE_DEG = 400.0


def flagship_flags() -> FeatureFlags:
    """``mono_icl --planes --objects`` (tpuslam/apps/mono_icl.py:34-53) with
    the golden ICL.yaml, loop closing off."""
    return FeatureFlags(
        detect_object=True, read_offline_cuboidtxt=True, detect_plane=True, read_offline_planetxt=True,
        associate_cuboid_with_classname=True, optimize_with_plane_3d=True, optimize_with_cuboid_2d=True,
        enable_ground_height_scale=True, enable_loop_closing=False,
    )


def golden_setup(small: bool = False, flagship: bool = False):
    """(camera spec, config): full width, or the 320x240 / 512-feature cut
    with the capacities of ``tests/test_long_replay.py``; points only, or
    the flagship's flags."""
    if small:
        cspec = synth.CameraSpec(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)
        caps = Capacities(max_keypoints=512, max_keyframes=256, max_points=8192, local_ba_points=2048)
        orb = OrbConfig(n_features=512)
    else:
        cspec, caps, orb = synth.CameraSpec(), Capacities(), OrbConfig()
    flags = flagship_flags() if flagship else FeatureFlags(enable_loop_closing=False)
    return cspec, SlamConfig().replace(sensor="mono", caps=caps, orb=orb, flags=flags)


def render_golden(n_frames: int, cspec, device, cfg=None):
    """(frames (F, H, W) uint8 on the host, pinned on a CUDA run;
    gt world->camera poses (F, 4, 4) float64).  With ``cfg`` (the flagship's)
    also each frame's (plane, cuboid) detections, a list of F pairs."""
    spec = synth.SceneSpec()
    poses = synth.trajectory(GOLDEN_FRAMES, spec, total_angle_deg=GOLDEN_ANGLE_DEG)[:n_frames]
    renderer = synth.make_batch_renderer(cspec, spec, device)
    gt = np.linalg.inv(poses.astype(np.float64))
    if cfg is None:
        frames = synth.render_uint8(renderer, poses).cpu()
    else:
        frames, counts, sums = synth.render_uint8(renderer, poses, stats=True)
        frames = frames.cpu()
        caps = cfg.caps
        dets = [synth.frame_detections(poses[f], counts[f], sums[f], spec, cspec, caps.max_planes_per_frame,
                                       caps.max_cuboids_per_frame) for f in range(len(poses))]
    if torch.device(device).type == "cuda":
        frames = frames.pin_memory()
    return (frames, gt) if cfg is None else (frames, gt, dets)


def run_golden(n_frames: int = 200, device="cuda:0", small: bool = False, count_waits: bool = False,
               rendered=None, flagship: bool = False):
    """Render, track, report.  ``rendered``: what :func:`render_golden`
    returns, to replay instead of rendering on ``device``.  ``flagship``:
    planes and objects.  Returns (report, tracker)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cspec, cfg = golden_setup(small, flagship)
    if rendered is None:
        rendered = render_golden(n_frames, cspec, device, cfg if flagship else None)
    frames, gt = rendered[:2]
    per_frame = rendered[2].__getitem__ if flagship else None
    cam = Camera.make(cspec.fx, cspec.fy, cspec.cx, cspec.cy, device, width=cspec.width,
                      height=cspec.height, bf=cspec.fx * cspec.baseline)
    tracker = Tracker(cam, cfg, device=device)
    prof = Profiler()
    t0 = time.perf_counter()
    items = ((i, frames[i]) for i in range(n_frames))
    ft = run_loop(tracker, items, prof, count_waits=count_waits, per_frame=per_frame)
    tracker.flush()
    if tracker.device.type == "cuda":
        torch.cuda.synchronize(tracker.device)
    wall = time.perf_counter() - t0
    rep = finish(tracker, ft, gt=gt)
    rep.update(first_tracked=tracker.trajectory[0][0] if tracker.trajectory else None,
               wall_s=wall, frames_per_s=n_frames / wall,
               median_frame_ms=1e3 * rep["median_frame_s"],
               kf_frame_ids=[int(f) for f in tracker._kf_fids])
    if flagship:
        rep.update(rescales=tracker.n_rescales,
                   **{f"ba_{k}_factors": int(v) for k, v in tracker.ba_factors.items()})
    return rep, tracker


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--flagship", action="store_true", help="planes and objects (mono_icl --planes --objects)")
    args = ap.parse_args(argv)
    rep, _ = run_golden(args.frames, args.device, args.small, flagship=args.flagship)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
