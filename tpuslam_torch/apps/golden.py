"""Golden-sequence replay of the port, points-only (counterpart of
``bench.py:bench_golden`` / ``_golden_replay`` with ``mono_icl``).

    python -m tpuslam_torch.apps.golden --frames 200            # on cuda:0
    python -m tpuslam_torch.apps.golden --frames 48 --small --device cpu

The bench's golden trajectory (560 frames, 400 degrees) is rendered on the
device, truncated to uint8 as the PNG frames of ``write_sequence`` hold it,
and kept in pinned host memory; ``run_loop`` feeds the first ``--frames``
of it to a mono ``Tracker`` with loop closing off, at the capacities of
``--small`` or the defaults, and ``finish`` reports with the reference's
keys.  The camera is the golden ``ICL.yaml`` one (fx = fy = 520, bf = 39).
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


def golden_setup(small: bool = False):
    """(camera spec, config): full width, or the 320x240 / 512-feature cut
    with the capacities of ``tests/test_long_replay.py``."""
    if small:
        cspec = synth.CameraSpec(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)
        caps = Capacities(max_keypoints=512, max_keyframes=256, max_points=8192, local_ba_points=2048)
        orb = OrbConfig(n_features=512)
    else:
        cspec, caps, orb = synth.CameraSpec(), Capacities(), OrbConfig()
    cfg = SlamConfig().replace(sensor="mono", caps=caps, orb=orb,
                               flags=FeatureFlags(enable_loop_closing=False))
    return cspec, cfg


def render_golden(n_frames: int, cspec, device):
    """(frames (F, H, W) uint8 on the host, pinned on a CUDA run;
    gt world->camera poses (F, 4, 4) float64)."""
    spec = synth.SceneSpec()
    poses = synth.trajectory(GOLDEN_FRAMES, spec, total_angle_deg=GOLDEN_ANGLE_DEG)[:n_frames]
    frames = synth.render_uint8(synth.make_batch_renderer(cspec, spec, device), poses).cpu()
    if torch.device(device).type == "cuda":
        frames = frames.pin_memory()
    gt = np.linalg.inv(poses.astype(np.float64))
    return frames, gt


def run_golden(n_frames: int = 200, device="cuda:0", small: bool = False, count_waits: bool = False,
               rendered=None):
    """Render, track, report.  ``rendered``: (frames, gt) of
    :func:`render_golden` to replay instead of rendering on ``device``.
    Returns (report, tracker)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cspec, cfg = golden_setup(small)
    frames, gt = rendered if rendered is not None else render_golden(n_frames, cspec, device)
    cam = Camera.make(cspec.fx, cspec.fy, cspec.cx, cspec.cy, device, width=cspec.width,
                      height=cspec.height, bf=cspec.fx * cspec.baseline)
    tracker = Tracker(cam, cfg, device=device)
    prof = Profiler()
    t0 = time.perf_counter()
    items = ((i, frames[i]) for i in range(n_frames))
    ft = run_loop(tracker, items, prof, count_waits=count_waits)
    tracker.flush()
    if tracker.device.type == "cuda":
        torch.cuda.synchronize(tracker.device)
    wall = time.perf_counter() - t0
    rep = finish(tracker, ft, gt=gt)
    rep.update(first_tracked=tracker.trajectory[0][0] if tracker.trajectory else None,
               wall_s=wall, frames_per_s=n_frames / wall,
               median_frame_ms=1e3 * rep["median_frame_s"],
               kf_frame_ids=[int(f) for f in tracker._kf_fids])
    return rep, tracker


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    rep, _ = run_golden(args.frames, args.device, args.small)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
