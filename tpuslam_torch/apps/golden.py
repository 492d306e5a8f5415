"""Golden-sequence replay of the port (counterpart of
``bench.py:bench_golden`` / ``_golden_replay`` with ``mono_icl``).

    python -m tpuslam_torch.apps.golden --frames 200              # on cuda:0
    python -m tpuslam_torch.apps.golden --frames 200 --flagship   # planes and objects
    python -m tpuslam_torch.apps.golden --frames 200 --rgbd       # RGB-D, online planes, objects
    python -m tpuslam_torch.apps.golden --frames 100 --stereo     # stereo, points only
    python -m tpuslam_torch.apps.golden --frames 48 --small --device cpu
    python -m tpuslam_torch.apps.golden --frames 100 --loops      # loop closing on

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

``--rgbd`` is ``rgbd_icl --planes online --objects`` on that ``ICL.yaml``
(``bf`` 39, ``ThDepth`` 40, so points closer than 3 m are close): each
frame's depth is the renderer's as the golden depth PNGs store it and
``IclDataset`` reads it (``synth.quantize_depth``), planes are segmented
online from it on every frame, and the cuboid rows are the flagship's.
``--stereo`` is ``stereo_kitti``'s configuration (points only) with a right
view rendered at the camera moved by the ``ICL.yaml`` baseline (0.075 m)
along its own +x axis, through ``Tracker.process_stereo_pair``.  Both report
the error without scale (their maps are metric) and the valid stereo factors
over the local BAs (``stereo_factors``); ``--rgbd`` adds the plane detections
over the frames (``online_planes``), ``--stereo`` the median per frame of the
left keypoints with a stereo match (``stereo_matches``).

``--loops`` turns loop closing on in any mode, as every app of the
reference builds its ``Tracker`` (``FeatureFlags.enable_loop_closing`` is on
by default): points-only runs with the default ``FeatureFlags()``, the
other modes with their flags and the loop flag on.  The codebook is the
seeded 1024-word one that ``mono_icl`` gets without ``--vocab``.  The report
adds ``loops`` (from ``finish``), the loop closer's stages as ``loop_*`` in
``kf_stage_ms``, ``loop_gates`` (how many keyframes reached each gate of
the detector) and ``loop_closures`` (the frame ids of each closure's two
keyframes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..core.config import Capacities, FeatureFlags, OrbConfig, SlamConfig
from ..frontend.tracking import Tracker
from ..io import synth
from ..semantic.detect import detect_planes_online
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


def rgbd_flags() -> FeatureFlags:
    """``rgbd_icl --planes online --objects`` (tpuslam/apps/rgbd_icl.py:33-41),
    loop closing off."""
    return FeatureFlags(
        detect_plane=True, read_offline_planetxt=False, detect_object=True, read_offline_cuboidtxt=True,
        optimize_with_plane_3d=True, optimize_with_cuboid_2d=True, enable_loop_closing=False,
    )


class Rendered(NamedTuple):
    """What :func:`render_golden` returns; the images stay on the host
    (pinned on a card run) and go up one frame ahead of the tracker."""

    frames: torch.Tensor  # (F, H, W) uint8 (the left view for stereo)
    gt: np.ndarray  # (F, 4, 4) float64 world->camera
    dets: Optional[list] = None  # per frame (plane, cuboid) detections
    depth: Optional[torch.Tensor] = None  # (F, H, W) float32 metres, quantized as the PNGs
    right: Optional[torch.Tensor] = None  # (F, H, W) uint8 right view


def golden_setup(small: bool = False, flagship: bool = False, rgbd: bool = False, stereo: bool = False,
                 loops: bool = False):
    """(camera spec, config): full width, or the 320x240 / 512-feature cut
    with the capacities of ``tests/test_long_replay.py``; mono points only,
    the flagship's flags, RGB-D with ``rgbd_icl``'s or stereo points only;
    with ``loops``, loop closing on."""
    if small:
        cspec = synth.CameraSpec(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)
        caps = Capacities(max_keypoints=512, max_keyframes=256, max_points=8192, local_ba_points=2048)
        orb = OrbConfig(n_features=512)
    else:
        cspec, caps, orb = synth.CameraSpec(), Capacities(), OrbConfig()
    flags = (flagship_flags() if flagship else rgbd_flags() if rgbd
             else FeatureFlags(enable_loop_closing=False))
    if loops:
        flags = dataclasses.replace(flags, enable_loop_closing=True)
    sensor = "rgbd" if rgbd else "stereo" if stereo else "mono"
    return cspec, SlamConfig().replace(sensor=sensor, caps=caps, orb=orb, flags=flags)


def render_golden(n_frames: int, cspec, device, cfg=None, depth: bool = False, right: bool = False) -> Rendered:
    """The first ``n_frames`` golden frames, rendered on ``device``, and
    their ground truth.  With ``cfg`` (the flagship's or RGB-D's) also each
    frame's (plane, cuboid) detections; with ``depth`` the depth maps; with
    ``right`` the stereo right view."""
    spec = synth.SceneSpec()
    poses = synth.trajectory(GOLDEN_FRAMES, spec, total_angle_deg=GOLDEN_ANGLE_DEG)[:n_frames]
    renderer = synth.make_batch_renderer(cspec, spec, device)
    gt = np.linalg.inv(poses.astype(np.float64))
    out = synth.render_uint8(renderer, poses, stats=cfg is not None, depth=depth)
    out = out if isinstance(out, tuple) else (out,)
    pin = torch.device(device).type == "cuda"

    def host(t):
        t = t.cpu()
        return t.pin_memory() if pin else t

    dets = None
    if cfg is not None:
        caps = cfg.caps
        counts, sums = out[1], out[2]
        dets = [synth.frame_detections(poses[f], counts[f], sums[f], spec, cspec, caps.max_planes_per_frame,
                                       caps.max_cuboids_per_frame) for f in range(len(poses))]
    rgt = None
    if right:
        rgt = host(synth.render_uint8(renderer, synth.right_poses(poses, cspec.baseline)))
    return Rendered(frames=host(out[0]), gt=gt, dets=dets, depth=host(out[-1]) if depth else None, right=rgt)


def run_golden(n_frames: int = 200, device="cuda:0", small: bool = False, count_waits: bool = False,
               rendered: Optional[Rendered] = None, flagship: bool = False, rgbd: bool = False,
               stereo: bool = False, loops: bool = False):
    """Render, track, report.  ``rendered``: what :func:`render_golden`
    returns, to replay instead of rendering on ``device``.  ``flagship``:
    planes and objects; ``rgbd``: RGB-D with online planes and objects;
    ``stereo``: a stereo pair, points only; ``loops``: loop closing on.
    Returns (report, tracker)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cspec, cfg = golden_setup(small, flagship, rgbd, stereo, loops)
    if rendered is None:
        rendered = render_golden(n_frames, cspec, device, cfg if flagship or rgbd else None, depth=rgbd,
                                 right=stereo)
    frames, gt = rendered.frames, rendered.gt
    cam = Camera.make(cspec.fx, cspec.fy, cspec.cx, cspec.cy, device, width=cspec.width,
                      height=cspec.height, bf=cspec.fx * cspec.baseline)
    tracker = Tracker(cam, cfg, device=device)
    per_frame = None
    online = []  # plane detections per frame (device scalars)
    if flagship:
        def per_frame(item):
            return rendered.dets[item[0]]
    elif rgbd:
        def per_frame(item):
            pdet = detect_planes_online(item[2].to(torch.float32), cam, cfg.caps.max_planes_per_frame)
            online.append(pdet.valid.sum())
            return pdet, rendered.dets[item[0]][1]
    extra = rendered.depth if rgbd else rendered.right if stereo else None
    prof = Profiler()
    items = ((i, frames[i]) + (() if extra is None else (extra[i],)) for i in range(n_frames))
    times = run_loop(tracker, items, prof, count_waits=count_waits, per_frame=per_frame)
    rep = finish(tracker, times, gt=gt, metric=rgbd or stereo)
    rep.update(first_tracked=tracker.trajectory[0][0] if tracker.trajectory else None,
               median_frame_ms=1e3 * rep["median_frame_s"],
               kf_frame_ids=[int(f) for f in tracker._kf_fids])
    if flagship:
        rep["rescales"] = tracker.n_rescales
    if flagship or rgbd:
        rep.update({f"ba_{k}_factors": int(v) for k, v in tracker.ba_factors.items() if k != "stereo"})
    if rgbd or stereo:
        rep["stereo_factors"] = int(tracker.ba_factors.get("stereo", 0))
    if rgbd:
        rep["online_planes"] = int(torch.stack(online).sum()) if online else 0
    if loops:
        rep["loop_gates"] = dict(tracker.loop_closer.gates)
        rep["loop_closures"] = [list(c) for c in tracker.loop_closer.closures]
    return rep, tracker


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--flagship", action="store_true", help="planes and objects (mono_icl --planes --objects)")
    mode.add_argument("--rgbd", action="store_true", help="RGB-D, online planes and objects (rgbd_icl)")
    mode.add_argument("--stereo", action="store_true", help="a stereo pair, points only (stereo_kitti)")
    ap.add_argument("--loops", action="store_true", help="loop closing on (the Tracker's default)")
    args = ap.parse_args(argv)
    rep, _ = run_golden(args.frames, args.device, args.small, flagship=args.flagship, rgbd=args.rgbd,
                        stereo=args.stereo, loops=args.loops)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
