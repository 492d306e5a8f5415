#!/usr/bin/env python3
"""Golden replay with the JAX package, on the CPU: the reference numbers that
the PyTorch port's golden replays are held to.

    JAX_PLATFORMS=cpu python jax_golden_reference.py --frames 200
    JAX_PLATFORMS=cpu python jax_golden_reference.py --frames 200 --flagship

It renders the first ``--frames`` frames of the bench's golden trajectory
(560 frames, 400 degrees, ``bench.py:bench_golden``) in memory with
``synth.make_batch_renderer``, truncates them to uint8 as ``write_sequence``
stores its PNGs, and drives ``tpuslam.frontend.tracking.Tracker`` mono,
points-only, loop closing off, at the default capacities, with the camera of
the golden ``ICL.yaml``.  The report (frames tracked, the first tracked
frame, keyframes created and live, live points, raw / corrected / keyframe
ATE) is printed as one JSON line; ``chip_smoke.py``'s ``JAX_GOLDEN_200``
holds the one of ``--frames 200``.

``--flagship`` runs the configuration of ``mono_icl --planes --objects`` on
the golden ``ICL.yaml`` (loops off): each frame's plane and cuboid rows are
made by ``synth._plane_rows_for_frame`` / ``_cuboid_lines_for_frame`` and
written with ``write_sequence``'s formatting to a temporary folder, then read
back with ``read_offline_planes`` / ``read_offline_cuboids`` (the cuboids
with the frame's float32 camera-to-world pose), as ``mono_icl`` reads them.
The report adds the planes and cuboids made, how often the metric rescale
fired, and the valid plane and bbox factors summed over the local BAs;
``chip_smoke.py``'s ``JAX_FLAGSHIP_200`` holds the one of ``--frames 200``.

``--rgbd`` runs ``rgbd_icl --planes online --objects`` on the golden
``ICL.yaml`` (loops off): each frame's depth is the renderer's, stored as
``write_sequence`` stores its depth PNGs (``uint16(clip(depth * 5000))``)
and read back as ``IclDataset`` reads them (``/ 5000`` in float32); planes
are segmented online from it on every frame (``detect_planes_online``) and
the cuboid rows are made and read as for ``--flagship``.  ``--stereo`` runs
``stereo_kitti``'s configuration (points only) on the golden frames with a
right view rendered at the camera moved 0.075 m (the ICL.yaml baseline)
along its own +x axis, through ``Tracker.process_stereo_pair``.  Both
report the trajectory error without scale (the maps are metric) and add
``stereo_factors`` (valid stereo factors over the local BAs);
``--rgbd`` adds ``online_planes`` (plane detections over the frames),
``--stereo`` ``stereo_matches`` (the median per frame of left keypoints with
a stereo match).  ``chip_smoke.py``'s ``JAX_RGBD_100`` and
``JAX_STEREO_100`` hold the runs of ``--rgbd --frames 100`` and
``--stereo --frames 100``.

``--loops`` turns loop closing on, the ``Tracker``'s default: points-only
runs with the default ``FeatureFlags()``, the other modes with their flags
and the loop flag on; the place-recognition codebook is the seeded
1024-word one that ``mono_icl`` gets without ``--vocab``.  The report adds
``loops`` (closures accepted) and ``loop_gates``: how many keyframes reached
each gate of the loop detector (``stats``: past the 10-keyframe and
refractory rules; ``covisible``: with a covisible neighbour; ``words``: a
candidate sharing words; ``score``: a candidate past the shared-word and
score gates; ``consistent``: a candidate consistent over the covisibility
groups; ``sim3``: a Sim3 accepted), read from the detector's debug lines, and
``loop_closures``: the frame ids of each closure's two keyframes.
``chip_smoke.py``'s ``JAX_GOLDEN_LOOPS_100`` holds the run of ``--loops
--frames 100``.

``--localize`` drives the JAX package's ``mono_icl`` CLI from disk, as
``chip_smoke.py``'s phases 14 and 15 drive the port's: the first
``--frames`` golden frames are written as ``write_sequence`` writes them
(``rgb/``, ``rgb.txt``, ``odom.txt``, ``ICL.yaml``; the PNGs by
``cv2.imwrite``) to a temporary folder, then ``mono_icl <folder> --vocab lsh
--checkpoint ck`` maps it (loops on, the default) and ``mono_icl <folder>
--vocab lsh --resume ck --localization-only`` replays it against the frozen
map.  It prints one JSON line with both reports and, for the second run,
the frames it tracked (``loc_tracked``), the first of them
(``loc_first_tracked``) and the Sim3-aligned ATE of their raw poses
(``loc_ate_raw_m``), read from its ``TrajectoryRaw.txt``;
``chip_smoke.py``'s ``JAX_LOCALIZE_100`` holds the run of ``--localize
--frames 100``.

``--stream`` drives the JAX package's stdin stream node
(``tpuslam.apps.stream``, mono, loop closing on, ``--vocab lsh``, the golden
``ICL.yaml``'s camera as flags) over the first ``--frames`` golden frames
written as ``--localize`` writes them, one ``<frame_id> <path>`` line each,
as ``chip_smoke.py``'s stream phase pipes them to the port's node.  It
prints one JSON line: the frame lines' ids in order (``frame_ids_in_order``),
their states counted (``states``), the final report, and from its
``TrajectoryRaw.txt`` the frames tracked, the first of them and the
Sim3-aligned raw ATE.  ``chip_smoke.py``'s ``JAX_STREAM_30`` holds the run
of ``--stream --frames 30``, and its ``JAX_GOLDEN_LOOPS_30`` (the 2-rank
pipeline's reference) the run of ``--loops --frames 30``.

``--synthetic`` drives ``Tracker.process_frame`` with the feature-level
frames of ``tpuslam.io.synthetic`` (no image): the room of
``make_room_scene(2500, --frames, seed=0)``, each frame's 1024 features
from ``render_frame``, the golden ``ICL.yaml`` camera, the default
capacities and flags (loop closing on), the configuration of the port's
``tpuslam_torch/apps/feature_replay.py``.  With ``--rgbd`` the frames carry
depth and the room its planes and cuboids, whose detections
(``render_plane_detections``, ``render_cuboid_detections``) each frame
hands to the ``Tracker``, with ``rgbd_icl --planes --objects``'s semantic
flags.  The ATE is against the scene's poses.  ``chip_smoke.py``'s
``JAX_SYNTHETIC_MONO_120`` and ``JAX_SYNTHETIC_RGBD_60`` hold the runs of
``--synthetic --frames 120`` and ``--synthetic --rgbd --frames 60``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
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
from tpuslam.graph import lm as jlm  # noqa: E402
from tpuslam.kernels import stereo as jks  # noqa: E402
from tpuslam.map import mapstate as jms  # noqa: E402
from tpuslam.place import loop as jloop  # noqa: E402
from tpuslam.semantic.detect import detect_planes_online, read_offline_cuboids, read_offline_planes  # noqa: E402

GOLDEN_FRAMES = 560
GOLDEN_ANGLE_DEG = 400.0
DEPTH_FACTOR = 5000.0  # write_sequence's depth PNG scale, IclDataset's depth_factor


def right_poses(poses_wc, baseline: float):
    """Camera-to-world poses of the right view: each camera moved by
    ``baseline`` along its own +x axis, so that uL - uR = bf / Z."""
    out = np.array(poses_wc, np.float32)
    out[:, :3, 3] += np.float32(baseline) * out[:, :3, 0]
    return out


def render(n: int, cam: synth.CameraSpec, total: int = GOLDEN_FRAMES,
           angle: float = GOLDEN_ANGLE_DEG, det_dir: str = "", depth: bool = False, right: bool = False,
           planes: bool = True):
    """(uint8 frames, camera-to-world poses, depth or None, right frames or
    None).  With ``det_dir``, each frame's cuboid rows (and with ``planes``
    its plane rows) are written there as ``write_sequence`` writes them;
    ``depth``: the depth maps as ``write_sequence`` stores and
    ``IclDataset`` reads them; ``right``: the right view's uint8 frames."""
    spec = synth.SceneSpec()
    poses = synth.trajectory(total, spec, total_angle_deg=angle)[:n]
    r = synth.make_batch_renderer(cam, spec)
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float32), np.arange(cam.height, dtype=np.float32))
    d_cam = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1)
    out, depths, rights = [], [], []
    poses_r = right_poses(poses, cam.baseline) if right else None
    for i in range(0, n, 8):
        g_b, t_b, id_b = (np.asarray(x) for x in r(poses[i:i + 8]))
        out.append(g_b.astype(np.uint8))
        if depth:
            d16 = np.clip(t_b * DEPTH_FACTOR, 0, 65535).astype(np.uint16)
            depths.append(d16.astype(np.float32) / DEPTH_FACTOR)
        if right:
            rights.append(np.asarray(r(poses_r[i:i + 8])[0]).astype(np.uint8))
        for j in range(len(g_b)) if det_dir else ():
            f = i + j
            rows = synth._plane_rows_for_frame(poses[f], id_b[j], t_b[j][..., None] * d_cam, spec, 1500)
            with open(os.path.join(det_dir, f"{f}_offline_plane_multiplane.txt"), "w") as fh:
                for row in rows if planes else ():
                    fh.write(" ".join(f"{x:.9f}" for x in row) + "\n")
            lines = synth._cuboid_lines_for_frame(poses[f], id_b[j], spec, 400)
            with open(os.path.join(det_dir, f"{f:04d}_3d_cuboids.txt"), "w") as fh:
                fh.write("\n".join(lines) + ("\n" if lines else ""))
    return (np.concatenate(out), poses, np.concatenate(depths) if depth else None,
            np.concatenate(rights) if right else None)


def rgbd_flags():
    """``rgbd_icl --planes online --objects`` (tpuslam/apps/rgbd_icl.py:33-41),
    loop closing off."""
    return FeatureFlags(
        detect_plane=True, read_offline_planetxt=False, detect_object=True, read_offline_cuboidtxt=True,
        optimize_with_plane_3d=True, optimize_with_cuboid_2d=True, enable_loop_closing=False,
    )


def flagship_flags():
    """``mono_icl --planes --objects`` with the golden ICL.yaml (it sets none
    of the optional keys), loop closing off."""
    return FeatureFlags(
        detect_object=True, read_offline_cuboidtxt=True, detect_plane=True, read_offline_planetxt=True,
        associate_cuboid_with_classname=True, optimize_with_plane_3d=True, optimize_with_cuboid_2d=True,
        enable_ground_height_scale=True, enable_loop_closing=False,
    )


def write_folder(folder: str, frames, poses_wc, cam: synth.CameraSpec, fps: float = 30.0) -> str:
    """The mono part of ``write_sequence``'s layout for already rendered
    uint8 frames: ``rgb/%04d.png``, ``rgb.txt``, ``odom.txt`` and ``ICL.yaml``
    (synth.py:366-450)."""
    import cv2

    os.makedirs(os.path.join(folder, "rgb"), exist_ok=True)
    rgb_lines, odom_lines = [], []
    for f, gray in enumerate(frames):
        stamp = f / fps
        cv2.imwrite(os.path.join(folder, "rgb", f"{f:04d}.png"), gray)
        rgb_lines.append(f"{stamp:.6f} rgb/{f:04d}.png")
        q = synth._R_to_quat_np(poses_wc[f][:3, :3])
        tx, ty, tz = poses_wc[f][:3, 3]
        odom_lines.append(f"{stamp:.6f} {tx:.9f} {ty:.9f} {tz:.9f} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")
    for name, lines in (("rgb.txt", rgb_lines), ("odom.txt", odom_lines)):
        with open(os.path.join(folder, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    with open(os.path.join(folder, "ICL.yaml"), "w") as fh:
        fh.write("%YAML:1.0\n"
                 f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\nCamera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n"
                 "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
                 f"Camera.width: {cam.width}\nCamera.height: {cam.height}\n"
                 f"Camera.bf: {cam.fx * cam.baseline}\nCamera.fps: {fps}\n")
    return folder


def localization_after_resume(out_dir: str, n_restored: int, gt_cw):
    """What a ``--resume --localization-only`` run tracked, from its
    ``TrajectoryRaw.txt`` (the restored rows first): the frames tracked, the
    first of them and the Sim3-aligned ATE of their raw poses against
    ``gt_cw`` (world->camera by frame id)."""
    from tpuslam.io.datasets import _tum_rows_to_Tcw

    rows = np.loadtxt(os.path.join(out_dir, "TrajectoryRaw.txt"), ndmin=2)[n_restored:]
    out = {"loc_tracked": len(rows), "loc_first_tracked": int(rows[0, 0]) if len(rows) else None}
    if len(rows) >= 3:
        fids = rows[:, 0].astype(int)
        out["loc_ate_raw_m"] = ate_rmse(list(_tum_rows_to_Tcw(rows)), [gt_cw[f] for f in fids], with_scale=True)[0]
    return out


def localize(n: int):
    """``--localize``: map the written golden folder with ``mono_icl``, then
    replay it in localization mode from the checkpoint."""
    from tpuslam.apps import mono_icl
    from tpuslam.io.checkpoint import load_map

    cam = synth.CameraSpec()
    frames, poses_wc, _, _ = render(n, cam)
    work = tempfile.mkdtemp(prefix="golden_localize_")
    folder = write_folder(os.path.join(work, "seq"), frames, poses_wc, cam)
    ck = os.path.join(work, "map.npz")
    base = [folder, "--max-frames", str(n), "--vocab", "lsh"]
    t0 = time.perf_counter()
    mapped = mono_icl.main(base + ["--checkpoint", ck, "--out", os.path.join(work, "map")])
    t1 = time.perf_counter()
    loc = mono_icl.main(base + ["--resume", ck, "--localization-only", "--out", os.path.join(work, "loc")])
    t2 = time.perf_counter()
    raw = np.loadtxt(os.path.join(work, "map", "TrajectoryRaw.txt"), ndmin=2)
    gt = [np.linalg.inv(np.asarray(p, np.float64)) for p in poses_wc]
    n_restored = len(load_map(ck)[1]["trajectory"])
    rep = {"frames": n, "mapped": mapped, "first_tracked": int(raw[0, 0]), "localized": loc,
           **localization_after_resume(os.path.join(work, "loc"), n_restored, gt),
           "map_s": t1 - t0, "localize_s": t2 - t1}
    print(json.dumps(rep))
    return rep


def stream(n: int):
    """``--stream``: the first ``n`` golden frames through the JAX stream node."""
    from tpuslam.apps import stream as jstream

    cam = synth.CameraSpec()
    frames, poses_wc, _, _ = render(n, cam)
    work = tempfile.mkdtemp(prefix="golden_stream_")
    folder = write_folder(os.path.join(work, "seq"), frames, poses_wc, cam)
    lines = "".join(f"{f} {folder}/rgb/{f:04d}.png\n" for f in range(n))
    out, buf, stdin = os.path.join(work, "out"), io.StringIO(), sys.stdin
    sys.stdin = io.StringIO(lines)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            jstream.main(["--sensor", "mono", "--fx", str(cam.fx), "--fy", str(cam.fy), "--cx", str(cam.cx),
                          "--cy", str(cam.cy), "--bf", str(cam.fx * cam.baseline), "--vocab", "lsh", "--out", out])
    finally:
        sys.stdin = stdin
    wall = time.perf_counter() - t0
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    frame_rows = [r for r in rows if "frame_id" in r]
    gt = [np.linalg.inv(np.asarray(p, np.float64)) for p in poses_wc]
    loc = localization_after_resume(out, 0, gt)
    report = rows[-1]
    rep = {"frames": n, "frame_ids_in_order": [r["frame_id"] for r in frame_rows] == list(range(n)),
           "states": {k: sum(r["state"] == k for r in frame_rows) for k in ("INIT", "OK", "LOST")},
           "tracked": report["tracked"], "first_tracked": loc["loc_first_tracked"],
           "keyframes_created": report["keyframes_created"], "points": report["points"], "loops": report["loops"],
           "ate_raw_m": loc.get("loc_ate_raw_m"), "wall_s": wall}
    print(json.dumps(rep))
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--small", action="store_true",
                    help="320x240, fx 260, 512 features, the capacities of tests/test_long_replay.py")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--flagship", action="store_true",
                      help="mono_icl --planes --objects: offline plane and cuboid detections")
    mode.add_argument("--rgbd", action="store_true", help="rgbd_icl --planes online --objects")
    mode.add_argument("--stereo", action="store_true", help="stereo_kitti's configuration on a rendered pair")
    ap.add_argument("--loops", action="store_true", help="loop closing on (the Tracker's default)")
    ap.add_argument("--localize", action="store_true",
                    help="mono_icl from a written folder, then --resume --localization-only on it")
    ap.add_argument("--stream", action="store_true",
                    help="the stdin stream node on the written golden frames (mono, --vocab lsh)")
    ap.add_argument("--synthetic", action="store_true",
                    help="feature-level frames of io/synthetic.py through process_frame (loops on)")
    args = ap.parse_args(argv)
    if args.localize:
        return localize(args.frames)
    if args.stream:
        return stream(args.frames)
    if args.synthetic:
        args.loops = True  # the default flags
    if args.small:
        cspec = synth.CameraSpec(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)
        caps = Capacities(max_keypoints=512, max_keyframes=256, max_points=8192, local_ba_points=2048)
        orb = OrbConfig(n_features=512)
    else:
        cspec, caps, orb = synth.CameraSpec(), Capacities(), OrbConfig()
    sensor = "rgbd" if args.rgbd else "stereo" if args.stereo else "mono"
    flags = (flagship_flags() if args.flagship else rgbd_flags() if args.rgbd
             else FeatureFlags(enable_loop_closing=False))
    if args.synthetic:
        flags = (dataclasses.replace(FeatureFlags(), detect_plane=True, detect_object=True,
                                     optimize_with_plane_3d=True, optimize_with_cuboid_2d=True)
                 if args.rgbd else FeatureFlags())
    if args.loops:
        flags = dataclasses.replace(flags, enable_loop_closing=True)
    cfg = SlamConfig().replace(sensor=sensor, caps=caps, orb=orb, flags=flags)
    debug_path = ""
    if args.loops:
        # the detector writes one line per gate a keyframe reaches
        debug_path = os.path.join(tempfile.mkdtemp(prefix="golden_loop_"), "loop.log")
        jloop._DEBUG_PATH = debug_path
        stats = jloop._loop_candidate_stats
        n_stats = []

        def counted_stats(*a, **kw):
            n_stats.append(1)
            return stats(*a, **kw)

        jloop._loop_candidate_stats = counted_stats
        correct = jloop.LoopCloser._correct_loop
        closures = []

        def recorded_correct(self, m, kf_cur, kf_loop, *a, **kw):
            fids = np.asarray(m.kf_frame_id)
            closures.append([int(fids[kf_cur]), int(fids[kf_loop])])
            return correct(self, m, kf_cur, kf_loop, *a, **kw)

        jloop.LoopCloser._correct_loop = recorded_correct
    cam = Camera.make(cspec.fx, cspec.fy, cspec.cx, cspec.cy, width=cspec.width,
                      height=cspec.height, bf=cspec.fx * cspec.baseline)
    if args.synthetic:
        from tpuslam.io import synthetic as jsyn

        scene = jsyn.make_room_scene(2500, args.frames, 0, with_planes=args.rgbd, with_cuboids=args.rgbd)
        frames = [jsyn.render_frame(scene, f, cam, n_features=cfg.orb.n_features, with_depth=args.rgbd)
                  for f in range(args.frames)]
        syn_dets = [(jsyn.render_plane_detections(scene, f, cfg.caps.max_planes_per_frame),
                     jsyn.render_cuboid_detections(scene, f, cam, cfg.caps.max_cuboids_per_frame))
                    if args.rgbd else (None, None) for f in range(args.frames)]
    else:
        det_dir = tempfile.mkdtemp(prefix="golden_det_") if args.flagship or args.rgbd else ""
        frames, poses_wc, depths, rights = render(args.frames, cspec, det_dir=det_dir, depth=args.rgbd,
                                                  right=args.stereo, planes=args.flagship)
    K_np = np.asarray(cam.K)
    tracker = Tracker(cam, cfg)
    semantic = args.flagship or args.rgbd
    sem = {"ba_mono_factors": 0} if args.synthetic else {}
    sem.update({"rescales": 0, "ba_plane_factors": 0, "ba_bbox_factors": 0, "stereo_factors": 0})
    rescale, local_ba, stereo_matches = jms.rescale_map, jlm.local_ba, jks.compute_stereo_matches
    n_matched = []

    def counted_rescale(m, s_):
        sem["rescales"] += 1
        return rescale(m, s_)

    def counted_local_ba(state, data, w, **kw):
        if "ba_mono_factors" in sem:
            sem["ba_mono_factors"] += int(np.asarray(data.mono.valid).sum())
        sem["ba_plane_factors"] += int(np.asarray(data.plane_obs.valid).sum())
        sem["ba_bbox_factors"] += int(np.asarray(data.cub_bbox.valid).sum())
        sem["stereo_factors"] += int(np.asarray(data.stereo.valid).sum())
        return local_ba(state, data, w, **kw)

    def counted_stereo_matches(*a, **kw):
        out = stereo_matches(*a, **kw)
        n_matched.append(int(np.asarray(out[2]).sum()))
        return out

    jms.rescale_map, jlm.local_ba, jks.compute_stereo_matches = (
        counted_rescale, counted_local_ba, counted_stereo_matches)
    times, first, online_planes = [], None, 0
    t_all = time.perf_counter()
    for fid, gray in enumerate(frames):
        pdet = cdet = None
        if args.synthetic:
            t0 = time.perf_counter()
            T = tracker.process_frame(gray, fid, *syn_dets[fid])
            times.append(time.perf_counter() - t0)
            first = fid if T is not None and first is None else first
            continue
        if args.flagship:
            pdet = read_offline_planes(os.path.join(det_dir, f"{fid}_offline_plane_multiplane.txt"),
                                       cfg.caps.max_planes_per_frame)
        if args.rgbd:
            pdet = detect_planes_online(depths[fid], cam, cfg.caps.max_planes_per_frame)
            online_planes += int(np.asarray(pdet.valid).sum())
        if semantic:
            cdet = read_offline_cuboids(os.path.join(det_dir, f"{fid:04d}_3d_cuboids.txt"), poses_wc[fid],
                                        K_np, cfg.caps.max_cuboids_per_frame)
        t0 = time.perf_counter()
        if args.stereo:
            T = tracker.process_stereo_pair(gray, rights[fid], fid)
        else:
            T = tracker.process_image(gray, fid, depth=depths[fid] if args.rgbd else None,
                                      plane_det=pdet, cuboid_det=cdet)
        times.append(time.perf_counter() - t0)
        if T is not None and first is None:
            first = fid
    tracker.flush()
    wall = time.perf_counter() - t_all
    gt = (scene.poses.astype(np.float64) if args.synthetic
          else [np.linalg.inv(np.asarray(p, np.float64)) for p in poses_wc])
    corrected = _corrected_trajectory(tracker)
    extra = {}
    if semantic:
        extra.update({k: sem[k] for k in ("rescales", "ba_plane_factors", "ba_bbox_factors")})
    if args.synthetic:
        extra["ba_mono_factors"] = sem["ba_mono_factors"]
    if sensor != "mono":
        extra["stereo_factors"] = sem["stereo_factors"]
    if args.rgbd and not args.synthetic:
        extra["online_planes"] = online_planes
    if args.stereo:
        extra["stereo_matches"] = float(np.median(n_matched))
    if args.loops:
        lines = open(debug_path).read().splitlines() if os.path.exists(debug_path) else []
        gate3 = [ln for ln in lines if ln.startswith("  gate3")]
        extra["loops"] = tracker.n_loops
        extra["loop_closures"] = closures  # [current keyframe's frame id, loop keyframe's]
        extra["loop_gates"] = {
            "stats": len(n_stats),
            "covisible": sum(ln.startswith("fid=") for ln in lines),
            "words": sum(ln.startswith("  gate2") for ln in lines),
            "score": len(gate3),
            "consistent": sum(not ln.endswith("consistent=[]") for ln in gate3),
            "sim3": sum(ln.startswith("  sim3 cand=") and ln.endswith("ok=True") for ln in lines),
        }
        extra["loop_stage_ms"] = {k: v for k, v in sorted(tracker.loop_closer.stage_ms.items())}
    rep = {
        "frames": len(frames),
        "tracked": len(tracker.trajectory),
        "first_tracked": first,
        "keyframes_created": len(tracker._kf_fids),
        "keyframes_live": int(np.asarray(tracker.map.kf_valid).sum()),
        "kf_frame_ids": [int(f) for f in tracker._kf_fids],
        "points": tracker.live_points(),
        "planes": tracker.n_plane,
        "cuboids": tracker.n_cub,
        **extra,
        "wall_s": wall,
        "median_frame_ms": 1e3 * float(np.median(times)),
    }
    # metric sensors make metric maps: their error is reported without scale
    scale = sensor == "mono"
    if corrected:
        rep["ate_raw_m"] = ate_rmse([p for _, p in tracker.trajectory],
                                    [gt[f] for f, _ in tracker.trajectory], with_scale=scale)[0]
        rep["ate_m"] = ate_rmse([p for _, p in corrected], [gt[f] for f, _ in corrected], with_scale=scale)[0]
        kv = np.asarray(tracker.map.kf_valid)
        fid = np.asarray(tracker.map.kf_frame_id)
        pose = np.asarray(tracker.map.kf_pose)
        sel = [s for s in np.flatnonzero(kv) if np.isfinite(pose[s]).all()]
        if len(sel) >= 3:
            rep["kf_ate_m"] = ate_rmse([pose[s] for s in sel], [gt[int(fid[s])] for s in sel],
                                       with_scale=scale)[0]
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
