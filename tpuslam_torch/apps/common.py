"""The shared CLI runner of the dataset apps (port of
``tpuslam/apps/common.py``): the flags every app takes (``base_parser``),
the camera, capacities, vocabulary and ``Tracker`` they build, the frame loop
(``run_loop``) and the trajectory, cuboid, plane, KITTI and checkpoint dumps
with the JSON report (``finish``).  Each app in this package binds a dataset
reader and a sensor to it; ``apps/golden.py`` drives ``run_loop`` and
``finish`` on the golden sequence rendered in memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import geometry as geo
from ..core.camera import Camera
from ..core.config import SlamConfig
from ..frontend.tracking import Frame, Tracker
from ..graph import lm
from ..io.datasets import load_settings_yaml
from ..io.trajectory import ate_rmse, save_cuboids, save_kitti, save_planes, save_tum
from ..kernels import cuda_pose
from ..kernels.orb import OrbExtractor
from ..place import vocab as vb
from ..utils.profiler import Profiler


def base_parser(description: str) -> argparse.ArgumentParser:
    """The reference's flags (common.py:33-72), plus ``--device``."""
    ap = argparse.ArgumentParser(description=description, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("folder", help="dataset sequence folder")
    ap.add_argument("--settings", default="", help="settings YAML (reference-format)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--save-kitti", action="store_true", help="also dump KITTI-format trajectory")
    ap.add_argument("--checkpoint", default="", help="save a map checkpoint here at the end")
    ap.add_argument("--resume", default="", help="resume from a map checkpoint")
    ap.add_argument("--localization-only", action="store_true",
                    help="freeze the map and only localize against it (System::ActivateLocalizationMode); "
                    "meaningful with --resume")
    ap.add_argument("--features", type=int, default=0,
                    help="ORB features per frame (scales all map capacities; default 1024)")
    ap.add_argument("--max-kf-gap", type=int, default=0,
                    help="force a keyframe at least every N frames (the reference's mMaxFrames); 0 keeps the "
                    "config default")
    ap.add_argument("--viz-every", type=int, default=0,
                    help="every N frames, dump map and frame overlay PNGs to <out>/viz/ (headless Viewer/MapDrawer/"
                    "FrameDrawer analogue; needs cv2 and matplotlib)")
    ap.add_argument("--vocab", default="train",
                    help="place-recognition vocabulary: a DBoW2 ORBvoc .txt/.bin path (its leaves flattened "
                    "into the codebook), 'train' (default: k-means over the sequence's own ORB descriptors) or "
                    "'lsh' (the seeded random codebook)")
    ap.add_argument("--device", default="cuda:0", help="torch device the Tracker runs on (cuda:0, or cpu)")
    return ap


def apply_features(cfg: SlamConfig, n: int) -> SlamConfig:
    """Scale the padded capacities for a feature budget ``n`` (0 keeps them)."""
    if n <= 0:
        return cfg
    caps = dataclasses.replace(cfg.caps, max_keypoints=n, max_points=max(4 * n, 4096),
                               local_ba_points=max(2 * n, 2048))
    return cfg.replace(caps=caps, orb=dataclasses.replace(cfg.orb, n_features=n))


def camera_from_args(args, default_cam: Camera):
    """(Camera, settings dict) from ``--settings`` (a path, or a name in the
    dataset folder) when the file exists, else (``default_cam``, {})."""
    if args.settings:
        path = args.settings if os.path.exists(args.settings) else os.path.join(args.folder, args.settings)
        if os.path.exists(path):
            return load_settings_yaml(path, args.device)
    return default_cam, {}


def native_io(args) -> bool:
    """Decode PNGs and scan ORBvoc text with the compiled helpers on a card
    run; the plain versions on the CPU."""
    return torch.device(args.device).type == "cuda"


def make_tracker(args, cam: Camera, cfg: SlamConfig, sample_grays=None) -> Tracker:
    """The ``Tracker`` of the flags: ``--max-kf-gap``, ``--vocab``,
    ``--resume`` (``io/checkpoint.load_tracker``) and
    ``--localization-only``.

    A dataset replays to the same map every run on one card, as the
    reference's does, without torch's deterministic mode: every float sum
    on the path has a fixed order (the BA's, the pose graph's and the ORBvoc
    BoW's through ``lm._sum_at``), and the other scatter-adds sum integers,
    or float ones and ±1s, exact in any order.

    With ``--viz-every`` it first imports the drawing packages
    (:func:`require_viz`), so a host without them fails before the first
    frame."""
    if getattr(args, "viz_every", 0) > 0:
        require_viz()
    if getattr(args, "max_kf_gap", 0):
        cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=args.max_kf_gap))
    device = torch.device(args.device)
    vocab, cfg = build_vocab(args.vocab, cfg, device, sample_grays, native=native_io(args))
    if args.resume:
        from ..io.checkpoint import load_tracker

        tracker = load_tracker(args.resume, cam, cfg, device=device, vocab=vocab)
    else:
        tracker = Tracker(cam, cfg, device=device, vocab=vocab)
    if getattr(args, "localization_only", False):
        tracker.set_localization_mode(True)
    return tracker


def require_viz() -> None:
    """Import what ``--viz-every`` draws with (``viz/``: cv2 for the frame
    overlay, matplotlib for the map); raises ImportError naming the missing
    package."""
    import importlib

    for name, dist_name in (("cv2", "opencv-python"), ("matplotlib", "matplotlib")):
        try:
            importlib.import_module(name)
        except ImportError as e:
            raise ImportError(f"--viz-every needs the {name} package ({dist_name}), which is not installed") from e


def viz_kw(args) -> dict:
    """:func:`run_loop`'s ``--viz-every`` keywords: the period and ``<out>/viz``."""
    return {"viz_every": args.viz_every, "viz_dir": os.path.join(args.out, "viz")}


def _dump_viz(tracker: Tracker, frame_id: int, gray, viz_dir: str) -> None:
    """Headless Viewer snapshot (common.py:218-238 of the reference): the
    frame overlay and, once a keyframe exists, the 3D map as PNGs."""
    import cv2

    from ..viz import draw_frame_overlay, save_map_png

    f, kp_pt = tracker.last_frame, tracker.last_kp_pt
    overlay = draw_frame_overlay(gray, f.uv, f.valid, kp_bound=kp_pt >= 0 if kp_pt is not None else None,
                                 state=tracker.state, n_kf=tracker.n_kf, n_pt=tracker.n_pt)
    cv2.imwrite(os.path.join(viz_dir, f"frame_{frame_id:05d}.png"), overlay)
    if tracker.n_kf > 0:
        save_map_png(os.path.join(viz_dir, f"map_{frame_id:05d}.png"), tracker.map, n_kf=tracker.n_kf)


def build_vocab(name: str, cfg, device, sample_grays=None, native: bool = False):
    """Resolve a ``--vocab`` value into (vocabulary or None, config), as the
    reference's ``build_vocab`` (common.py:102-143): ``''`` or ``'lsh'``
    give None (the Tracker's seeded codebook); ``'train'`` runs binary
    k-means over the ORB descriptors of every 12th frame of
    ``sample_grays``, at most 48 frames (strided: a vocabulary trained on
    the first seconds only describes one view direction); a path loads an
    ORBvoc text or binary tree (``native``: the compiled text scanner) and
    flattens its leaves, and ``caps.vocab_words`` becomes the file's word
    count (the width of the map's BoW rows)."""
    if not name or name == "lsh":
        return None, cfg
    if name != "train":
        voc = vb.load_flat_vocabulary(name, device, native=native)
        if voc.n_words != cfg.caps.vocab_words:
            cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, vocab_words=voc.n_words))
        return voc, cfg
    if sample_grays is None:
        raise ValueError("--vocab train needs sequence frames to sample")
    descs, extractor = [], None
    for i, gray in enumerate(sample_grays):
        if len(descs) >= 48:
            break
        if i % 12 == 0:
            g = torch.as_tensor(gray).to(device)
            if extractor is None:
                extractor = OrbExtractor(g.shape[0], g.shape[1], device, n_features=cfg.orb.n_features)
            f = extractor(g.to(torch.float32))
            descs.append(f.desc[f.valid])
    return vb.train_kmeans(torch.cat(descs), n_words=cfg.caps.vocab_words), cfg


def _stage(gray, device):
    """Start a frame's upload: a numpy image goes through pinned memory with
    ``non_blocking=True``, so the copy overlaps the previous frame's work.
    A feature-level ``Frame`` is staged field by field."""
    if isinstance(gray, Frame):
        return Frame(*(_stage(x, device) for x in gray))
    if isinstance(gray, torch.Tensor) and gray.device == device:
        return gray
    t = gray if isinstance(gray, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(gray))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def dataset_items(frames, sensor: str):
    """A dataset reader's ``SequenceItem`` iterator as :func:`run_loop`'s
    tuples: ``(frame_id, gray)``, with the depth for RGB-D and the right
    image for stereo (None where the file is missing)."""
    for it in frames:
        extra = (it.depth,) if sensor == "rgbd" else (it.right,) if sensor == "stereo" else ()
        yield (it.frame_id, it.gray, *extra)


class LoopTimes(NamedTuple):
    frame_s: list  # per frame, around the tracker's call
    wall_s: float  # the whole loop, reads and decodes included


def run_loop(tracker: Tracker, items, prof: Profiler, per_frame=None, viz_every: int = 0, viz_dir: str = ""):
    """Drive the tracker over ``(frame_id, gray)`` items, ``(frame_id, gray,
    depth)`` for an RGB-D tracker and ``(frame_id, left, right)`` for a
    stereo one (common.py:167-215 of the reference: a stereo item goes to
    ``process_stereo_pair``, an RGB-D one to ``process_image`` with its
    depth; a missing depth or right image goes as mono), or ``(frame_id,
    frame)`` with a feature-level ``Frame`` (``io/synthetic.render_frame``),
    which goes to ``process_frame``.  The next item is
    drawn from ``items`` (a dataset reader reads and decodes its files
    then) and its upload started, pinned and non-blocking, before the
    current frame is processed: the reference's ``prefetched``.  ``per_frame(item)``, given the uploaded item, may return the
    frame's (plane_det, cuboid_det), the semantic input of a keyframe.

    Returns :class:`LoopTimes`: each frame's wall time around the
    tracker's call, and the whole loop's, which also spans every item's
    read, decode and upload (a reader decodes its files in ``next``), the
    tracker's flush and the device's last work.  With ``viz_every`` > 0,
    every frame whose id it divides dumps the frame overlay and the map into
    ``viz_dir`` (``frame_%05d.png``, ``map_%05d.png``), as the reference's
    loop does."""
    t_loop = time.perf_counter()
    if viz_every:
        os.makedirs(viz_dir, exist_ok=True)
    dev = tracker.device
    sensor = tracker.cfg.sensor
    frame_times = []
    it = iter(items)

    def staged(item):
        return None if item is None else (item[0], *(None if x is None else _stage(x, dev) for x in item[1:]))

    cur = staged(next(it, None))
    while cur is not None:
        nxt = staged(next(it, None))
        fid, gray = cur[:2]
        t0 = time.perf_counter()
        pdet, cdet = per_frame(cur) if per_frame is not None else (None, None)
        with prof.section("time single frame"):
            if isinstance(gray, Frame):
                tracker.process_frame(gray, fid, plane_det=pdet, cuboid_det=cdet)
            elif sensor == "stereo" and cur[2] is not None:
                tracker.process_stereo_pair(gray, cur[2], fid, plane_det=pdet, cuboid_det=cdet)
            else:
                tracker.process_image(gray, fid, depth=cur[2] if sensor == "rgbd" and len(cur) > 2 else None,
                                      plane_det=pdet, cuboid_det=cdet)
        frame_times.append(time.perf_counter() - t0)
        if viz_every and fid % viz_every == 0 and tracker.last_frame is not None:
            _dump_viz(tracker, fid, gray, viz_dir)
        cur = nxt
    tracker.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return LoopTimes(frame_times, time.perf_counter() - t_loop)


def run_points_only(args, cam: Camera, sensor: str, ds, gt=None, metric: bool = False, save_kitti_traj=False,
                    **frames_kw):
    """The body of the points-only apps (mono_tum, mono_kitti, mono_euroc,
    stereo_kitti, stereo_euroc): the default flags for ``sensor``, the
    ``Tracker`` of the flags, the frame loop over ``ds.frames(**frames_kw)``
    and the report, printed as one JSON line and returned."""
    cfg = apply_features(SlamConfig().replace(sensor=sensor), args.features)
    tracker = make_tracker(args, cam, cfg, sample_grays=(it.gray for it in ds.frames()))
    prof = Profiler()
    ds.decode_ms.clear()  # the vocabulary's sampling pass is not the replay's
    times = run_loop(tracker, dataset_items(ds.frames(**frames_kw), sensor), prof, **viz_kw(args))
    report = finish(tracker, times, gt=gt, out_dir=args.out, metric=metric,
                    save_kitti_traj=save_kitti_traj or args.save_kitti, checkpoint=args.checkpoint,
                    decode_ms=ds.decode_ms)
    print(json.dumps(report))
    prof.print_aggregated()
    return report


def corrected_trajectory(tracker: Tracker):
    """Track-time poses re-anchored to the final keyframe poses, as the
    reference's SaveTrajectoryTUM does (System.cc:383-436): each frame's
    pose relative to its reference keyframe, chained through culled
    references until a live keyframe is reached.  A frame whose chain breaks
    keeps its track-time pose."""
    traj = tracker.trajectory
    if not traj:
        return []
    kf_valid = tracker.map.kf_valid.cpu().numpy()
    kf_fid = tracker.map.kf_frame_id.cpu().numpy()
    kf_pose = tracker.map.kf_pose.cpu().numpy().astype(np.float64)
    live_slot_by_fid = {
        int(kf_fid[s]): int(s) for s in np.flatnonzero(kf_valid) if np.isfinite(kf_pose[s]).all()
    }
    rel = tracker.traj_rel
    out = []
    for fid, A in traj:
        fid = int(fid)
        T_acc = np.eye(4)
        cur = fid
        resolved = None
        for _ in range(2048):  # every step strictly decreases the frame id
            if cur in live_slot_by_fid:
                resolved = T_acc @ kf_pose[live_slot_by_fid[cur]]
                break
            r = rel.get(cur)
            if r is None:
                break
            _, ref_fid, T_cr = r
            if ref_fid >= cur:
                break
            T_acc = T_acc @ np.asarray(T_cr, np.float64)
            cur = ref_fid
        T = resolved if resolved is not None and np.isfinite(resolved).all() else np.asarray(A)
        out.append((fid, T))
    return out


def finish(tracker: Tracker, times: LoopTimes, gt=None, out_dir: str = "", metric: bool = False,
           save_kitti_traj: bool = False, checkpoint: str = "", decode_ms=None):
    """The report of the reference's ``finish``: counts (planes, cuboids and
    loops among them), frame times (``run_loop``'s: the median and mean
    frame, and ``frames_per_s``, the frames over the loop's wall time
    ``wall_s``, reads and decodes included), per-keyframe stage ms
    ``kf_stage_ms`` (``kf_*``, ``map_*`` and the loop closer's as
    ``loop_*``), the frame program's and the host waits' ms per tracked
    frame ``frame_stage_ms`` (``frame_*``, ``wait_*``; a tracked frame is
    one run of the frame program), the process's pose-LM calls by path
    ``pose_lm`` (``kernels/cuda_pose.counts``: kernel launches, plain calls
    on the CPU), its local BAs ``ba_graph`` (``graph/lm.py:ba_graph_counts``:
    CUDA graphs captured, graph replays, eager calls, eager calls on a
    card), and with ``gt`` (world->camera poses by frame id) the ATE of the
    corrected, the raw and the live keyframe trajectories, Sim3-aligned, or
    with ``metric`` (the depth sensors' metric maps) SE3-aligned without
    scale (common.py:365, :372, :389).  With ``out_dir``, also the TUM
    files and CuboidPose.txt / PlanePose.txt, and with ``save_kitti_traj``
    CameraTrajectory_kitti.txt;
    ``checkpoint``: a map checkpoint written there (``io/checkpoint.py``).
    The port adds ``relocalized`` and ``vo_frames`` (frames placed by
    relocalization and by localization mode's visual odometry), for a
    stereo tracker ``stereo_matches`` (the median per pair of left keypoints
    with a stereo match) and, with
    ``decode_ms`` (a dataset reader's log), the mean host ms of each image
    decode by kind (``decode_ms_per_image``)."""
    tracker.flush()
    corrected = corrected_trajectory(tracker)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        save_tum(os.path.join(out_dir, "KeyFrameTrajectory.txt"), [f for f, _ in corrected],
                 [p for _, p in corrected])
        save_tum(os.path.join(out_dir, "TrajectoryRaw.txt"), [f for f, _ in tracker.trajectory],
                 [p for _, p in tracker.trajectory])
        m = tracker.map
        if tracker.n_cub > 0:
            v = geo.cuboid_to_minimal(m.cub_pose[:tracker.n_cub], m.cub_scale[:tracker.n_cub]).cpu().numpy()
            save_cuboids(os.path.join(out_dir, "CuboidPose.txt"), list(v))
        if tracker.n_plane > 0:
            save_planes(os.path.join(out_dir, "PlanePose.txt"), list(m.plane_coef[:tracker.n_plane].cpu().numpy()))
        if save_kitti_traj:
            save_kitti(os.path.join(out_dir, "CameraTrajectory_kitti.txt"), [p for _, p in corrected])
    if checkpoint:
        from ..io.checkpoint import save_tracker

        save_tracker(checkpoint, tracker)
    ft = np.array(times.frame_s)
    n_created = max(len(tracker._kf_fids), 1)
    n_tracked = max(tracker.spans.count.get("frame_motion", 0), 1)
    # the loop closer's stages beside the keyframe's, averaged over created keyframes
    per_frame = ("frame_", "wait_")
    stage_ms = {k: v for k, v in tracker.stage_ms.items() if not k.startswith(per_frame)}
    if tracker.loop_closer is not None:
        stage_ms.update({f"loop_{k}": v for k, v in tracker.loop_closer.stage_ms.items()})
    report = {
        "frames": len(ft),
        "tracked": len(tracker.trajectory),
        "keyframes": tracker.n_kf,
        "keyframes_live": int(tracker.map.kf_valid.sum()),
        "keyframes_created": len(tracker._kf_fids),
        "points": tracker.live_points(),
        "planes": tracker.n_plane,
        "cuboids": tracker.n_cub,
        "loops": tracker.n_loops,
        "median_frame_s": float(np.median(ft)) if len(ft) else None,
        "mean_frame_s": float(ft.mean()) if len(ft) else None,
        "wall_s": times.wall_s,
        "frames_per_s": len(ft) / times.wall_s if len(ft) else None,
        "kf_stage_ms": {k: v / n_created for k, v in sorted(stage_ms.items())},
        "frame_stage_ms": {k: v / n_tracked for k, v in sorted(tracker.stage_ms.items())
                           if k.startswith(per_frame)},
        "pose_lm": cuda_pose.counts(),
        "ba_graph": lm.ba_graph_counts(),
        "relocalized": tracker.n_relocalized,
        "vo_frames": tracker.n_vo,
    }
    if tracker.stereo_matches:  # left keypoints with a stereo match, median per pair
        report["stereo_matches"] = float(np.median([int(n) for n in tracker.stereo_matches]))
    if decode_ms:
        report["decode_ms_per_image"] = {k: float(np.mean(v)) for k, v in decode_ms.items()}
    if gt is not None and corrected:
        est = [(f, p) for f, p in corrected if f < len(gt)]
        scale = not metric
        if est:
            report["ate_rmse_m"] = ate_rmse([p for _, p in est], [gt[f] for f, _ in est], with_scale=scale)[0]
        raw = [(f, p) for f, p in tracker.trajectory if f < len(gt)]
        if raw:
            report["ate_rmse_raw_m"] = ate_rmse([p for _, p in raw], [gt[f] for f, _ in raw], with_scale=scale)[0]
        kf_valid = tracker.map.kf_valid.cpu().numpy()
        kf_fid = tracker.map.kf_frame_id.cpu().numpy()
        kf_pose = tracker.map.kf_pose.cpu().numpy()
        sel = [(int(kf_fid[s]), kf_pose[s]) for s in np.flatnonzero(kf_valid)
               if int(kf_fid[s]) < len(gt) and np.isfinite(kf_pose[s]).all()]
        if len(sel) >= 3:
            report["kf_ate_rmse_m"] = ate_rmse([p for _, p in sel], [gt[f] for f, _ in sel], with_scale=scale)[0]
    return report
