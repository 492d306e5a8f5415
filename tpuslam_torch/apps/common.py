"""The app loop and its report (port of ``tpuslam/apps/common.py``:
``build_vocab``, ``run_loop``, ``_corrected_trajectory`` and ``finish``).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from collections import Counter

import numpy as np
import torch

from ..core import geometry as geo
from ..frontend.tracking import Tracker
from ..io.trajectory import ate_rmse, save_cuboids, save_planes, save_tum
from ..kernels.orb import OrbExtractor
from ..place import vocab as vb
from ..utils.profiler import Profiler


def build_vocab(name: str, cfg, device, sample_grays=None):
    """Resolve a ``--vocab`` value into (vocabulary or None, config), as the
    reference's ``build_vocab`` (common.py:102-143): ``''`` or ``'lsh'``
    give None (the Tracker's seeded codebook); ``'train'`` runs binary
    k-means over the ORB descriptors of every 12th frame of
    ``sample_grays``, at most 48 frames (strided: a vocabulary trained on
    the first seconds only describes one view direction).  An ORBvoc path
    needs the DBoW2 loaders, which are not ported."""
    if not name or name == "lsh":
        return None, cfg
    if name != "train":
        raise NotImplementedError(f"--vocab {name!r}: loading ORBvoc files (place/dbow_compat.py) is not ported")
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
    ``non_blocking=True``, so the copy overlaps the previous frame's work."""
    if isinstance(gray, torch.Tensor) and gray.device == device:
        return gray
    t = gray if isinstance(gray, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(gray))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def run_loop(tracker: Tracker, items, prof: Profiler, count_waits: bool = False, per_frame=None):
    """Drive the tracker over ``(frame_id, gray)`` items, ``(frame_id, gray,
    depth)`` for an RGB-D tracker and ``(frame_id, left, right)`` for a
    stereo one (common.py:167-215 of the reference: a stereo item goes to
    ``process_stereo_pair``, an RGB-D one to ``process_image`` with its
    depth).  The next frame's upload is started before the current frame is
    processed.  ``per_frame(item)``, given the uploaded item, may return the
    frame's (plane_det, cuboid_det), the semantic input of a keyframe.

    Returns the per-frame wall times (s).  With ``count_waits`` on a CUDA
    tracker, ``tracker.frame_waits`` gets one entry per frame: (frame id,
    kind, host waits, their sources).  The kind is "keyframe" when the call
    made a keyframe, "init" when the tracker was not tracking before it (its
    keyframes included), else "hot".  The waits are what torch's sync debug mode reports (the
    tracker's reads among them) plus the tracker's waits on CUDA events,
    which that mode does not see."""
    dev = tracker.device
    sensor = tracker.cfg.sensor
    frame_times = []
    tracker.frame_waits = []
    it = iter(items)

    def staged(item):
        return None if item is None else (item[0], *(_stage(x, dev) for x in item[1:]))

    cur = staged(next(it, None))
    while cur is not None:
        nxt = staged(next(it, None))
        fid, gray = cur[:2]
        t0 = time.perf_counter()
        n_kf, events0 = len(tracker._kf_fids), tracker.waits.get("event", 0)
        tracking = tracker.state == tracker.OK
        counting = count_waits and dev.type == "cuda"
        if counting:
            torch.cuda.set_sync_debug_mode("warn")
        ctx = warnings.catch_warnings(record=True) if counting else contextlib.nullcontext([])
        with ctx as caught:
            if counting:
                warnings.simplefilter("always")
            pdet, cdet = per_frame(cur) if per_frame is not None else (None, None)
            with prof.section("time single frame"):
                if sensor == "stereo":
                    tracker.process_stereo_pair(gray, cur[2], fid, plane_det=pdet, cuboid_det=cdet)
                else:
                    tracker.process_image(gray, fid, depth=cur[2] if sensor == "rgbd" else None,
                                          plane_det=pdet, cuboid_det=cdet)
        if counting:
            torch.cuda.set_sync_debug_mode("default")
            syncs = Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                            if "synchroniz" in str(w.message))
            events = tracker.waits.get("event", 0) - events0
            if events:
                syncs["cuda event"] = events
            kind = "init" if not tracking else "keyframe" if len(tracker._kf_fids) > n_kf else "hot"
            tracker.frame_waits.append((fid, kind, sum(syncs.values()), syncs))
        frame_times.append(time.perf_counter() - t0)
        cur = nxt
    return frame_times


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


def finish(tracker: Tracker, frame_times, gt=None, out_dir: str = "", metric: bool = False):
    """The report of the reference's ``finish``: counts (planes, cuboids and
    loops among them), frame times, per-keyframe stage ms (the loop
    closer's as ``loop_*``), and with ``gt``
    (world->camera poses by frame id) the ATE of the corrected, the raw and
    the live keyframe trajectories, Sim3-aligned, or with ``metric`` (the
    depth sensors' metric maps) SE3-aligned without scale (common.py:365,
    :372, :389).  With ``out_dir``, also the TUM files and CuboidPose.txt /
    PlanePose.txt."""
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
    ft = np.array(frame_times)
    n_created = max(len(tracker._kf_fids), 1)
    # the loop closer's stages beside the keyframe's, averaged over created keyframes
    stage_ms = dict(tracker.stage_ms)
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
        "kf_stage_ms": {k: v / n_created for k, v in sorted(stage_ms.items())},
    }
    if tracker.device.type == "cuda":
        report["kf_stage_device_ms"] = {
            k: v / n_created for k, v in sorted(tracker.stage_device_ms().items())
        }
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
