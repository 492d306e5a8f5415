"""The numbers ``correct`` compares, worked out from what the sessions of
the window returned and left, against the plain references: the ground
truth the frozen renderer knows, the plain keypoint selection and steered
BRIEF, and the plain Hamming search.  Every number is an error (lower is
better).

Poses returned, over every session of the run (a session the window cut
included):

- ``rpe_deg_max``: the largest angle between a returned frame-to-frame
  rotation (consecutive poses) and the true one, over the pairs that one
  map served: a pair whose first frame's call ran a keyframe's chain is
  left out, since the next frame is the first tracked against the map that
  local BA has just corrected, and its jump is that correction;
- ``rpe_deg_p50``: the median of that angle over every pair of the run's
  sessions, pooled (a pose that stops moving reads the true step, 0.72
  degrees in ``walk``);
- ``rpe_dir_deg_p50``: the median over the same pairs of the angle between
  the returned and the true direction of the frame-to-frame translation
  (scale-free; an estimated motion of zero reads 180);
- ``ate_m``, ``rot_deg_max`` (printed, not compared): the RMSE of the
  returned camera centres after a Sim3 fit per map-scale epoch, and the
  largest rotation relative to the session's first pose.

The map each session left, over the sessions that ran their whole clip
(where the window cut every session, the harness finishes the first after
the window has closed; none: every map number reads inf):

- ``kf_ate_m``: RMSE of the final map's keyframe centres after one Sim3
  fit to the truth, metres (the map is rescaled as a whole, so one fit
  holds it);
- ``pt_surface_m_p50``: the median distance of the final map's points,
  carried into the truth's frame by a similarity fit of the keyframes'
  whole poses, to the room's nearest surface;
- ``plane_deg_max``, ``plane_m_max``: the final map's planes against the
  room's (normal angle, offset); ``cuboid_m_max``: the map's cuboid
  centres against the nearest true box's (configurations with planes and
  objects).

Extraction and search:

- ``kp_mismatch_share``: the share of keyframe keypoints (level, y, x) in
  the program's set or the plain reference's but not both, over the
  reference's count, pooled over every keyframe the maps keep;
  ``kp_level0_mismatch``: the count of those at level 0, where the
  arithmetic is integer and the two must agree exactly;
- ``desc_bit_mismatch_share``: the share of descriptor bits of those
  keyframe keypoints that differ from the plain steered BRIEF at the same
  (level, y, x): float32 rounding tips almost none, TF32 resizes many;
- ``k2_mismatch_rows``: rows of the sampled calls of kernel K2 whose index
  or distances differ from the plain search (integer: exact); inf when no
  call was sampled;
- ``lost_frames`` (the harness's): frames after a session's first pose that
  got none.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from . import hamming as H
from . import keypoints as KP
from .. import scene


def pose_numbers(res: dict, gt_cw) -> dict:
    """Per-pair errors and the worst pair of one session's returned poses."""
    traj = res["trajectory"]
    if len(traj) < 2:
        inf = float("inf")
        never = not traj and res.get("completed", True)  # a whole clip that never initialized
        return {"rot": [inf] if never else [], "dir": [inf] if never else [], "max": inf if never else 0.0}
    est = [T for _, T in traj]
    gt = [gt_cw[f] for f, _ in traj]
    kinds = res.get("kinds", {})
    rot = G.rpe_rot_deg(est, gt)
    served = [r for i, (r, (f, _)) in enumerate(zip(rot, traj)) if kinds.get(f) != "keyframe"]
    out = {"rot": list(rot), "dir": list(G.rpe_dir_deg(est, gt)), "max": max(served, default=0.0)}
    if len(traj) >= 3:
        epochs = res.get("epochs", {})
        out["ate_m"] = G.ate_by_epoch(est, gt, [epochs.get(f) for f, _ in traj])[0]
        out["rot_deg_max"] = float(G.rotation_drift_deg(est, gt).max())
    return out


def map_numbers(res: dict, gt_cw, config: dict, spec) -> dict:
    """The numbers of the map one session left."""
    out = {}
    live = np.flatnonzero(res["kf_valid"])
    live = [s for s in live if np.isfinite(res["kf_pose"][s]).all()]
    if len(live) < 3:
        return {k: float("inf") for k in map_keys(config)}
    est = [res["kf_pose"][s] for s in live]
    gt = [gt_cw[int(res["kf_frame_id"][s])] for s in live]
    out["kf_ate_m"] = G.ate_rmse(est, gt)[0]
    s, R, t = G.pose_alignment(est, gt)
    pts = res["pt_pos"]
    centers, halfs, yaws = scene.box_frames(spec)
    world = (s * (R @ np.asarray(pts, np.float64).reshape(-1, 3).T)).T + t
    out["pt_surface_m_p50"] = (float(np.median(G.surface_distance(world, scene.room_planes(spec), centers, halfs,
                                                                    yaws))) if len(world) else float("inf"))
    if config["detections"] == "offline":
        pe = G.plane_errors(res["plane_coef"], s, R, t, scene.room_planes(spec))
        out["plane_deg_max"] = max((d for d, _ in pe), default=0.0)
        out["plane_m_max"] = max((m for _, m in pe), default=0.0)
        cub = np.asarray(res.get("cub_pose", np.zeros((0, 4, 4))), np.float64).reshape(-1, 4, 4)
        c_world = (s * (R @ cub[:, :3, 3].T)).T + t
        true_c = np.asarray(centers, np.float64)
        out["cuboid_m_max"] = max((float(np.linalg.norm(true_c - c, axis=1).min()) for c in c_world), default=0.0)
    return out


def map_keys(config: dict):
    keys = ["kf_ate_m", "pt_surface_m_p50"]
    return keys + (["plane_deg_max", "plane_m_max", "cuboid_m_max"] if config["detections"] == "offline" else [])


class KeypointReference:
    """The plain keypoint selection of a clip's frames, each frame computed
    once on ``device``."""

    def __init__(self, frames, config: dict, device):
        self.frames, self.device = frames, device
        o, k = config["orb"], config["keypoints"]
        self.kw = dict(n_features=o["n_features"], n_levels=o["n_levels"], scale_factor=o["scale_factor"],
                       ini_th=float(o["ini_th_fast"]), min_th=float(o["min_th_fast"]), **k)
        self.cache = {}

    def rows(self, fid: int):
        if fid not in self.cache:
            img = self.frames[fid].to(self.device)
            self.cache[fid] = KP.select_keypoints(img, **self.kw).numpy()
        return self.cache[fid]

    def compare(self, res: dict):
        """(mismatched rows, rows wanted, mismatched rows at level 0,
        differing descriptor bits, bits compared) over the keyframes the
        session's map keeps."""
        bad = want = bad0 = bits = nbits = 0
        for s in np.flatnonzero(res["kf_valid"]):
            valid = res["kf_kp_valid"][s]
            got = KP.keypoint_rows(res["kf_uv"][s], res["kf_octave"][s], valid, self.kw["scale_factor"],
                                   self.kw["n_levels"])
            fid = int(res["kf_frame_id"][s])
            ref = self.rows(fid)
            n, per = KP.mismatch(got, ref)
            bad += n
            want += len(ref)
            bad0 += per.get(0, (0, 0))[0]
            desc = KP.descriptors(self.frames[fid].to(self.device), got, self.kw["n_levels"],
                                  self.kw["scale_factor"])
            bits += KP.bit_mismatch(res["kf_desc"][s][valid], desc.numpy())
            nbits += 256 * len(got)
        return bad, want, bad0, bits, nbits


def _worse(a: float, b: float) -> float:
    """The larger error; a number that is not a number reads inf."""
    return float("inf") if np.isnan(a) or np.isnan(b) else max(a, b)


def numbers(results, clip, config: dict, device, k2_samples=None) -> dict:
    """The compared numbers over every session of a run; ``k2_samples``:
    the recorded calls of kernel K2 (``program.K2Samples.host()``), or None
    where none were recorded."""
    spec = scene.SceneSpec(seed=clip.scene_seed)
    out = {}
    rot, dirs = [], []
    for r in results:
        p = pose_numbers(r, clip.gt_cw)
        rot += p["rot"]
        dirs += p["dir"]
        out["rpe_deg_max"] = _worse(out.get("rpe_deg_max", 0.0), p["max"])
        for k in ("ate_m", "rot_deg_max"):
            if k in p:
                out[k] = _worse(out.get(k, -np.inf), p[k])
    out["rpe_deg_p50"] = float(np.median(rot)) if rot else float("inf")
    out["rpe_dir_deg_p50"] = float(np.median(dirs)) if dirs else float("inf")
    whole = [r for r in results if r.get("whole", r.get("completed", True))]
    for k in map_keys(config):
        out[k] = float("inf") if not whole else -np.inf
    for r in whole:
        for k, v in map_numbers(r, clip.gt_cw, config, spec).items():
            out[k] = _worse(out[k], v)
    kp = KeypointReference(clip.frames, config, device)
    tot = np.zeros(5, np.int64)
    with torch.no_grad():
        for r in results:
            tot += np.array(kp.compare(r), np.int64)
    bad, want, bad0, bits, nbits = (int(v) for v in tot)
    out["kp_mismatch_share"] = bad / want if want else float("inf")
    out["kp_level0_mismatch"] = float(bad0)
    out["desc_bit_mismatch_share"] = bits / nbits if nbits else float("inf")
    if k2_samples is not None:
        out["k2_mismatch_rows"] = (float(sum(H.mismatched_rows(c) for c in k2_samples)) if k2_samples
                                   else float("inf"))
    return {k: float(v) for k, v in out.items()}
