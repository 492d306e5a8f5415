"""Per-frame tracking program (port of the device functions of
``tpuslam/frontend/tracking.py``, tracking.py:40-425).

``track_image_and_decide`` is the whole tracked-frame path: ORB extraction,
the motion-model match, the reference-keyframe match, the local-map match,
motion-only pose optimization after each, and the keyframe-decision
scalars.  It makes no host sync: no ``.item()``, no data-dependent Python
branch, no boolean-mask indexing; every choice is a tensor select, so the
host can enqueue the next frame from this frame's device outputs.

``ref_kf`` is a Python int: the host owns the reference keyframe.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import geometry as geo
from ..core.camera import Camera, undistort_points
from ..graph import lm
from ..kernels import match as km
from ..kernels.orb import Features, OrbExtractor, topk_stable
from ..map import mapstate as ms


class Frame(NamedTuple):
    uv: torch.Tensor  # (N, 2) undistorted pixels
    octave: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,)
    desc: torch.Tensor  # (N, 8) int32 words
    valid: torch.Tensor  # (N,) bool
    ur: torch.Tensor  # (N,) right-view u (stereo/RGBD), -1 for mono
    depth: torch.Tensor  # (N,) depth, -1 unknown


class TrackStep(NamedTuple):
    """Outputs of the per-frame tracking program."""

    T: torch.Tensor  # (4, 4) optimized pose
    kp_pt: torch.Tensor  # (N,) int32 keypoint -> map point binding
    m: ms.MapState  # map with updated found/visible counters
    # (9,) int32: [n_mm, n_rf, used_rf, n_final, n_ref_obs2, n_ref_obs3,
    # n_valid_kf, n_close_tracked, n_close_free]
    scalars: torch.Tensor
    T_ref: torch.Tensor  # (4, 4) reference-KF pose at track time
    velocity: torch.Tensor  # (4, 4) next-frame motion model T_new @ inv(T_prev)


def frame_from_features(feats: Features, cam: Camera, ur=None, depth=None) -> Frame:
    n = feats.uv.shape[0]

    def unknown():
        return torch.full((n,), -1.0, dtype=torch.float32, device=feats.uv.device)

    return Frame(
        uv=undistort_points(cam, feats.uv),
        octave=feats.octave,
        angle=feats.angle,
        desc=feats.desc,
        valid=feats.valid,
        ur=unknown() if ur is None else ur,
        depth=unknown() if depth is None else depth,
    )


def sample_depth_at_keypoints(feats_uv, depth_map, bf: float):
    """Depth lookup + virtual right coordinate per keypoint
    (Frame::ComputeStereoFromRGBD: ur = u - bf/z)."""
    H, W = depth_map.shape
    x = torch.clamp(torch.round(feats_uv[:, 0]).long(), 0, W - 1)
    y = torch.clamp(torch.round(feats_uv[:, 1]).long(), 0, H - 1)
    z = depth_map[y, x]
    ok = z > 0
    ur = torch.where(ok, feats_uv[:, 0] - bf / torch.clamp(z, min=1e-6), -1.0)
    return torch.where(ok, z, -1.0), ur


def _project(cam: Camera, pc):
    z = torch.clamp(pc[:, 2], min=1e-6)
    return torch.stack([cam.fx * pc[:, 0] / z + cam.cx, cam.fy * pc[:, 1] / z + cam.cy], dim=-1)


def _inv_sigma2(octave):
    return 1.0 / (1.2 ** (2.0 * octave.to(torch.float32)))


def _bind(n: int, tgt, values):
    """(n,) int32 bindings: -1, then ``values[i]`` at ``tgt[i]``; rows with
    ``tgt == n`` write nowhere, and where two rows hit one keypoint the
    higher row wins, as the reference's scatter does on the CPU."""
    base = torch.full((n + 1,), -1, dtype=torch.int32, device=tgt.device)
    return ms.scatter_last(base, tgt, values)[:n]


def _count(n: int, idx):
    """(n,) int32 occurrences of each index below n (index n is dropped)."""
    ones = torch.ones(idx.shape[0], dtype=torch.int32, device=idx.device)
    return torch.zeros(n + 1, dtype=torch.int32, device=idx.device).index_add(
        0, idx.long(), ones
    )[:n]


def match_motion_model(m: ms.MapState, frame: Frame, last_pt, last_angle, last_octave, T_pred,
                       cam: Camera, radius: float):
    """SearchByProjection(current, last) (ORBmatcher.cc:1328-1470) + pose
    optimization -> (T_opt, kp_pt, n_inliers).  The window scales with the
    last observation's octave and candidates keep to octaves within +-1."""
    lp = torch.clamp(last_pt, min=0).long()
    has_pt = (last_pt >= 0) & m.pt_valid[lp]
    X = m.pt_pos[lp]
    pc = geo.se3_apply(T_pred, X)
    uv_pred = _project(cam, pc)
    vis = has_pt & (pc[:, 2] > 0)
    radius_row = radius * 1.2 ** last_octave.to(torch.float32)
    gate = km.window_gate(uv_pred, frame.uv, radius_row)
    gate = gate & km.octave_gate(last_octave, frame.octave, -1, 1)
    idx, _, ok = km.match_descriptors(
        m.pt_desc[lp], frame.desc, vis, frame.valid, gate_mask=gate, max_dist=100.0, ratio=0.9
    )
    ok = km.rotation_consistency(last_angle, frame.angle, idx, ok)
    T_opt, inl, n_in = lm.optimize_pose(
        T_pred, X, frame.uv[idx], _inv_sigma2(frame.octave[idx]), ok,
        cam.fx, cam.fy, cam.cx, cam.cy, ur=frame.ur[idx], bf=cam.bf,
    )
    N = frame.uv.shape[0]
    bound = ok & inl
    kp_pt = _bind(N, torch.where(bound, idx, N), torch.where(bound, last_pt, -1))
    return T_opt, kp_pt, n_in


def match_reference_kf(m: ms.MapState, frame: Frame, ref_kf: int, T_init, cam: Camera):
    """TrackReferenceKeyFrame (Tracking.cc:988-1031): ungated descriptor
    matching against the reference KF's bound keypoints (kernel K2), then
    pose optimization -> (T_opt, kp_pt, n_inliers, n_matches)."""
    ref_pt = m.kf_pt[ref_kf]
    has_pt = (ref_pt >= 0) & m.kf_kp_valid[ref_kf]
    idx, _, ok = km.match_descriptors(
        frame.desc, m.kf_desc[ref_kf], frame.valid, has_pt, max_dist=50.0, ratio=0.7
    )
    ok = km.rotation_consistency(frame.angle, m.kf_angle[ref_kf], idx, ok)
    pt_ids = torch.where(ok, ref_pt[idx], -1)
    X = m.pt_pos[torch.clamp(pt_ids, min=0).long()]
    matched = ok & (pt_ids >= 0)
    T_opt, inl, n_in = lm.optimize_pose(
        T_init, X, frame.uv, _inv_sigma2(frame.octave), matched,
        cam.fx, cam.fy, cam.cx, cam.cy, ur=frame.ur, bf=cam.bf,
    )
    kp_pt = torch.where(matched & inl, pt_ids, -1)
    return T_opt, kp_pt, n_in, torch.sum(matched)


def track_local_map(m: ms.MapState, frame: Frame, kp_pt, T_init, ref_kf: int, cam: Camera,
                    n_local: int = 4096, radius: float = 6.0, n_local_kfs: int = 80):
    """TrackLocalMap (Tracking.cc:1163-1208): project the covisibility-local
    point set, bind more keypoints, optimize the pose again.  The local
    keyframes are the reference KF's first-order covisible neighbours, then
    their own neighbours, capped at ``n_local_kfs``.

    Returns (T_opt, kp_pt_out, n_inliers, map_with_updated_counters)."""
    N = frame.uv.shape[0]
    P = m.pt_pos.shape[0]
    K = m.kf_pose.shape[0]
    dev = m.kf_pt.device
    obs = ms.incidence(m)
    cov = ms.covisibility_of(obs)
    w1 = torch.where(m.kf_valid, cov[ref_kf], -1.0)
    first = (w1 > 0) | (torch.arange(K, device=dev) == ref_kf)
    # second-order score: strongest covisibility link into the first-order set
    w2 = torch.max(cov * first[:, None].to(cov.dtype), dim=0).values
    w2 = torch.where(m.kf_valid & ~first, w2, -1.0)
    combined = torch.where(m.kf_valid, torch.where(w1 > 0, 1e6 + w1, w2), -1.0)
    combined = torch.where(torch.arange(K, device=dev) == ref_kf, float("inf"), combined)
    n_kfs = min(n_local_kfs, K)
    top_w, kf_top = topk_stable(combined, n_kfs)
    kf_mask = (top_w > 0) | (torch.arange(n_kfs, device=dev) == 0)
    local_mask = (torch.sum(obs[kf_top] * kf_mask[:, None], dim=0) > 0) & m.pt_valid
    sel_val, pt_ids = topk_stable(local_mask.to(torch.float32), n_local)
    pt_mask = sel_val > 0

    X = m.pt_pos[pt_ids]
    pc = geo.se3_apply(T_init, X)
    z_ok = pc[:, 2] > 0.05
    uv_proj = _project(cam, pc)
    in_img = (
        (uv_proj[:, 0] >= 0) & (uv_proj[:, 0] < cam.width)
        & (uv_proj[:, 1] >= 0) & (uv_proj[:, 1] < cam.height)
    )
    # isInFrustum scale/viewing gates (Frame::isInFrustum); points without
    # computed stats (max_dist sentinel 1e9) pass unconditionally
    C = -T_init[:3, :3].T @ T_init[:3, 3]
    po = X - C
    dist = torch.linalg.vector_norm(po, dim=-1)
    max_d = m.pt_max_dist[pt_ids]
    normal = m.pt_normal[pt_ids]
    has_band = max_d < 1e8
    in_band = (dist >= 0.8 * m.pt_min_dist[pt_ids]) & (dist <= 1.2 * max_d)
    view_cos = torch.sum(po * normal, dim=-1) / torch.clamp(dist, min=1e-9)
    has_normal = torch.linalg.vector_norm(normal, dim=-1) > 0.5
    frustum_ok = ~has_band | (in_band & (~has_normal | (view_cos > 0.5)))
    visible = pt_mask & z_ok & in_img & frustum_ok
    # already-bound map points must not be double-bound
    already = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(kp_pt >= 0, kp_pt, P).long(), True
    )[:P]
    candidate = visible & ~already[pt_ids]
    kp_free = frame.valid & (kp_pt < 0)
    # predicted-octave search radius (ORBmatcher.cc:45-157): radius * s^pred,
    # candidate octaves in [pred-1, pred]
    pred_lvl = ms.predict_scale_level(dist, max_d)
    gate = km.window_gate(uv_proj, frame.uv, radius * 1.2**pred_lvl)
    gate = gate & km.octave_gate(pred_lvl.to(torch.int32), frame.octave, -1, 0)
    idx, _, ok = km.match_descriptors(
        m.pt_desc[pt_ids], frame.desc, candidate, kp_free, gate_mask=gate, max_dist=50.0, ratio=0.8
    )
    # bind new matches; the highest candidate row wins a contested keypoint
    add = _bind(N, torch.where(ok, idx, N), torch.where(ok, pt_ids, -1))
    kp_pt2 = torch.where(kp_pt >= 0, kp_pt, add)

    T_opt, inl, n_in = lm.optimize_pose(
        T_init, m.pt_pos[torch.clamp(kp_pt2, min=0).long()], frame.uv,
        _inv_sigma2(frame.octave), kp_pt2 >= 0, cam.fx, cam.fy, cam.cx, cam.cy,
        ur=frame.ur, bf=cam.bf,
    )
    kp_pt_out = torch.where((kp_pt2 >= 0) & inl, kp_pt2, -1)

    # found/visible counters (MapPoint::IncreaseVisible/Found)
    vis_add = _count(P, torch.where(visible, pt_ids, P))
    fnd_add = _count(P, torch.where(kp_pt_out >= 0, kp_pt_out, P))
    m = m.replace(pt_visible=m.pt_visible + vis_add, pt_found=m.pt_found + fnd_add)
    return T_opt, kp_pt_out, n_in, m


def track_and_decide(
    m: ms.MapState,
    frame: Frame,
    T_cur,
    velocity,
    last_kp_pt,
    last_angle,
    last_octave,
    ref_kf: int,
    cam: Camera,
    radius_motion: float,
    radius_localmap: float,
    min_track_motion: int,
    th_depth: float,
    n_local: int = 4096,
    n_local_kfs: int = 80,
) -> TrackStep:
    """The whole per-frame tracking path on one frame's features: motion-model
    match + pose opt, the reference-KF match (computed unconditionally,
    selected by inlier count), the local-map track, and every scalar the
    keyframe decision (NeedNewKeyFrame, Tracking.cc:1227-1252) needs."""
    T_pred = geo.se3_renorm(velocity @ T_cur)
    T_mm, kp_mm, n_mm = match_motion_model(
        m, frame, last_kp_pt, last_angle, last_octave, T_pred, cam, radius_motion
    )
    T_rf, kp_rf, n_rf, _ = match_reference_kf(m, frame, ref_kf, T_cur, cam)
    used_rf = n_mm < min_track_motion
    T1 = torch.where(used_rf, T_rf, T_mm)
    kp1 = torch.where(used_rf, kp_rf, kp_mm)
    T2, kp2, n_final, m = track_local_map(
        m, frame, kp1, T1, ref_kf, cam, n_local=n_local, radius=radius_localmap,
        n_local_kfs=n_local_kfs,
    )

    obs_count = ms.point_obs_counts(m)
    ref_pt = m.kf_pt[ref_kf]
    ref_ok = (ref_pt >= 0) & m.kf_kp_valid[ref_kf]
    ref_obs = obs_count[torch.clamp(ref_pt, min=0).long()]
    close = frame.valid & (frame.depth > 0) & (frame.depth < th_depth)
    scalars = torch.stack(
        [
            n_mm.to(torch.int32),
            n_rf.to(torch.int32),
            used_rf.to(torch.int32),
            n_final.to(torch.int32),
            torch.sum(ref_ok & (ref_obs >= 2)).to(torch.int32),
            torch.sum(ref_ok & (ref_obs >= 3)).to(torch.int32),
            torch.sum(m.kf_valid).to(torch.int32),
            torch.sum(close & (kp2 >= 0)).to(torch.int32),
            torch.sum(close & (kp2 < 0)).to(torch.int32),
        ]
    )
    return TrackStep(
        T=T2, kp_pt=kp2, m=m, scalars=scalars, T_ref=m.kf_pose[ref_kf],
        velocity=T2 @ geo.se3_inv(T_cur),
    )


def track_image_and_decide(
    m: ms.MapState,
    gray,
    depth,
    T_cur,
    velocity,
    last_kp_pt,
    last_angle,
    last_octave,
    ref_kf: int,
    cam: Camera,
    radius_motion: float,
    radius_localmap: float,
    min_track_motion: int,
    th_depth: float,
    extractor: OrbExtractor,
    n_local: int = 4096,
    n_local_kfs: int = 80,
    has_depth: bool = False,
):
    """:func:`track_and_decide` with ORB extraction in front: image in,
    (TrackStep, Frame) out.  ``extractor`` carries the reference's static
    ORB settings (n_features, n_levels, scale_factor, thresholds)."""
    feats = extractor(gray.to(torch.float32))
    d = ur = None
    if has_depth:
        d, ur = sample_depth_at_keypoints(feats.uv, depth, cam.bf)
    frame = frame_from_features(feats, cam, ur=ur, depth=d)
    step = track_and_decide(
        m, frame, T_cur, velocity, last_kp_pt, last_angle, last_octave, ref_kf, cam,
        radius_motion, radius_localmap, min_track_motion, th_depth,
        n_local=n_local, n_local_kfs=n_local_kfs,
    )
    return step, frame
