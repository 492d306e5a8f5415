"""Local mapping: triangulation of new points, duplicate fusion and point
culling (port of ``tpuslam/backend/mapping.py``).

CreateNewMapPoints, MapPointCulling and the SearchInNeighbors fuse of
LocalMapping.cc, each a handful of batched tensor programs per keyframe; the
host (``Tracker``) hands out point slots.  Every function returns a new
``MapState`` and writes into no tensor of the one it was given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import geometry as geo
from ..frontend.initializer import triangulate
from ..kernels import match as km
from ..kernels.orb import topk_stable
from ..map import mapstate as ms


class TriangulationResult(NamedTuple):
    pos: torch.Tensor  # (..., N, 3) new point positions (world)
    kp1: torch.Tensor  # (N,) keypoint index in kf1
    kp2: torch.Tensor  # (..., N) keypoint index in kf2
    ok: torch.Tensor  # (..., N) bool


def _centre(T):
    return -torch.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])


def fundamental_between(T1, T2, K):
    """F12 with x1^T F12 x2 = 0: the epipolar line of a view-1 point in
    image 2 is F12^T x1 (LocalMapping::ComputeF12).  T2 may be batched."""
    T12 = T1 @ geo.se3_inv(T2)
    E = geo.so3_hat(T12[..., :3, 3]) @ T12[..., :3, :3]
    Kinv, _ = torch.linalg.inv_ex(K)
    return Kinv.T @ E @ Kinv


def create_new_map_points(m: ms.MapState, kf1: int, kf2, K, scale_factor: float = 1.2):
    """Triangulate new points between keyframe ``kf1`` and keyframe(s)
    ``kf2`` (an int, or a (L,) tensor: one lane per neighbour).  Only unbound
    keypoints take part; the checks follow LocalMapping.cc:244-492 (depth in
    both views, parallax, reprojection chi2 < 5.991 sigma^2, scale
    consistency)."""
    batched = isinstance(kf2, torch.Tensor) and kf2.dim() == 1
    dev = m.kf_pt.device
    kf2 = kf2.long() if batched else torch.arange(kf2, kf2 + 1, device=dev)
    N = m.kf_pt.shape[1]
    sf = scale_factor
    T1, T2 = m.kf_pose[kf1], m.kf_pose[kf2]  # (4, 4), (L, 4, 4)
    uv1, uv2_all = m.kf_uv[kf1], m.kf_uv[kf2]
    oct1 = m.kf_octave[kf1].to(torch.float32)
    oct2 = m.kf_octave[kf2].to(torch.float32)
    free1 = m.kf_kp_valid[kf1] & (m.kf_pt[kf1] < 0)
    free2 = m.kf_kp_valid[kf2] & (m.kf_pt[kf2] < 0)

    F12 = fundamental_between(T1, T2, K)
    gate = km.epipolar_gate(uv1, uv2_all, F12, torch.sqrt(sf ** (2.0 * oct2)))
    gate = gate & km.octave_gate(m.kf_octave[kf1], m.kf_octave[kf2], -2, 2)
    # epipole gate (ORBmatcher.cc:688-700): a kf2 keypoint within 10*scale px
    # of kf1's centre seen in kf2 has next to no parallax
    c_in2 = geo.se3_apply(T2, _centre(T1))  # (L, 3)
    safe_z = torch.where(torch.abs(c_in2[:, 2]) < 1e-6, 1e-6, c_in2[:, 2])
    ep = torch.stack([K[0, 0] * c_in2[:, 0] / safe_z + K[0, 2],
                      K[1, 1] * c_in2[:, 1] / safe_z + K[1, 2]], dim=-1)
    dist_ep2 = torch.sum((uv2_all - ep[:, None, :]) ** 2, dim=-1)
    far = (dist_ep2 >= 100.0 * sf**oct2) | (c_in2[:, 2:3] < 0)
    gate = gate & far[:, None, :]
    idx, _, ok = km.match_descriptors(
        m.kf_desc[kf1], m.kf_desc[kf2], free1, free2, gate_mask=gate,
        max_dist=50.0, ratio=0.8, mutual=True,
    )
    ok = km.rotation_consistency(m.kf_angle[kf1], m.kf_angle[kf2], idx, ok)
    uv2 = uv2_all.gather(1, idx[..., None].expand(-1, -1, 2))
    oct2m = oct2.gather(1, idx)

    pts = triangulate(T1, T2, uv1, uv2, K)  # (L, N, 3)
    finite = torch.all(torch.isfinite(pts), dim=-1)
    pc1 = geo.se3_apply(T1, pts)
    pc2 = geo.se3_apply(T2[:, None], pts)
    r1 = pts - _centre(T1)
    r2 = pts - _centre(T2)[:, None, :]
    d1 = torch.linalg.vector_norm(r1, dim=-1)
    d2 = torch.linalg.vector_norm(r2, dim=-1)
    cosp = torch.sum(r1 * r2, dim=-1) / (d1 * d2 + 1e-12)

    def reproj_err(pc, uv):
        q = pc @ K.T
        q = q[..., :2] / torch.where(torch.abs(q[..., 2:3]) < 1e-12, 1e-12, q[..., 2:3])
        return torch.sum((q - uv) ** 2, dim=-1)

    e1 = reproj_err(pc1, uv1)
    e2 = reproj_err(pc2, uv2)
    # scale consistency (LocalMapping.cc:458-470)
    ratio_dist = d1 / torch.clamp(d2, min=1e-9)
    ratio_octave = sf**oct1 / sf**oct2m
    ratio_factor = 1.5 * sf
    scale_ok = (ratio_dist < ratio_octave * ratio_factor) & (ratio_dist * ratio_factor > ratio_octave)
    good = (
        ok & finite & (pc1[..., 2] > 0) & (pc2[..., 2] > 0) & (cosp < 0.9998)
        & (e1 < 5.991 * sf ** (2.0 * oct1)) & (e2 < 5.991 * sf ** (2.0 * oct2m)) & scale_ok
    )
    kp1 = torch.arange(N, dtype=torch.int32, device=dev)
    kp2 = idx.to(torch.int32)
    if batched:
        return TriangulationResult(pos=pts, kp1=kp1, kp2=kp2, ok=good)
    return TriangulationResult(pos=pts[0], kp1=kp1, kp2=kp2[0], ok=good[0])


def triangulate_with_neighbors(m: ms.MapState, kf1: int, K, min_baseline: float = 0.0, scale_factor: float = 1.2,
                               mono: bool = True, n_nb: int = 10):
    """CreateNewMapPoints against the ``n_nb`` best covisible neighbours
    (weight >= 15) at once.  Per-lane gating (LocalMapping.cc:276-296,
    mapping.py:174-179 of the reference): mono, baseline / median scene
    depth >= 0.01; stereo and RGB-D, baseline >= ``min_baseline`` (the rig
    baseline, bf / fx).  A keypoint triangulated in several lanes keeps its
    best-covisibility lane.

    Returns (pos (L, N, 3), kp2 (L, N), chosen (L, N) bool, nb_ids (L,))."""
    n_kf = m.kf_pose.shape[0]
    dev = m.kf_pt.device
    cov = ms.covisibility(m)
    weights = torch.where(m.kf_valid, cov[kf1], -1.0)
    weights = torch.where(torch.arange(n_kf, device=dev) == kf1, -1.0, weights)
    top_w, nb_ids = topk_stable(weights, n_nb)
    nb_mask = top_w >= 15.0
    base = torch.linalg.vector_norm(_centre(m.kf_pose[kf1]) - _centre(m.kf_pose[nb_ids]), dim=-1)
    if mono:
        med = ms.scene_median_depth(m, nb_ids)
        good_nb = (med > 0) & torch.isfinite(med) & (base / torch.clamp(med, min=1e-9) >= 0.01)
    else:
        good_nb = base >= min_baseline
    tri = create_new_map_points(m, kf1, nb_ids, K, scale_factor=scale_factor)
    ok = tri.ok & good_nb[:, None] & nb_mask[:, None]
    lane = torch.argmax(ok.to(torch.uint8), dim=0)  # first True lane = best covisibility
    chosen = ok & (torch.arange(ok.shape[0], device=dev)[:, None] == lane[None, :])
    return tri.pos, tri.kp2, chosen, nb_ids


def insert_triangulated(m: ms.MapState, kf1: int, pos, kp2, chosen, nb_ids, avail, cap: int,
                        fid: int | None = None):
    """Insert the chosen triangulations: slots by lane rank from the host's
    ``avail`` candidate list (lanes past ``cap`` drop), new points written,
    both keyframes' bindings scattered.  Returns (map, n_inserted), the count
    still on the device."""
    L_nb, N = chosen.shape
    dev = chosen.device
    flat_good = chosen.reshape(-1)
    rank = torch.cumsum(flat_good.to(torch.int64), 0) - 1
    slot = avail[rank.clamp(0, avail.shape[0] - 1)].to(torch.int32)
    good = flat_good & (slot < cap)
    L = L_nb * N
    desc = m.kf_desc[kf1][None].expand(L_nb, N, 8).reshape(-1, 8)
    m = ms.add_points(
        m, slot, pos.reshape(-1, 3), desc,
        torch.zeros((L, 3), device=dev), torch.zeros(L, device=dev), torch.full((L,), 1e9, device=dev),
        torch.full((L,), kf1, dtype=torch.int32, device=dev), good,
        first_fid=None if fid is None else torch.full((L,), fid, dtype=torch.int32, device=dev),
    )
    kp1_flat = torch.arange(N, dtype=torch.int32, device=dev).repeat(L_nb)
    m = ms.assign_observations_flat(m, torch.full((L,), kf1, device=dev), kp1_flat, slot, good)
    nb_rows = nb_ids[:, None].expand(L_nb, N).reshape(-1)
    m = ms.assign_observations_flat(m, nb_rows, kp2.reshape(-1), slot, good)
    return m, torch.sum(good).to(torch.int32)


def fuse_into_keyframe(m: ms.MapState, kf: int, K, src_mask=None, radius: float = 3.0):
    """Project the map points (those in ``src_mask``, or all) into keyframe
    ``kf`` and fuse (ORBmatcher::Fuse): a free matching keypoint adopts the
    point; a keypoint bound to another point merges the two, the
    better-observed winning (MapPoint::Replace: links redirected, loser
    invalidated, its found/visible counters transferred)."""
    P = m.pt_pos.shape[0]
    dev = m.kf_pt.device
    pc = geo.se3_apply(m.kf_pose[kf], m.pt_pos)
    q = pc @ K.T
    uv = q[:, :2] / torch.where(torch.abs(q[:, 2:3]) < 1e-9, 1e-9, q[:, 2:3])
    visible = m.pt_valid & (pc[:, 2] > 0)
    if src_mask is not None:
        visible = visible & src_mask
    kf_row = m.kf_pt[kf]
    bound_here = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(kf_row >= 0, kf_row, P).long(), True)[:P]
    visible = visible & ~bound_here
    gate = km.window_gate(m.kf_uv[kf], uv, radius)
    idx, _, ok = km.match_descriptors(
        m.kf_desc[kf], m.pt_desc, m.kf_kp_valid[kf], visible,
        gate_mask=gate, max_dist=50.0, ratio=0.9,
    )
    src = idx.to(torch.int32)
    free = kf_row < 0
    new_row = torch.where(ok & free, src, kf_row)
    m = m.replace(kf_pt=ms._set_row(m.kf_pt, kf, new_row))
    merge = ok & ~free & (src != kf_row)
    obs_count = ms.point_obs_counts(m)
    dst = kf_row.clamp(min=0)
    src_wins = obs_count[src.long()] >= obs_count[dst.long()]
    winner = torch.where(merge, torch.where(src_wins, src, dst), 0)
    loser = torch.where(merge, torch.where(src_wins, dst, src), P)  # P drops the write
    rep = ms.scatter_last(torch.arange(P + 1, dtype=torch.int32, device=dev), loser, winner)
    rep = rep[rep.long()]  # collapse 2-chains (a -> b, b -> c)
    kf_pt = torch.where(m.kf_pt >= 0, rep[m.kf_pt.clamp(min=0).long()], m.kf_pt)
    dead = rep[:P] != torch.arange(P, dtype=torch.int32, device=dev)
    to = rep[:P].long()
    fnd = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_add(
        0, to, torch.where(dead, m.pt_found, 0))[:P]
    vis = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_add(
        0, to, torch.where(dead, m.pt_visible, 0))[:P]
    return m.replace(
        kf_pt=kf_pt, pt_valid=m.pt_valid & ~dead,
        pt_found=m.pt_found + fnd, pt_visible=m.pt_visible + vis,
    )


def fuse_duplicates(m: ms.MapState, kf: int, K):
    """Project every map point into ``kf`` and fuse (SearchInNeighbors)."""
    return fuse_into_keyframe(m, kf, K)


def point_cull_mask(m: ms.MapState, fid_recent_min: int, fid_old_max: int):
    """Bad recently created points (MapPointCulling, LocalMapping.cc:207-242):
    a point created at or after frame ``fid_recent_min`` (the 4th-newest
    keyframe's) is culled for a found/visible ratio below 0.25, or, when it
    was created at or before ``fid_old_max`` (the 3rd-newest's), for <= 2
    observers."""
    obs_count = ms.point_obs_counts(m)
    ratio = m.pt_found.to(torch.float32) / torch.clamp(m.pt_visible, min=1).to(torch.float32)
    recent = (m.pt_first_fid >= fid_recent_min) & (m.pt_first_fid >= 0)
    old2 = m.pt_first_fid <= fid_old_max
    return m.pt_valid & recent & ((ratio < 0.25) | (old2 & (obs_count <= 2)))
