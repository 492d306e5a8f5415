"""Plane and cuboid association and their map updates (port of
``tpuslam/semantic/associate.py``).

Re-design of Tracking::AssociatePlanes (world-frame coefficient gating,
Tracking.cc:2586-2683), Tracking::AssociateCuboids (candidate gate by owned
map points, association by class name or shared-point voting, outlier cull,
Tracking.cc:2127-2343) and Tracking::AssociatePlanesAndCuboids (cuboid
face-plane matching, Tracking.cc:2685-2773).

The gating runs on the device; the allocation loops (at most 16 plane and 8
cuboid detections) run on the host over masks read back in one copy each,
as in the reference.  ``fetch`` is how a caller reads device tensors: the
``Tracker`` passes its pinned copy behind one CUDA event, so that the wait
is counted.  Offline detections arrive as host numpy and go up in pinned
memory; online plane detections (RGB-D) are already on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import geometry as geo
from ..map import mapstate as ms
from .detect import CuboidDetections, PlaneDetections


def read_now(tensors):
    """The default ``fetch``: a blocking copy of each tensor to numpy."""
    return [t.cpu().numpy() for t in tensors]


def _up(a, dev):
    """A host array on ``dev``; from pinned memory without a wait on a card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t.clone()


def _set_row(a, slot: int, value):
    out = a.clone()
    out[slot] = value
    return out


# ---------------------------------------------------------------------------
# Planes
# ---------------------------------------------------------------------------


def plane_association_scores(m: ms.MapState, Tcw, coef, valid):
    """World-frame gating of detections against the map planes
    (Tracking.cc:2597-2637).  ``coef`` (L, 4) camera-frame detections and
    ``valid`` (L,) on the device.  Returns (world coefficients (L, 4), and
    per relation direct / vertical / parallel (L,) the best map plane or
    -1; the first index wins a tie, as ``jnp.argmin`` / ``argmax``)."""
    world = geo.plane_transform(geo.se3_inv(Tcw), coef)
    world = torch.where(world[..., 3:4] < 0, -world, world)
    angle = torch.sum(world[:, None, :3] * m.plane_coef[None, :, :3], dim=-1)  # (L, Q)
    dist = world[:, None, 3] - m.plane_coef[None, :, 3]
    valid_pair = valid[:, None] & m.plane_valid[None, :]
    inf = float("inf")

    def pick(ok, cost, fill, use_max=False):
        cost = torch.where(ok, cost, fill)
        best = torch.argmax(cost, dim=1) if use_max else torch.argmin(cost, dim=1)
        return torch.where(torch.any(ok, dim=1), best, -1).to(torch.int32)

    direct_ok = valid_pair & (torch.abs(dist) < 0.4) & (torch.abs(angle) > 0.8)
    direct = pick(direct_ok, torch.abs(dist), inf)
    ver = pick(valid_pair & (torch.abs(angle) < 0.08716), torch.abs(angle), inf)  # cos 85 deg
    par = pick(valid_pair & (torch.abs(angle) > 0.9962), torch.abs(angle), -inf, use_max=True)  # cos 5 deg
    # a direct match supersedes the structural relations for the same plane
    ver = torch.where(direct >= 0, -1, ver)
    par = torch.where(direct >= 0, -1, par)
    return world, direct, ver, par


def associate_planes(m: ms.MapState, kf_slot: int, det: PlaneDetections, n_planes: int, fetch=read_now):
    """Associate the detections of keyframe ``kf_slot`` and allocate a map
    plane, with the view's world coefficients, for each unmatched one
    (Tracking.cc:2654-2680).  ``det`` is host numpy or, from the online
    segmentation, tensors; either way one ``fetch`` reads what the host
    loop needs.  Returns (map, n_planes)."""
    dev = m.kf_pose.device
    L = det.coef.shape[0]
    Q = m.plane_coef.shape[0]
    online = isinstance(det.valid, torch.Tensor)
    if online:
        valid, coef = det.valid.to(dev), det.coef.to(dev)
    else:
        valid_np = np.asarray(det.valid)
        valid, coef = _up(valid_np, dev), _up(det.coef, dev)
    world, direct, ver, par = plane_association_scores(m, m.kf_pose[kf_slot], coef, valid)
    if online:
        direct_np, valid_np = fetch((direct, valid))
    else:
        (direct_np,) = fetch((direct,))
    direct_np = direct_np.copy()
    plane_coef, plane_valid = m.plane_coef, m.plane_valid
    new = []
    for i in range(L):
        if valid_np[i] and direct_np[i] < 0 and n_planes < Q:
            new.append((n_planes, i))
            direct_np[i] = n_planes
            n_planes += 1
    if new:
        slots = _up(np.array([q for q, _ in new], np.int64), dev)
        rows = _up(np.array([i for _, i in new], np.int64), dev)
        plane_coef = plane_coef.index_copy(0, slots, world[rows])
        plane_valid = plane_valid.index_fill(0, slots, True)
    direct = _up(direct_np, dev)
    obs_add = torch.zeros(Q + 1, dtype=torch.int32, device=dev).index_add(
        0, torch.where(valid & (direct >= 0), direct, Q).long(), torch.ones(L, dtype=torch.int32, device=dev))[:Q]
    m = m.replace(
        plane_coef=plane_coef, plane_valid=plane_valid,
        kf_plane_coef=_set_row(m.kf_plane_coef, kf_slot, coef),
        kf_plane_valid=_set_row(m.kf_plane_valid, kf_slot, valid),
        kf_plane_map=_set_row(m.kf_plane_map, kf_slot, direct),
        kf_plane_ver=_set_row(m.kf_plane_ver, kf_slot, ver),
        kf_plane_par=_set_row(m.kf_plane_par, kf_slot, par),
        plane_obs_count=m.plane_obs_count + obs_add,
    )
    return m, n_planes


# ---------------------------------------------------------------------------
# Cuboids
# ---------------------------------------------------------------------------


def keypoints_in_bboxes(uv, kp_valid, bboxes, bbox_valid):
    """(N,) frame-local cuboid index per keypoint, -1 for none or more than
    one containing bbox (Tracking.cc:2072-2100)."""
    cx, cy, w, h = bboxes[:, 0], bboxes[:, 1], bboxes[:, 2], bboxes[:, 3]
    x1, y1 = cx - w / 2, cy - h / 2
    inside = (
        (uv[:, None, 0] >= x1[None]) & (uv[:, None, 0] <= (x1 + w)[None])
        & (uv[:, None, 1] >= y1[None]) & (uv[:, None, 1] <= (y1 + h)[None])
        & kp_valid[:, None] & bbox_valid[None, :]
    )
    count = torch.sum(inside, dim=1)
    first = torch.argmax(inside.to(torch.int32), dim=1).to(torch.int32)  # the first containing bbox
    return torch.where(count == 1, first, -1)


def cuboid_point_votes(m: ms.MapState, kp_pt, kp_cub):
    """owned (O,): keypoints with a map point inside each bbox
    (MapCuboid::check_enough_map_points); votes (O, C): how many of them
    landmark c already owns (shared-point association, Tracking.cc:2219-2283)."""
    O = m.kf_cub_valid.shape[1]
    C = m.cub_valid.shape[0]
    dev = kp_pt.device
    has_pt = (kp_pt >= 0) & (kp_cub >= 0)
    one = torch.ones(kp_pt.shape[0], dtype=torch.int32, device=dev)
    owned = torch.zeros(O + 1, dtype=torch.int32, device=dev).index_add(
        0, torch.where(has_pt, kp_cub, O).long(), one)[:O]
    pt_owner = torch.where(has_pt, m.pt_cub[kp_pt.clamp(min=0).long()], -1)
    pair = torch.where((pt_owner >= 0) & (kp_cub >= 0), kp_cub * C + pt_owner, O * C)
    votes = torch.zeros(O * C + 1, dtype=torch.int32, device=dev).index_add(0, pair.long(), one)
    return owned, votes[: O * C].reshape(O, C)


def associate_cuboids(m: ms.MapState, kf_slot: int, det: CuboidDetections, kp_pt, n_cubs: int, cfg,
                      fetch=read_now):
    """Cuboid association for a new keyframe (Tracking.cc:2127-2343): the
    candidate gate of ``cuboid_min_own_points`` owned points, then the class
    name (``flags.associate_cuboid_with_classname``) or shared-point voting,
    else a new landmark from the global detection; then point ownership and
    the outlier cull.  Returns (map, n_cubs)."""
    sem = cfg.semantic
    dev = m.kf_pose.device
    C = m.cub_valid.shape[0]
    O = det.bbox.shape[0]
    P = m.pt_cub.shape[0]
    det_valid = np.asarray(det.valid)
    valid_d = _up(det_valid, dev)
    kp_cub = keypoints_in_bboxes(m.kf_uv[kf_slot], m.kf_kp_valid[kf_slot], _up(det.bbox, dev), valid_d)
    owned, votes = cuboid_point_votes(m, kp_pt, kp_cub)
    owned_np, votes_np, cub_class, cub_valid = fetch((owned, votes, m.cub_class, m.cub_valid))
    cub_class, cub_valid = cub_class.copy(), cub_valid.copy()
    det_class = np.asarray(det.classid)

    assoc = np.full(O, -1, np.int32)
    new = []  # (landmark, detection)
    for o in range(O):
        if not det_valid[o] or owned_np[o] < sem.cuboid_min_own_points:
            continue
        target = -1
        if cfg.flags.associate_cuboid_with_classname:
            matches = np.where(cub_valid & (cub_class == det_class[o]))[0]
            if len(matches) > 0:
                target = int(matches[0])
        else:
            best = votes_np[o].copy()
            best[~cub_valid] = 0
            if best.max() >= sem.cuboid_shared_point_votes:
                target = int(best.argmax())
        if target < 0 and n_cubs < C:
            target = n_cubs
            new.append((target, o))
            cub_valid[target] = True
            cub_class[target] = det_class[o]
            n_cubs += 1
        if target >= 0:
            assoc[o] = target

    cub_pose, cub_scale, cub_valid_d = m.cub_pose, m.cub_scale, m.cub_valid
    cub_class_d, cub_first_kf = m.cub_class, m.cub_first_kf
    if new:
        t_np = np.array([t for t, _ in new], np.int64)
        o_np = np.array([o for _, o in new], np.int64)
        t = _up(t_np, dev)
        cub_pose = cub_pose.index_copy(0, t, _up(det.global_pose[o_np], dev))
        cub_scale = cub_scale.index_copy(0, t, _up(det.global_scale[o_np], dev))
        cub_valid_d = cub_valid_d.index_fill(0, t, True)
        cub_class_d = cub_class_d.index_copy(0, t, _up(det_class[o_np].astype(np.int32), dev))
        cub_first_kf = cub_first_kf.index_fill(0, t, kf_slot)
    hit = assoc[assoc >= 0].astype(np.int64)
    cub_obs_count, cub_last_kf = m.cub_obs_count, m.cub_last_kf
    if len(hit):
        h = _up(hit, dev)
        cub_obs_count = cub_obs_count.index_add(0, h, torch.ones(len(hit), dtype=torch.int32, device=dev))
        cub_last_kf = cub_last_kf.index_fill(0, h, kf_slot)

    assoc_d = _up(assoc, dev)
    m = m.replace(
        cub_pose=cub_pose, cub_scale=cub_scale, cub_valid=cub_valid_d, cub_class=cub_class_d,
        cub_first_kf=cub_first_kf, cub_obs_count=cub_obs_count, cub_last_kf=cub_last_kf,
        kf_cub_local_pose=_set_row(m.kf_cub_local_pose, kf_slot, _up(det.local_pose, dev)),
        kf_cub_local_scale=_set_row(m.kf_cub_local_scale, kf_slot, _up(det.local_scale, dev)),
        kf_cub_bbox=_set_row(m.kf_cub_bbox, kf_slot, _up(det.bbox, dev)),
        kf_cub_corners=_set_row(m.kf_cub_corners, kf_slot, _up(det.corners, dev)),
        kf_cub_quality=_set_row(m.kf_cub_quality, kf_slot, _up(det.quality, dev)),
        kf_cub_valid=_set_row(m.kf_cub_valid, kf_slot, valid_d & (assoc_d >= 0)),
        kf_cub_map=_set_row(m.kf_cub_map, kf_slot, assoc_d),
        kf_kp_cub=_set_row(m.kf_kp_cub, kf_slot, kp_cub),
    )
    # point ownership: keypoints with a map point inside an associated bbox
    # adopt its landmark (MapCuboid.cc:277-299, simplified to direct
    # ownership and a vote count).  Two keypoints of one point target the
    # same slot: the later keypoint wins, as the reference's scatter-set on
    # the CPU (ms.scatter_last).
    lm_of_kp = torch.where(kp_cub >= 0, assoc_d[kp_cub.clamp(min=0).long()], -1)
    ok = (kp_pt >= 0) & (lm_of_kp >= 0)
    tgt = torch.where(ok, kp_pt.long(), P)
    pad = torch.zeros(1, dtype=m.pt_cub.dtype, device=dev)
    pt_cub = ms.scatter_last(torch.cat([m.pt_cub, pad]), tgt, torch.where(ok, lm_of_kp, -1))[:P]
    votes_new = torch.cat([torch.where(pt_cub == m.pt_cub, m.pt_cub_votes, 0), pad]).index_add(
        0, tgt, torch.ones(tgt.shape[0], dtype=m.pt_cub_votes.dtype, device=dev))[:P]
    m = m.replace(pt_cub=pt_cub, pt_cub_votes=votes_new)

    # outlier cull (Tracking.cc:2286-2313)
    stale = ~m.cub_good & m.cub_valid & (m.cub_first_kf < kf_slot - sem.cuboid_cull_after_kfs)
    kill = stale & (m.cub_obs_count < sem.cuboid_cull_min_obs)
    return m.replace(
        cub_valid=m.cub_valid & ~kill,
        cub_good=m.cub_good | (stale & ~kill),
        pt_cub=torch.where(kill[m.pt_cub.clamp(min=0).long()] & (m.pt_cub >= 0), -1, m.pt_cub),
    ), n_cubs


# ---------------------------------------------------------------------------
# Cuboid-plane association (for the EdgeCuboidPlane analogue)
# ---------------------------------------------------------------------------


def cuboid_plane_pairs(m: ms.MapState):
    """(C, Q) the matched face of each (cuboid, plane) pair, or -1: gate
    |dist| < 0.2 and |cos| > 0.9397 (Tracking.cc:2736-2757); the first face
    wins a tie."""
    faces = geo.cuboid_face_planes(m.cub_pose, m.cub_scale)  # (C, 6, 4)
    angle = torch.sum(faces[:, :, None, :3] * m.plane_coef[None, None, :, :3], dim=-1)  # (C, 6, Q)
    dist = faces[:, :, None, 3] - m.plane_coef[None, None, :, 3]
    ok = ((torch.abs(dist) < 0.2) & (torch.abs(angle) > 0.9397)
          & m.cub_valid[:, None, None] & m.plane_valid[None, None, :])
    best_face = torch.argmin(torch.where(ok, torch.abs(dist), float("inf")), dim=1).to(torch.int32)
    return torch.where(torch.any(ok, dim=1), best_face, -1)
