"""Local BA: covisibility window -> packed factors -> LM solve -> scatter
back (port of the local paths of ``tpuslam/backend/local_ba.py``: points
only, mono or with the stereo bundle of the depth sensors, and the
heterogeneous graph with planes and cuboids), and the global BA that
follows a loop closure (``run_global_ba``).

The window follows Optimizer::LocalBundleAdjustment and
LocalBACameraPlaneCuboids (Optimizer.cc:461-560, 1994-2140): optimized
keyframes are the newest keyframe and its best covisible neighbours, the next
best are held fixed, and the landmarks are the points the optimized
keyframes observe; planes and cuboids are whole-map variables.  Top-k with
the lower index first among ties (``topk_stable``) picks the same window,
point order and owned points as the reference.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import torch

from ..core import geometry as geo
from ..graph import lm
from ..kernels.orb import topk_stable
from ..map import mapstate as ms
from ..semantic.associate import cuboid_plane_pairs


class LocalBAPack(NamedTuple):
    state: lm.BAState
    data: lm.BAData
    window_ids: torch.Tensor  # (W,) keyframe slots (optimized, then fixed)
    window_mask: torch.Tensor  # (W,) bool
    point_ids: torch.Tensor  # (PL,) map point slots
    point_mask: torch.Tensor  # (PL,) bool


def _scale_inv_sigma2(octave, scale_factor: float = 1.2):
    return 1.0 / (scale_factor ** (2.0 * octave.to(torch.float32)))


def pack_local_ba(m: ms.MapState, center_kf: int, cam, n_opt: int = 16, n_fixed: int = 16,
                  n_local_pts: int = 4096, use_planes: bool = False, use_cub_2d: bool = False,
                  use_corners_2d: bool = False, use_cub_3d: bool = False, use_pt_obj: bool = False,
                  use_cub_plane: bool = False, pt_per_cub: int = 64,
                  fix_cuboid_scale: bool = False, use_stereo: bool = False) -> LocalBAPack:
    """The BA problem around ``center_kf``.  Slot 0 is always fixed (the
    gauge, Optimizer.cc:2103-2111), as are the fixed frontier and empty
    window lanes.  With ``use_stereo`` an observation with a right-view
    coordinate (``ur >= 0``) becomes a stereo factor and the rest stay mono,
    both bundles on the same (window keyframe, keypoint) lanes
    (local_ba.py:113-127).  With any other ``use_*`` flag the planes and
    cuboids join as whole-map variables (:func:`_pack_semantic`)."""
    K, N = m.kf_pt.shape
    P = m.pt_pos.shape[0]
    dev = m.kf_pt.device
    cov = ms.covisibility(m)
    w = torch.where(m.kf_valid, cov[center_kf], -1.0)
    w = torch.where(torch.arange(K, device=dev) == center_kf, float("inf"), w)
    top_w, window_ids = topk_stable(w, n_opt + n_fixed)
    opt_mask = (top_w[:n_opt] > 0) | (torch.arange(n_opt, device=dev) == 0)
    window_mask = torch.cat([opt_mask, top_w[n_opt:] > 0])
    W = n_opt + n_fixed
    pose_fixed = torch.arange(W, device=dev) >= n_opt
    pose_fixed = pose_fixed | (window_ids == 0) | ~window_mask

    obs = ms.incidence(m)
    sel_rows = obs[window_ids[:n_opt]] * opt_mask[:, None]
    local_mask = (torch.sum(sel_rows, dim=0) > 0) & m.pt_valid
    sel_val, point_ids = topk_stable(local_mask.to(torch.float32), n_local_pts)
    point_mask = sel_val > 0
    inv_map = ms.scatter_last(
        torch.full((P + 1,), -1, dtype=torch.int64, device=dev),
        torch.where(point_mask, point_ids, P), torch.arange(n_local_pts, device=dev),
    )[:P]

    kf_local = torch.arange(W, device=dev).repeat_interleave(N)
    kf_global = window_ids[kf_local]
    kp = torch.arange(N, device=dev).repeat(W)
    pt_gl = m.kf_pt[kf_global, kp]
    pt_lc = inv_map[pt_gl.clamp(0, P - 1).long()]
    valid = window_mask[kf_local] & m.kf_kp_valid[kf_global, kp] & (pt_gl >= 0) & (pt_lc >= 0)
    uv = m.kf_uv[kf_global, kp]
    inv_s2 = _scale_inv_sigma2(m.kf_octave[kf_global, kp])
    stereo = None
    if use_stereo:
        ur = m.kf_ur[kf_global, kp]
        stereo = lm.StereoFactors(kf=kf_local, pt=pt_lc.clamp(min=0), uvr=torch.cat([uv, ur[:, None]], dim=-1),
                                  inv_sigma2=inv_s2, valid=valid & (ur >= 0))
        valid = valid & (ur < 0)
    mono = lm.MonoFactors(kf=kf_local, pt=pt_lc.clamp(min=0), uv=uv, inv_sigma2=inv_s2, valid=valid)
    flags = dict(use_planes=use_planes, use_cub_2d=use_cub_2d, use_corners_2d=use_corners_2d,
                 use_cub_3d=use_cub_3d, use_pt_obj=use_pt_obj, use_cub_plane=use_cub_plane)
    if any(flags.values()):
        state, data = _pack_semantic(m, cam, window_ids, window_mask, point_ids, point_mask, pose_fixed, mono,
                                     stereo, pt_per_cub, fix_cuboid_scale, **flags)
        return LocalBAPack(state=state, data=data, window_ids=window_ids, window_mask=window_mask,
                           point_ids=point_ids, point_mask=point_mask)
    state = lm.BAState(
        poses=m.kf_pose[window_ids], points=m.pt_pos[point_ids],
        planes=m.plane_coef[:1], cuboid_pose=m.cub_pose[:1], cuboid_scale=m.cub_scale[:1],
    )
    data = lm.make_ba_data(W, n_local_pts, 1, 1, cam, mono=mono, stereo=stereo, pose_fixed=pose_fixed,
                           point_active=point_mask)
    return LocalBAPack(state=state, data=data, window_ids=window_ids, window_mask=window_mask,
                       point_ids=point_ids, point_mask=point_mask)


def _pack_semantic(m: ms.MapState, cam, window_ids, window_mask, point_ids, point_mask, pose_fixed, mono, stereo,
                   pt_per_cub, fix_cuboid_scale, use_planes, use_cub_2d, use_corners_2d, use_cub_3d,
                   use_pt_obj, use_cub_plane):
    """The heterogeneous problem (local_ba.py:158-297 of the reference):
    plane factors per (window keyframe, detection slot, relation kind),
    cuboid factors per (window keyframe, detection slot) with the 5 px
    field-of-view gate on the bbox ones, one point-cuboid factor per
    cuboid, and cuboid-plane factors from the current face association.
    A variable is active when a valid factor refers to it.  A bundle whose
    flag is off is left out (the reference packs it with every lane
    invalid, which adds nothing)."""
    dev = mono.uv.device
    W = window_ids.shape[0]
    Q, C = m.plane_coef.shape[0], m.cub_valid.shape[0]
    L, O = m.kf_plane_valid.shape[1], m.kf_cub_valid.shape[1]
    bundles = {}

    kf_l = torch.arange(W, device=dev).repeat_interleave(L)
    kf_g = window_ids[kf_l]
    sl = torch.arange(L, device=dev).repeat(W)
    base_valid = window_mask[kf_l] & m.kf_plane_valid[kf_g, sl]
    if use_planes:
        def plane_bundle(plane_id_arr, kind):
            pid = plane_id_arr[kf_g, sl].long()
            return lm.PlaneFactors(
                kf=kf_l, plane=pid.clamp(min=0), meas=m.kf_plane_coef[kf_g, sl],
                kind=torch.full((W * L,), kind, dtype=torch.int64, device=dev),
                valid=base_valid & (pid >= 0) & m.plane_valid[pid.clamp(min=0)],
            )

        parts = [plane_bundle(m.kf_plane_map, 0), plane_bundle(m.kf_plane_ver, 1), plane_bundle(m.kf_plane_par, 2)]
        bundles["plane_obs"] = lm.PlaneFactors(*[torch.cat(x) for x in zip(*parts)])

    kf_lc = torch.arange(W, device=dev).repeat_interleave(O)
    kf_gc = window_ids[kf_lc]
    so = torch.arange(O, device=dev).repeat(W)
    cub_id = m.kf_cub_map[kf_gc, so].long()
    cub = cub_id.clamp(min=0)
    bbox = m.kf_cub_bbox[kf_gc, so]
    margin = 5.0  # the field-of-view gate (Optimizer.cc:2458-2461)
    x1 = bbox[:, 0] - bbox[:, 2] / 2
    y1 = bbox[:, 1] - bbox[:, 3] / 2
    in_fov = ((x1 > margin) & (y1 > margin) & (x1 + bbox[:, 2] < cam.width - margin)
              & (y1 + bbox[:, 3] < cam.height - margin))
    cub_base = window_mask[kf_lc] & m.kf_cub_valid[kf_gc, so] & (cub_id >= 0) & m.cub_valid[cub]
    quality = m.kf_cub_quality[kf_gc, so]
    if use_cub_2d:
        bundles["cub_bbox"] = lm.CuboidBBoxFactors(kf=kf_lc, cub=cub, bbox=bbox, weight=quality,
                                                   valid=cub_base & in_fov)
    if use_corners_2d:
        bundles["cub_corner"] = lm.CuboidCornerFactors(kf=kf_lc, cub=cub, corners=m.kf_cub_corners[kf_gc, so],
                                                       weight=quality, valid=cub_base & in_fov)
    if use_cub_3d:
        bundles["cub_se3"] = lm.CuboidSE3Factors(kf=kf_lc, cub=cub, meas_pose=m.kf_cub_local_pose[kf_gc, so],
                                                 meas_scale=m.kf_cub_local_scale[kf_gc, so], weight=quality,
                                                 valid=cub_base)
    if use_pt_obj:
        # each cuboid's owned local points, lower local index first
        owned = (m.pt_cub[point_ids][None, :] == torch.arange(C, device=dev)[:, None]) & point_mask[None, :]
        own_val, own_idx = topk_stable(owned.to(torch.float32), pt_per_cub)  # (C, M)
        bundles["pt_cub"] = lm.PointCuboidFactors(
            cub=torch.arange(C, device=dev), pts=own_idx, pts_mask=own_val,
            weight=torch.ones(C, device=dev), valid=m.cub_valid & (torch.sum(own_val, dim=1) >= 5))
    if use_cub_plane:
        face = cuboid_plane_pairs(m).reshape(-1).long()
        bundles["cub_plane"] = lm.CuboidPlaneFactors(
            cub=torch.arange(C, device=dev).repeat_interleave(Q), plane=torch.arange(Q, device=dev).repeat(C),
            face=face.clamp(min=0), valid=face >= 0)

    def referenced(n, pairs):
        hit = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        for b, idx in pairs:
            hit = hit.index_fill(0, torch.where(b.valid, idx, n), True)
        return hit[:n]

    po = bundles.get("plane_obs")
    plane_active = referenced(Q, [(po, po.plane)] if po is not None else []) & m.plane_valid
    cuboid_active = referenced(C, [(bundles[k], bundles[k].cub) for k in ("cub_bbox", "cub_corner", "cub_se3",
                                                                            "pt_cub") if k in bundles]) & m.cub_valid
    state = lm.BAState(poses=m.kf_pose[window_ids], points=m.pt_pos[point_ids], planes=m.plane_coef,
                       cuboid_pose=m.cub_pose, cuboid_scale=m.cub_scale)
    data = lm.make_ba_data(W, point_ids.shape[0], Q, C, cam, mono=mono, stereo=stereo, pose_fixed=pose_fixed,
                           point_active=point_mask, plane_active=plane_active, cuboid_active=cuboid_active,
                           cuboid_fix_scale=1.0 if fix_cuboid_scale else 0.0, **bundles)
    return state, data


def unpack_local_ba(m: ms.MapState, pack: LocalBAPack, state_opt: lm.BAState, data_out: lm.BAData,
                    stereo_shared: bool = False, accept=True) -> ms.MapState:
    """Write the optimized poses (renormalized) and points back, unlink the
    observations gated out as outliers (Optimizer.cc:744-760), and kill each
    point left with <= 2 observers by that unlinking.  ``accept`` (a 0-d
    bool tensor) False keeps the map as it was; non-finite lanes always
    keep their old values.

    ``stereo_shared``: the stereo bundle shares the mono bundle's lanes, so
    its outliers unlink through the same index (local_ba.py:299-345).  As in
    the reference (local_ba.py:338-339), the stereo outliers are not gated
    by ``accept``: a rejected solve keeps its poses and points but still
    unlinks them, and kills the points they leave under-observed."""
    K, N = m.kf_pt.shape
    P = m.pt_pos.shape[0]
    W = pack.window_ids.shape[0]
    dev = m.kf_pt.device
    if not isinstance(accept, torch.Tensor):
        accept = torch.full((), bool(accept), device=dev)

    new_poses = geo.se3_renorm(state_opt.poses)
    pose_ok = torch.all(torch.isfinite(new_poses).reshape(W, -1), dim=1) & accept
    writable = pack.window_mask & ~data_out.pose_fixed & pose_ok
    kf_pose = ms._padset(m.kf_pose, torch.where(writable, pack.window_ids, K), new_poses)

    pt_ok = torch.all(torch.isfinite(state_opt.points), dim=1) & accept
    pt_pos = ms._padset(m.pt_pos, torch.where(pack.point_mask & pt_ok, pack.point_ids, P), state_opt.points)

    outlier = pack.data.mono.valid & ~data_out.mono.valid & accept
    if stereo_shared:
        outlier = outlier | (pack.data.stereo.valid & ~data_out.stereo.valid)
    kf_global = pack.window_ids.repeat_interleave(N)
    kp = torch.arange(N, device=dev).repeat(W)
    flat_idx = torch.where(outlier, kf_global * N + kp, K * N)
    kf_pt = ms._padset(m.kf_pt.reshape(-1), flat_idx, torch.full_like(flat_idx, -1)).reshape(K, N)
    m = m.replace(kf_pose=kf_pose, pt_pos=pt_pos, kf_pt=kf_pt)

    lost_global = pack.point_ids[pack.data.mono.pt.clamp(0, pack.point_ids.shape[0] - 1)]
    lost_pt = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(outlier, lost_global, P), True)[:P]
    m = ms.cull_points(m, lost_pt & m.pt_valid & (ms.point_obs_counts(m) <= 2))

    # the heterogeneous problem: planes and cuboids were whole-map variables;
    # the active, finite ones go back (Optimizer.cc:2915-2966)
    if state_opt.planes.shape[0] == m.plane_coef.shape[0]:
        pa = data_out.plane_active & torch.all(torch.isfinite(state_opt.planes), dim=1) & accept
        m = m.replace(plane_coef=torch.where(pa[:, None], state_opt.planes, m.plane_coef))
    if state_opt.cuboid_pose.shape[0] == m.cub_pose.shape[0]:
        ok = (data_out.cuboid_active & torch.all(torch.isfinite(state_opt.cuboid_pose).reshape(-1, 16), dim=1)
              & torch.all(torch.isfinite(state_opt.cuboid_scale), dim=1) & accept)
        m = m.replace(cub_pose=torch.where(ok[:, None, None], state_opt.cuboid_pose, m.cub_pose),
                      cub_scale=torch.where(ok[:, None], state_opt.cuboid_scale, m.cub_scale))
    return m


def run_local_ba(m: ms.MapState, center_kf: int, cam, cfg, stats: dict = None):
    """pack -> two-phase solve -> unpack, without a host wait.

    A solve whose last phase-2 chi2 ends above 1.5x its first has diverged
    and is not written back (local_ba.py:629-640 of the reference).  The
    factor types follow the ``optimize_with_*`` flags (Parameters.cc:43-48):
    the heterogeneous graph is built when at least one is on.  The depth
    sensors add the stereo bundle (local_ba.py:513-639).
    ``stats``: a dict that gains, per factor bundle, the number of valid
    factors packed (device scalars, summed over calls; nothing is read).
    Returns (map, phase-2 chi2s)."""
    caps = cfg.caps
    fl = cfg.flags
    depth = cfg.sensor in ("rgbd", "stereo")
    pack = pack_local_ba(
        m, center_kf, cam, n_opt=caps.local_ba_keyframes, n_fixed=caps.local_ba_fixed_keyframes,
        n_local_pts=caps.local_ba_points, use_planes=fl.optimize_with_plane_3d,
        use_cub_2d=fl.optimize_with_cuboid_2d, use_corners_2d=fl.optimize_with_corners_2d,
        use_cub_3d=fl.optimize_with_cuboid_3d, use_pt_obj=fl.optimize_with_pt_obj_3d,
        use_cub_plane=fl.optimize_with_cuboid_plane, pt_per_cub=caps.max_points_per_cuboid,
        fix_cuboid_scale=cfg.ba.cuboid_fix_scale, use_stereo=depth,
    )
    if stats is not None:
        for key in ("mono", "stereo") + tuple(lm.BUNDLES):
            b = getattr(pack.data, key)
            if b is not None:
                stats[key] = stats.get(key, 0) + b.valid.sum()
    w = lm.BAWeights.from_config(cfg.ba)
    state_opt, data_out, chi2s = lm.local_ba(
        pack.state, pack.data, w,
        phase1_iters=cfg.ba.local_ba_iters_phase1, phase2_iters=cfg.ba.local_ba_iters_phase2,
    )
    accept = torch.isfinite(chi2s[-1]) & (chi2s[-1] <= 1.5 * chi2s[0] + 1e-3)
    return unpack_local_ba(m, pack, state_opt, data_out, stereo_shared=depth, accept=accept), chi2s


def pack_global_ba(m: ms.MapState, cam, n_kfs: int = 64, n_pts: int = 8192, use_stereo: bool = False) -> LocalBAPack:
    """The BA problem over keyframe slots ``[0, n_kfs)`` and the ``n_pts``
    best-observed points (GlobalBundleAdjustemnt, Optimizer.cc:46-54:
    every keyframe but slot 0 free).  Points are ranked by observation
    count, the lower slot first among ties (``topk_stable``, as
    ``lax.top_k``), so a truncating budget keeps the best-constrained ones;
    the rest are re-anchored after the solve (:func:`_reanchor_points`)."""
    K, N = m.kf_pt.shape
    P = m.pt_pos.shape[0]
    dev = m.kf_pt.device
    window_ids = torch.arange(n_kfs, device=dev)
    window_mask = m.kf_valid[:n_kfs]
    pose_fixed = (window_ids == 0) | ~window_mask

    obs_rank = torch.where(m.pt_valid, ms.point_obs_counts(m).to(torch.float32), -1.0)
    sel_val, point_ids = topk_stable(obs_rank, n_pts)
    point_mask = sel_val > 0
    inv_map = ms.scatter_last(
        torch.full((P + 1,), -1, dtype=torch.int64, device=dev),
        torch.where(point_mask, point_ids, P), torch.arange(n_pts, device=dev),
    )[:P]

    kf_local = torch.arange(n_kfs, device=dev).repeat_interleave(N)
    kp = torch.arange(N, device=dev).repeat(n_kfs)
    pt_gl = m.kf_pt[kf_local, kp]
    pt_lc = inv_map[pt_gl.clamp(0, P - 1).long()]
    valid = window_mask[kf_local] & m.kf_kp_valid[kf_local, kp] & (pt_gl >= 0) & (pt_lc >= 0)
    uv = m.kf_uv[kf_local, kp]
    inv_s2 = _scale_inv_sigma2(m.kf_octave[kf_local, kp])
    stereo = None
    if use_stereo:
        ur = m.kf_ur[kf_local, kp]
        stereo = lm.StereoFactors(kf=kf_local, pt=pt_lc.clamp(min=0), uvr=torch.cat([uv, ur[:, None]], dim=-1),
                                  inv_sigma2=inv_s2, valid=valid & (ur >= 0))
        valid = valid & (ur < 0)
    mono = lm.MonoFactors(kf=kf_local, pt=pt_lc.clamp(min=0), uv=uv, inv_sigma2=inv_s2, valid=valid)
    state = lm.BAState(poses=m.kf_pose[window_ids], points=m.pt_pos[point_ids], planes=m.plane_coef[:1],
                       cuboid_pose=m.cub_pose[:1], cuboid_scale=m.cub_scale[:1])
    data = lm.make_ba_data(n_kfs, n_pts, 1, 1, cam, mono=mono, stereo=stereo, pose_fixed=pose_fixed,
                           point_active=point_mask)
    return LocalBAPack(state=state, data=data, window_ids=window_ids, window_mask=window_mask,
                       point_ids=point_ids, point_mask=point_mask)


def _ba_bucket(n_needed: int, base: int, cap: int) -> int:
    """The smallest power-of-two multiple of ``base`` that covers
    ``n_needed``, at most ``cap``: the global BA's keyframe and point
    budgets (they decide what the pack takes, not only its padding)."""
    b = base
    while b < n_needed and b < cap:
        b *= 2
    return min(b, cap)


def _reanchor_points(m: ms.MapState, poses_old, skip_mask) -> ms.MapState:
    """Move the points the global BA did not optimize through their
    reference keyframe's pose change, X' = T_new^-1 (T_old X)
    (LoopClosing.cc:709-736)."""
    K = m.kf_pose.shape[0]
    ref = m.pt_first_kf.clamp(0, K - 1).long()
    X_cam = geo.se3_apply(poses_old[ref], m.pt_pos)
    T_new = m.kf_pose[ref]
    X_new = torch.einsum("pji,pj->pi", T_new[:, :3, :3], X_cam - T_new[:, :3, 3])
    move = m.pt_valid & ~skip_mask & m.kf_valid[ref]
    return m.replace(pt_pos=torch.where(move[:, None], X_new, m.pt_pos))


def run_global_ba(m: ms.MapState, cam, cfg, n_iters: int = 10, n_kf: int = 0, should_abort=None, chunk: int = 5,
                  fetch=None):
    """Full-map BA after a loop closure (RunGlobalBundleAdjustment,
    LoopClosing.cc:645-749), synchronous.  The keyframe window is bucketed
    up from ``caps.global_ba_keyframes`` to cover the ``n_kf`` slots in use
    (read from the map when 0), and the point budget up from
    ``caps.global_ba_points`` to cover the valid points; a truncating
    budget is logged and its remainder re-anchored.

    ``should_abort``: a zero-argument callable polled between chunks of
    ``chunk`` LM iterations (the reference's ``mbStopGBA``); on an abort the
    partial state is written back.  The reference's distributed solvers
    are not ported; this is its local path (as ``TPUSLAM_FORCE_LOCAL_BA``
    selects).  ``fetch``: reads device tensors to numpy in one copy (the
    Tracker's counted reads).  Returns (map, chi2 of each iteration's trial
    step)."""
    fetch = fetch or ms.read_numpy
    caps = cfg.caps
    kf_valid_np, n_valid = fetch((m.kf_valid, m.pt_valid.sum()))
    if n_kf <= 0:
        n_kf = int(kf_valid_np.nonzero()[0].max()) + 1 if kf_valid_np.any() else 0
    n_kfs = _ba_bucket(n_kf, caps.global_ba_keyframes, caps.max_keyframes)
    n_valid_pts = int(n_valid)
    n_pts = _ba_bucket(n_valid_pts, caps.global_ba_points, m.pt_pos.shape[0])
    if n_valid_pts > n_pts:
        logging.getLogger("tpuslam_torch").warning(
            "global BA truncating points: %d valid > %d budget; the rest is re-anchored through reference "
            "keyframes", n_valid_pts, n_pts)
    poses_old = m.kf_pose
    depth = cfg.sensor in ("rgbd", "stereo")
    pack = pack_global_ba(m, cam, n_kfs=n_kfs, n_pts=n_pts, use_stereo=depth)
    w = lm.BAWeights.from_config(cfg.ba)
    if should_abort is not None:
        state_opt, chi2s, done = pack.state, [], 0
        while done < n_iters:
            step = min(chunk, n_iters - done)
            state_opt, c = lm.lm_iterations(state_opt, pack.data, w, step)
            chi2s.append(c)
            done += step
            if done < n_iters and should_abort():
                break
        chi2s = torch.cat(chi2s)
    else:
        state_opt, chi2s = lm.lm_iterations(pack.state, pack.data, w, n_iters)
    m = unpack_local_ba(m, pack, state_opt, pack.data, stereo_shared=depth)
    P = m.pt_pos.shape[0]
    in_opt = torch.zeros(P + 1, dtype=torch.bool, device=m.pt_pos.device).index_fill(
        0, torch.where(pack.point_mask, pack.point_ids, P), True)[:P]
    return _reanchor_points(m, poses_old, in_opt), chi2s
