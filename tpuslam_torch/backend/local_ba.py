"""Local BA: covisibility window -> packed mono factors -> LM solve ->
scatter back (port of the points-only path of ``tpuslam/backend/local_ba.py``).

The window follows Optimizer::LocalBundleAdjustment (Optimizer.cc:461-560):
optimized keyframes are the newest keyframe and its best covisible
neighbours, the next best are held fixed, and the landmarks are the points
the optimized keyframes observe.  Top-k with the lower index first among ties
(``topk_stable``) picks the same window and point order as the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import geometry as geo
from ..graph import lm
from ..kernels.orb import topk_stable
from ..map import mapstate as ms


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
                  n_local_pts: int = 4096) -> LocalBAPack:
    """The points-only BA problem around ``center_kf``.  Slot 0 is always
    fixed (the gauge, Optimizer.cc:2103-2111), as are the fixed frontier and
    empty window lanes."""
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
    mono = lm.MonoFactors(
        kf=kf_local, pt=pt_lc.clamp(min=0), uv=m.kf_uv[kf_global, kp],
        inv_sigma2=_scale_inv_sigma2(m.kf_octave[kf_global, kp]), valid=valid,
    )
    state = lm.BAState(
        poses=m.kf_pose[window_ids], points=m.pt_pos[point_ids],
        planes=m.plane_coef[:1], cuboid_pose=m.cub_pose[:1], cuboid_scale=m.cub_scale[:1],
    )
    data = lm.make_ba_data(W, n_local_pts, 1, 1, cam, mono=mono, pose_fixed=pose_fixed,
                           point_active=point_mask)
    return LocalBAPack(state=state, data=data, window_ids=window_ids, window_mask=window_mask,
                       point_ids=point_ids, point_mask=point_mask)


def unpack_local_ba(m: ms.MapState, pack: LocalBAPack, state_opt: lm.BAState, data_out: lm.BAData,
                    accept=True) -> ms.MapState:
    """Write the optimized poses (renormalized) and points back, unlink the
    observations gated out as outliers (Optimizer.cc:744-760), and kill each
    point left with <= 2 observers by that unlinking.  ``accept`` (a 0-d
    bool tensor) False keeps the map as it was; non-finite lanes always
    keep their old values."""
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
    kf_global = pack.window_ids.repeat_interleave(N)
    kp = torch.arange(N, device=dev).repeat(W)
    flat_idx = torch.where(outlier, kf_global * N + kp, K * N)
    kf_pt = ms._padset(m.kf_pt.reshape(-1), flat_idx, torch.full_like(flat_idx, -1)).reshape(K, N)
    m = m.replace(kf_pose=kf_pose, pt_pos=pt_pos, kf_pt=kf_pt)

    lost_global = pack.point_ids[pack.data.mono.pt.clamp(0, pack.point_ids.shape[0] - 1)]
    lost_pt = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(outlier, lost_global, P), True)[:P]
    return ms.cull_points(m, lost_pt & m.pt_valid & (ms.point_obs_counts(m) <= 2))


def run_local_ba(m: ms.MapState, center_kf: int, cam, cfg):
    """pack -> two-phase solve -> unpack, without a host wait.

    A solve whose last phase-2 chi2 ends above 1.5x its first has diverged
    and is not written back (local_ba.py:629-640 of the reference).
    Returns (map, phase-2 chi2s)."""
    caps = cfg.caps
    pack = pack_local_ba(m, center_kf, cam, n_opt=caps.local_ba_keyframes,
                         n_fixed=caps.local_ba_fixed_keyframes, n_local_pts=caps.local_ba_points)
    w = lm.BAWeights.from_config(cfg.ba)
    state_opt, data_out, chi2s = lm.local_ba(
        pack.state, pack.data, w,
        phase1_iters=cfg.ba.local_ba_iters_phase1, phase2_iters=cfg.ba.local_ba_iters_phase2,
    )
    accept = torch.isfinite(chi2s[-1]) & (chi2s[-1] <= 1.5 * chi2s[0] + 1e-3)
    return unpack_local_ba(m, pack, state_opt, data_out, accept=accept), chi2s
