"""Levenberg-Marquardt: motion-only pose optimization and the points-only
bundle adjustment (port of ``tpuslam/graph/lm.py``: ``optimize_pose``, and
``BAState`` through ``local_ba`` for mono reprojection factors).

Loops that the reference writes as ``lax.scan`` or ``lax.while_loop`` are
fixed Python loops here whose accept/reject steps are ``torch.where``, so a
solve enqueues on the device without waiting for it.

The reference stops an LM round early, through ``lax.while_loop``, once an
accepted step is smaller than 1e-6.  Stopping on the host would wait for the
device on every iteration, so here each round runs all its iterations and an
iteration whose round has converged changes nothing: ``T``, ``lam`` and the
step norm are frozen where ``active = dn > 1e-6`` is false.  The result is
that of the early exit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import geometry as geo
from . import factors as fac
from .schur import schur_solve


def _rho_huber(chi2, delta2):
    """Robustified chi2 (g2o RobustKernelHuber::robustify)."""
    return torch.where(
        chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2
    )


def optimize_pose(
    T_init,
    points,
    uv,
    inv_sigma2,
    valid,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    chi2_th: float = 5.991,
    rounds: int = 4,
    iters_per_round: int = 10,
    ur=None,
    bf: float = 0.0,
    chi2_th_stereo: float = 7.815,
):
    """PoseOptimization (Optimizer.cc:247-459): ``rounds`` rounds of
    ``iters_per_round`` LM iterations, Huber-robustified in the first two,
    with inliers re-classified by chi2 between rounds.  Observations with
    ``ur >= 0`` add the stereo row, gated at ``chi2_th_stereo``.

    Returns (T_opt (4, 4), inlier mask (N,), n_inliers () int32)."""
    T_init = geo.se3_renorm(T_init)
    n = points.shape[0]
    dev, dt = points.device, points.dtype
    if ur is None:
        ur = torch.full((n,), -1.0, dtype=dt, device=dev)
    has_ur = ur >= 0
    chi2_lim = torch.where(has_ur, chi2_th_stereo, chi2_th)
    obs = torch.cat([uv, ur[:, None]], dim=-1)
    row_mask = torch.cat([torch.ones_like(uv), has_ur[:, None].to(dt)], dim=-1)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def residuals(T):
        return fac.stereo_residual(T, points, obs, fx, fy, cx, cy, bf) * row_mask

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_sigma2

    def rho(chi2, use_huber):
        return _rho_huber(chi2, chi2_lim) if use_huber else chi2

    def run_round(T, r, inlier, use_huber):
        """One LM round from pose T with residuals r = residuals(T)."""
        lam = torch.full((), 1e-3, dtype=dt, device=dev)
        dn = torch.full((), 1.0, dtype=dt, device=dev)
        for _ in range(iters_per_round):
            active = dn > 1e-6
            J = (fac.stereo_jacobian(T, points, fx, fy, bf) * row_mask[..., None]).reshape(-1, 6)
            chi2 = chi2_of(r)
            w_rob = fac.huber_weight(chi2, chi2_lim) if use_huber else 1.0
            wgt = (w_rob * inlier * inv_sigma2).repeat_interleave(3)
            JtW = J.T * wgt
            H = JtW @ J
            H = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eye6
            # check_errors=False: no wait on the device; a bad solve is
            # non-finite and the accept test below rejects it
            delta, _ = torch.linalg.solve_ex(H, -(JtW @ r.reshape(-1)), check_errors=False)
            T_new = fac.retract_pose(T, delta)
            r_new = residuals(T_new)
            rho_cur = torch.sum(rho(chi2, use_huber) * inlier)
            rho_new = torch.sum(rho(chi2_of(r_new), use_huber) * inlier)
            dn_new = torch.linalg.vector_norm(delta)
            ok = (rho_new < rho_cur) & torch.all(torch.isfinite(T_new)) & torch.isfinite(dn_new)
            step = active & ok
            T = torch.where(step, T_new, T)
            r = torch.where(step, r_new, r)
            lam_next = torch.where(ok, torch.clamp(lam * 0.3, min=1e-7), torch.clamp(lam * 8.0, max=1e4))
            lam = torch.where(active, lam_next, lam)
            dn = torch.where(step, dn_new, dn)
        return T, r

    T = T_init
    r = residuals(T)
    inlier = valid.to(dt)
    for rnd in range(rounds):
        T, r = run_round(T, r, inlier, use_huber=rnd < 2)
        inlier = (valid & (chi2_of(r) <= chi2_lim)).to(dt)
    return T, inlier.bool(), torch.sum(inlier).to(torch.int32)


# ---------------------------------------------------------------------------
# Bundle adjustment: variables and factors
# ---------------------------------------------------------------------------


class BAState(NamedTuple):
    """All optimization variables.  The points-only problem carries the
    reference's one dummy plane and one dummy cuboid, never active, so the
    layout (and ``schur_solve``'s reduced system) is the reference's."""

    poses: torch.Tensor  # (K, 4, 4) world->camera
    points: torch.Tensor  # (P, 3)
    planes: torch.Tensor  # (Q, 4)
    cuboid_pose: torch.Tensor  # (C, 4, 4)
    cuboid_scale: torch.Tensor  # (C, 3)


class MonoFactors(NamedTuple):
    kf: torch.Tensor  # (F,) int window slot
    pt: torch.Tensor  # (F,) int local point
    uv: torch.Tensor  # (F, 2)
    inv_sigma2: torch.Tensor  # (F,)
    valid: torch.Tensor  # (F,) bool


class BAData(NamedTuple):
    """Everything but the variables: the mono factors, gauges and camera.
    The reference's stereo, plane and cuboid bundles wait for their slice."""

    pose_fixed: torch.Tensor  # (K,) bool
    point_active: torch.Tensor  # (P,) bool
    plane_active: torch.Tensor  # (Q,) bool
    cuboid_active: torch.Tensor  # (C,) bool
    mono: MonoFactors
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    cuboid_fix_scale: float = 0.0


def make_ba_data(poses_k: int, points_p: int, planes_q: int, cuboids_c: int, cam, *, mono,
                 pose_fixed=None, point_active=None, plane_active=None, cuboid_active=None,
                 cuboid_fix_scale: float = 0.0) -> BAData:
    """BAData with absent gauges defaulted as the reference does."""
    dev = mono.uv.device

    def full(n, v):
        return torch.full((n,), v, dtype=torch.bool, device=dev)

    return BAData(
        pose_fixed=pose_fixed if pose_fixed is not None else full(poses_k, False),
        point_active=point_active if point_active is not None else full(points_p, True),
        plane_active=plane_active if plane_active is not None else full(planes_q, False),
        cuboid_active=cuboid_active if cuboid_active is not None else full(cuboids_c, False),
        mono=mono, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
        cuboid_fix_scale=cuboid_fix_scale,
    )


class BAWeights(NamedTuple):
    """Information scalars and Huber chi2 thresholds (the reference's
    ``BAWeights``, field for field; the mono solve reads ``chi2_mono``)."""

    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    plane_angle_info: float = 3282.8
    plane_dist_info: float = 10000.0
    plane_chi: float = 500.0
    plane_vp_info: float = 13131.2
    plane_vp_chi: float = 200.0
    bbox_chi: float = 80.0
    corner_chi: float = 10.0
    se3_chi: float = 900.0
    se3_weight: float = 1.0
    pt_obj_chi: float = 10.0
    pt_obj_weight: float = 1.0
    max_outside_margin_ratio: float = 1.0
    pt_obj_prior_weight: float = 0.2
    cub_plane_angle_info: float = 820.7
    cub_plane_dist_info: float = 10000.0
    cub_plane_chi: float = 500.0

    @staticmethod
    def from_config(ba):
        return BAWeights(
            chi2_mono=ba.chi2_mono,
            chi2_stereo=ba.chi2_stereo,
            plane_angle_info=3282.8 / ba.plane_angle_info**2,
            plane_dist_info=ba.plane_dist_info**2,
            plane_chi=ba.plane_chi,
            plane_vp_info=3282.8 / ba.plane_par_sigma**2,
            plane_vp_chi=ba.plane_vp_chi,
            bbox_chi=ba.th_huber_bbox_2d,
            corner_chi=ba.th_huber_corner_2d,
            se3_chi=ba.th_huber_se3,
            se3_weight=ba.ba_weight_se3,
            pt_obj_chi=ba.th_huber_pt_obj,
            pt_obj_weight=ba.ba_weight_pt_obj,
            max_outside_margin_ratio=ba.max_outside_margin_ratio,
            cub_plane_angle_info=3282.8 / ba.cuboid_plane_angle_info**2,
            cub_plane_dist_info=ba.cuboid_plane_dist_info**2,
            cub_plane_chi=ba.cuboid_plane_chi,
        )


# crossing between the packages: one packed problem fed to both solvers


def _np(t):
    return t.detach().cpu().numpy()


def ba_state_to_numpy(state: BAState) -> dict:
    return {k: _np(getattr(state, k)) for k in BAState._fields}


def ba_state_from_numpy(fields: dict, device) -> BAState:
    return BAState(**{k: torch.tensor(np.asarray(fields[k]), device=device) for k in BAState._fields})


def ba_data_to_numpy(data: BAData) -> dict:
    out = {k: getattr(data, k) for k in BAData._fields}
    for k in ("pose_fixed", "point_active", "plane_active", "cuboid_active"):
        out[k] = _np(out[k])
    out["mono"] = {k: _np(getattr(data.mono, k)) for k in MonoFactors._fields}
    return out


def ba_data_from_numpy(fields: dict, device) -> BAData:
    """From ``{field: value}`` keyed by the reference's ``BAData`` fields
    (``mono`` a dict of its ``MonoFactors``; extra keys ignored)."""

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    mono = MonoFactors(**{k: t(fields["mono"][k]) for k in MonoFactors._fields})
    mono = mono._replace(kf=mono.kf.long(), pt=mono.pt.long())
    return BAData(
        pose_fixed=t(fields["pose_fixed"]), point_active=t(fields["point_active"]),
        plane_active=t(fields["plane_active"]), cuboid_active=t(fields["cuboid_active"]),
        mono=mono, **{k: float(np.asarray(fields[k])) for k in ("fx", "fy", "cx", "cy", "bf")},
        cuboid_fix_scale=float(np.asarray(fields.get("cuboid_fix_scale", 0.0))),
    )


# ---------------------------------------------------------------------------
# Assembly, retraction and the LM loop
# ---------------------------------------------------------------------------


def _layout(state: BAState):
    K = state.poses.shape[0]
    C = state.cuboid_pose.shape[0]
    Q = state.planes.shape[0]
    return K, C, Q, 6 * K + 9 * C + 3 * Q


def _rho_sum(chi2, delta2, valid):
    """Robust total chi2, invalid or non-finite factors masked out."""
    rho = _rho_huber(chi2, delta2)
    return torch.sum(torch.where(valid & torch.isfinite(rho), rho, 0.0))


def build_system(state: BAState, data: BAData, w: BAWeights):
    """Normal equations of the mono factors and their robust total chi2:
    (H_cc (D, D), H_cl (D, P, 3), H_ll (P, 3, 3), b_c (D,), b_l (P, 3), chi2).

    The reference assembles kf-major lanes with one one-hot matmul per
    keyframe (a TPU idiom that avoids a scatter); here each lane's 6x6, 3x3,
    6x3, 6 and 3 blocks are summed with ``index_add``.  Float atomics on the
    card make the sums reproducible to rounding only."""
    K, C, Q, D = _layout(state)
    P = state.points.shape[0]
    dev = state.points.device
    m = data.mono
    T, X = state.poses[m.kf], state.points[m.pt]
    r = fac.mono_residual(T, X, m.uv, data.fx, data.fy, data.cx, data.cy)
    Jp, Jx = fac.mono_jacobians(T, X, data.fx, data.fy)
    v = m.valid
    r = torch.where(v[:, None], r, 0.0)
    Jp = torch.where(v[:, None, None], Jp, 0.0)
    Jx = torch.where(v[:, None, None], Jx, 0.0)
    chi2 = torch.sum(r * r, dim=-1) * m.inv_sigma2
    wf = fac.huber_weight(chi2, w.chi2_mono) * v
    chi2_total = _rho_sum(chi2, w.chi2_mono, v)

    wgt = (m.inv_sigma2 * wf)[:, None, None]
    JpW, JxW = Jp * wgt, Jx * wgt
    Hpp = torch.einsum("fri,frj->fij", JpW, Jp)
    bp = -torch.einsum("fri,fr->fi", JpW, r)
    Hxx = torch.einsum("fri,frj->fij", JxW, Jx)
    bx = -torch.einsum("fri,fr->fi", JxW, r)
    Hpx = torch.einsum("fri,frj->fij", JpW, Jx)

    pose_blocks = torch.zeros((K, 6, 6), device=dev).index_add(0, m.kf, Hpp)
    rows = 6 * torch.arange(K, device=dev)[:, None] + torch.arange(6, device=dev)[None, :]
    H_cc = torch.zeros((D, D), device=dev).index_put((rows[:, :, None], rows[:, None, :]), pose_blocks)
    pose_b = torch.zeros((K, 6), device=dev).index_add(0, m.kf, bp)
    b_c = torch.zeros(D, device=dev).index_put((rows.reshape(-1),), pose_b.reshape(-1))
    H_ll = torch.zeros((P, 3, 3), device=dev).index_add(0, m.pt, Hxx)
    b_l = torch.zeros((P, 3), device=dev).index_add(0, m.pt, bx)
    cross = torch.zeros((K * P, 6, 3), device=dev).index_add(0, m.kf * P + m.pt, Hpx)
    H_cl = cross.reshape(K, P, 6, 3).permute(0, 2, 1, 3).reshape(6 * K, P, 3)
    H_cl = torch.cat([H_cl, torch.zeros((D - 6 * K, P, 3), device=dev)])
    return H_cc, H_cl, H_ll, b_c, b_l, chi2_total


def total_chi2(state: BAState, data: BAData, w: BAWeights):
    """Robust total chi2 of the mono factors (LM accept/reject)."""
    m = data.mono
    r = fac.mono_residual(state.poses[m.kf], state.points[m.pt], m.uv, data.fx, data.fy, data.cx, data.cy)
    return _rho_sum(torch.sum(r * r, dim=-1) * m.inv_sigma2, w.chi2_mono, m.valid)


def retract_state(state: BAState, data: BAData, delta_c, delta_l) -> BAState:
    """Apply a step: poses by left SE3 retraction (fixed ones held), active
    points additively.  The dummy plane and cuboid are never active; a zero
    step leaves them as they are, so they pass through unchanged."""
    K, C, Q, D = _layout(state)
    free = (~data.pose_fixed)[:, None].to(delta_c.dtype)
    poses = fac.retract_pose(state.poses, delta_c[: 6 * K].reshape(K, 6) * free)
    points = fac.retract_point(state.points, delta_l * data.point_active[:, None])
    return state._replace(poses=poses, points=points)


def _free_mask(state: BAState, data: BAData):
    K, C, Q, D = _layout(state)
    pose_free = (~data.pose_fixed).to(torch.float32).repeat_interleave(6)
    cub_free = data.cuboid_active.to(torch.float32).repeat_interleave(9)
    dim9 = torch.arange(9, device=cub_free.device).repeat(C)
    cub_free = cub_free * torch.where((dim9 >= 6) & (data.cuboid_fix_scale > 0), 0.0, 1.0)
    plane_free = data.plane_active.to(torch.float32).repeat_interleave(3)
    return torch.cat([pose_free, cub_free, plane_free])


def lm_iterations(state: BAState, data: BAData, w: BAWeights, n_iters: int, lam0: float = 1e-4):
    """``n_iters`` LM iterations with accept/reject and adaptive damping.
    Returns (state, chi2 of each iteration's trial step (n_iters,)).

    A trial with a non-finite pose or point is rejected.  The reference
    accepts one whose chi2 fell, and its chi2 masks non-finite factors out:
    a step that overflows some poses drops their factors and "lowers" the
    chi2, and the outlier gate then unlinks every observation of those
    poses.  On the card, where float atomics reorder the sums, one such
    step emptied most of the golden replay's map and tracking was lost for
    good.  Where every trial is finite, as in all the parity tests, the two
    agree."""
    free_c = _free_mask(state, data)
    point_active = data.point_active.to(torch.float32)
    lam = torch.full((), lam0, device=free_c.device)
    chi2s = []
    for _ in range(n_iters):
        H_cc, H_cl, H_ll, b_c, b_l, chi2_cur = build_system(state, data, w)
        delta_c, delta_l = schur_solve(H_cc, H_cl, H_ll, b_c, b_l, lam, free_c, point_active)
        trial = retract_state(state, data, delta_c, delta_l)
        chi2_new = total_chi2(trial, data, w)
        finite = torch.isfinite(trial.poses).all() & torch.isfinite(trial.points).all()
        ok = (chi2_new < chi2_cur) & torch.isfinite(chi2_new) & finite
        state = BAState(*(torch.where(ok, b, a) for a, b in zip(state, trial)))
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-7), torch.clamp(lam * 8.0, max=1e4))
        chi2s.append(chi2_new)
    return state, torch.stack(chi2s)


def gate_observations(state: BAState, data: BAData, w: BAWeights) -> BAData:
    """Disable mono observations above the chi2 threshold or behind the
    camera (Optimizer.cc:700-786)."""
    m = data.mono
    T, X = state.poses[m.kf], state.points[m.pt]
    r = fac.mono_residual(T, X, m.uv, data.fx, data.fy, data.cx, data.cy)
    chi2 = torch.sum(r * r, dim=-1) * m.inv_sigma2
    z = geo.se3_apply(T, X)[:, 2]
    return data._replace(mono=m._replace(valid=m.valid & (chi2 <= w.chi2_mono) & (z > 0)))


def local_ba(state: BAState, data: BAData, w: BAWeights, phase1_iters: int = 5, phase2_iters: int = 10):
    """Two-phase local BA (LocalBundleAdjustment, Optimizer.cc:461-786):
    optimize, gate outliers, optimize again, gate again.
    Returns (state, data with the final gate, phase-2 chi2s)."""
    state, _ = lm_iterations(state, data, w, phase1_iters)
    data = gate_observations(state, data, w)
    state, chi2s = lm_iterations(state, data, w, phase2_iters)
    data = gate_observations(state, data, w)
    return state, data, chi2s
