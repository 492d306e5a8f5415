"""Levenberg-Marquardt: motion-only pose optimization and the bundle
adjustment of the heterogeneous graph (port of ``tpuslam/graph/lm.py``:
``optimize_pose``, and ``BAState`` through ``local_ba`` for the mono,
stereo, plane and cuboid factors).  ``lm_iterations`` is also the body of
the factor-sharded solve across ranks (``dist/ba.py``), which passes it
the all-reduce of the normal equations and chi2.

Loops that the reference writes as ``lax.scan`` or ``lax.while_loop`` are
fixed Python loops here whose accept/reject steps are ``torch.where``, so a
solve enqueues on the device without waiting for it.

The reference stops an LM round early, through ``lax.while_loop``, once an
accepted step is smaller than 1e-6.  Stopping on the host would wait for the
device on every iteration, so here each round runs all its iterations and an
iteration whose round has converged changes nothing: ``T``, ``lam`` and the
step norm are frozen where ``active = dn > 1e-6`` is false.  The result is
that of the early exit.

On a CUDA device ``optimize_pose`` is one launch of a hand-written kernel
(``kernels/csrc/pose_lm.cu``, through ``kernels/cuda_pose.py``), which
computes what :func:`_optimize_pose_body` computes and ends a round for real
where the body freezes it; CPU tensors run the body.  ``local_ba`` runs both
its phases as one CUDA graph per input signature (:func:`ba_graph_key`;
``utils/cuda_graph.py``): the first call of a signature captures the eager
body, :func:`_local_ba_body`, into static buffers; every call copies its
inputs into them, replays the graph on the current stream and returns
copies of the outputs.  The replay issues the kernels the body issues, with
the same arguments, in the same order.  CPU tensors run the body eagerly.
``cuda_pose.counts()`` and :func:`ba_graph_counts` say which way the calls
went.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import geometry as geo
from ..kernels import cuda_pose
from ..utils import cuda_graph
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

    Returns (T_opt (4, 4), inlier mask (N,), n_inliers () int32), new
    tensors.  CUDA tensors launch ``kernels/csrc/pose_lm.cu`` on the inputs'
    device, whichever device is current (``cuda_pose.pose_lm``, which checks
    the inputs and raises on what the kernel does not take); CPU tensors run
    :func:`_optimize_pose_body`."""
    return cuda_pose.pose_lm(T_init, points, uv, inv_sigma2, valid, fx, fy, cx, cy, chi2_th, rounds,
                             iters_per_round, ur, bf, chi2_th_stereo)


def _optimize_pose_body(
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
    """The plain LM of :func:`optimize_pose`, which CPU tensors run: no host
    read, fixed shapes and trip counts."""
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
    reference's one dummy plane and one dummy cuboid, never active; the
    semantic problem carries the whole map's planes and cuboids, the
    inactive ones held by the free mask.  The layout (and ``schur_solve``'s
    reduced system, 6 per pose, 9 per cuboid, 3 per plane) is the
    reference's."""

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


class StereoFactors(NamedTuple):
    """Observations with a right-view coordinate (EdgeStereoSE3ProjectXYZ;
    RGB-D makes it virtual, u - bf / z)."""

    kf: torch.Tensor  # (F,) int window slot
    pt: torch.Tensor  # (F,) int local point
    uvr: torch.Tensor  # (F, 3) u, v, u_right
    inv_sigma2: torch.Tensor  # (F,)
    valid: torch.Tensor  # (F,) bool


class PlaneFactors(NamedTuple):
    """Camera-plane observations; ``kind`` 0 direct (3-dim), 1 vertical and
    2 parallel (2-dim): EdgePlane / EdgeVerticalPlane / EdgeParallelPlane."""

    kf: torch.Tensor  # (F,) window slot
    plane: torch.Tensor  # (F,) map plane
    meas: torch.Tensor  # (F, 4) camera-frame plane
    kind: torch.Tensor  # (F,) int
    valid: torch.Tensor  # (F,) bool


class CuboidBBoxFactors(NamedTuple):
    kf: torch.Tensor
    cub: torch.Tensor
    bbox: torch.Tensor  # (F, 4) [cx, cy, w, h]
    weight: torch.Tensor  # (F,) measurement quality
    valid: torch.Tensor


class CuboidCornerFactors(NamedTuple):
    kf: torch.Tensor
    cub: torch.Tensor
    corners: torch.Tensor  # (F, 16)
    weight: torch.Tensor
    valid: torch.Tensor


class CuboidSE3Factors(NamedTuple):
    kf: torch.Tensor
    cub: torch.Tensor
    meas_pose: torch.Tensor  # (F, 4, 4) cuboid in the camera frame
    meas_scale: torch.Tensor  # (F, 3)
    weight: torch.Tensor
    valid: torch.Tensor


class PointCuboidFactors(NamedTuple):
    """One factor per cuboid: the mean hinge of its owned (fixed) points
    (EdgePointCuboidOnlyObject, Optimizer.cc:2556-2655)."""

    cub: torch.Tensor  # (F,)
    pts: torch.Tensor  # (F, M) local point indices
    pts_mask: torch.Tensor  # (F, M) float
    weight: torch.Tensor
    valid: torch.Tensor


class CuboidPlaneFactors(NamedTuple):
    cub: torch.Tensor
    plane: torch.Tensor
    face: torch.Tensor  # (F,) matched face 0..5
    valid: torch.Tensor


# the bundle fields of BAData beside ``mono``, with their factor types
BUNDLES = {
    "plane_obs": PlaneFactors, "cub_bbox": CuboidBBoxFactors, "cub_corner": CuboidCornerFactors,
    "cub_se3": CuboidSE3Factors, "pt_cub": PointCuboidFactors, "cub_plane": CuboidPlaneFactors,
}
_INDEX_FIELDS = ("kf", "pt", "plane", "cub", "pts", "face", "kind")


class BAData(NamedTuple):
    """Everything but the variables: factors, gauges and camera.  A bundle
    that is None (``stereo`` among them) is absent: the reference passes a
    one-lane invalid bundle there, which adds nothing to the normal
    equations or the chi2."""

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
    stereo: Optional[StereoFactors] = None
    plane_obs: Optional[PlaneFactors] = None
    cub_bbox: Optional[CuboidBBoxFactors] = None
    cub_corner: Optional[CuboidCornerFactors] = None
    cub_se3: Optional[CuboidSE3Factors] = None
    pt_cub: Optional[PointCuboidFactors] = None
    cub_plane: Optional[CuboidPlaneFactors] = None
    # 1.0 freezes the cuboid scale dims in the solve (VertexCuboidFixScale)
    cuboid_fix_scale: float = 0.0


def make_ba_data(poses_k: int, points_p: int, planes_q: int, cuboids_c: int, cam, *, mono, stereo=None,
                 pose_fixed=None, point_active=None, plane_active=None, cuboid_active=None,
                 cuboid_fix_scale: float = 0.0, **bundles) -> BAData:
    """BAData with absent gauges defaulted as the reference does (lm.py:228,
    :249); ``bundles``: any of :data:`BUNDLES` by field name."""
    dev = mono.uv.device

    def full(n, v):
        return torch.full((n,), v, dtype=torch.bool, device=dev)

    return BAData(
        pose_fixed=pose_fixed if pose_fixed is not None else full(poses_k, False),
        point_active=point_active if point_active is not None else full(points_p, True),
        plane_active=plane_active if plane_active is not None else full(planes_q, False),
        cuboid_active=cuboid_active if cuboid_active is not None else full(cuboids_c, False),
        mono=mono, stereo=stereo, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=float(cam.bf),
        cuboid_fix_scale=cuboid_fix_scale, **bundles,
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
    for k in ("mono", "stereo") + tuple(BUNDLES):
        b = getattr(data, k)
        out[k] = None if b is None else {f: _np(getattr(b, f)) for f in b._fields}
    return out


def ba_data_from_numpy(fields: dict, device) -> BAData:
    """From ``{field: value}`` keyed by the reference's ``BAData`` fields
    (``mono``, ``stereo`` and each bundle a dict of its factor fields; a
    bundle missing or None is absent; extra keys ignored)."""

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    def bundle(cls, f):
        b = cls(**{k: t(f[k]) for k in cls._fields})
        return b._replace(**{k: getattr(b, k).long() for k in _INDEX_FIELDS if k in cls._fields})

    bundles = {k: bundle(cls, fields[k]) for k, cls in {"stereo": StereoFactors, **BUNDLES}.items()
               if fields.get(k) is not None}
    return BAData(
        pose_fixed=t(fields["pose_fixed"]), point_active=t(fields["point_active"]),
        plane_active=t(fields["plane_active"]), cuboid_active=t(fields["cuboid_active"]),
        mono=bundle(MonoFactors, fields["mono"]),
        **{k: float(np.asarray(fields[k])) for k in ("fx", "fy", "cx", "cy", "bf")},
        cuboid_fix_scale=float(np.asarray(fields.get("cuboid_fix_scale", 0.0))), **bundles,
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


class _ReprojLanes(NamedTuple):
    """One reprojection bundle, linearized: residuals and Jacobians with the
    invalid lanes zeroed, the per-lane weight inv_sigma2 x Huber weight (0
    on an invalid lane) and the bundle's robust chi2."""

    kf: torch.Tensor  # (F,)
    pt: torch.Tensor  # (F,)
    r: torch.Tensor  # (F, R)
    Jp: torch.Tensor  # (F, R, 6)
    Jx: torch.Tensor  # (F, R, 3)
    wgt: torch.Tensor  # (F,)
    chi2: torch.Tensor  # ()


def _weighted(kf, pt, r, Jp, Jx, inv_sigma2, valid, delta2) -> _ReprojLanes:
    r, Jp, Jx = _mask_lin(valid, r, Jp, Jx)
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    wf = fac.huber_weight(chi2, delta2) * valid
    return _ReprojLanes(kf, pt, r, Jp, Jx, inv_sigma2 * wf, _rho_sum(chi2, delta2, valid))


def _reproj_lanes(state: BAState, data: BAData, w: BAWeights):
    """[(name, lanes)] of the mono bundle and, when present, the stereo one
    (lm.py:446-515 of the reference)."""
    m = data.mono
    T, X = state.poses[m.kf], state.points[m.pt]
    r = fac.mono_residual(T, X, m.uv, data.fx, data.fy, data.cx, data.cy)
    out = [("mono", _weighted(m.kf, m.pt, r, *fac.mono_jacobians(T, X, data.fx, data.fy), m.inv_sigma2, m.valid,
                              w.chi2_mono))]
    s = data.stereo
    if s is not None:
        T, X = state.poses[s.kf], state.points[s.pt]
        r = fac.stereo_residual(T, X, s.uvr, data.fx, data.fy, data.cx, data.cy, data.bf)
        Jp, Jx = fac.stereo_jacobians(T, X, data.fx, data.fy, data.bf)
        out.append(("stereo", _weighted(s.kf, s.pt, r, Jp, Jx, s.inv_sigma2, s.valid, w.chi2_stereo)))
    return out


def _assemble_reproj_generic(lanes, K, P, D):
    """Any lane layout: each lane's 6x6, 6, 3x3, 3 and 6x3 blocks summed
    through ``_sum_at``, in lane order on either device (``index_add`` on
    the CPU, as before; on the card sorted runs in place of float atomics).
    Returns (pose blocks (K, 6, 6), pose b (K, 6), H_ll, b_l, H_cl (D, P, 3))."""
    dev = lanes[0].r.device
    kf = torch.cat([x.kf for x in lanes])
    pt = torch.cat([x.pt for x in lanes])
    blocks = []
    for x in lanes:
        wgt = x.wgt[:, None, None]
        JpW, JxW = x.Jp * wgt, x.Jx * wgt
        blocks.append((torch.einsum("fri,frj->fij", JpW, x.Jp), -torch.einsum("fri,fr->fi", JpW, x.r),
                       torch.einsum("fri,frj->fij", JxW, x.Jx), -torch.einsum("fri,fr->fi", JxW, x.r),
                       torch.einsum("fri,frj->fij", JpW, x.Jx)))
    Hpp, bp, Hxx, bx, Hpx = (torch.cat(b) for b in zip(*blocks))
    pose_blocks = _sum_at(torch.zeros((K, 6, 6), device=dev), kf, Hpp)
    pose_b = _sum_at(torch.zeros((K, 6), device=dev), kf, bp)
    H_ll = _sum_at(torch.zeros((P, 3, 3), device=dev), pt, Hxx)
    b_l = _sum_at(torch.zeros((P, 3), device=dev), pt, bx)
    cross = _sum_at(torch.zeros((K * P, 6, 3), device=dev), kf * P + pt, Hpx)
    H_cl = cross.reshape(K, P, 6, 3).permute(0, 2, 1, 3).reshape(6 * K, P, 3)
    H_cl = torch.cat([H_cl, torch.zeros((D - 6 * K, P, 3), device=dev)])
    return pose_blocks, pose_b, H_ll, b_l, H_cl


def _pose_sums(lanes, n: int, K, batched: bool):
    """(pose blocks (K, 6, 6), pose b (K, 6)) of kf-major lanes, each
    keyframe's ``n`` lanes summed.  ``batched`` (on the card): one batched
    matmul per bundle over each keyframe's lanes, a fixed order with no
    scatter.  Otherwise (on the CPU) each lane's blocks summed in lane order
    with ``index_add``, serial there, as the generic path sums them, so that
    on the CPU the two paths give the same normal equations bit for bit."""
    dev = lanes[0].r.device
    pose_blocks = torch.zeros((K, 6, 6), device=dev)
    pose_b = torch.zeros((K, 6), device=dev)
    if not batched:
        kf = torch.cat([x.kf for x in lanes])
        JpW = [x.Jp * x.wgt[:, None, None] for x in lanes]
        Hpp = torch.cat([torch.einsum("fri,frj->fij", a, x.Jp) for a, x in zip(JpW, lanes)])
        bp = torch.cat([-torch.einsum("fri,fr->fi", a, x.r) for a, x in zip(JpW, lanes)])
        return pose_blocks.index_add(0, kf, Hpp), pose_b.index_add(0, kf, bp)
    for x in lanes:
        R = x.r.shape[1]
        JpW = (x.Jp * x.wgt[:, None, None]).reshape(K, n, R, 6)
        pose_blocks = pose_blocks + torch.einsum("wnri,wnrj->wij", JpW, x.Jp.reshape(K, n, R, 6))
        pose_b = pose_b - torch.einsum("wnri,wnr->wi", JpW, x.r.reshape(K, n, R))
    return pose_blocks, pose_b


def _assemble_reproj_blocked(lanes, n: int, K, P, D):
    """Kf-major lanes (``kf = repeat(arange(K), n)`` in every bundle), the
    port of the reference's ``_assemble_reproj_blocked`` (lm.py:363-413),
    summed in a fixed order without atomics.

    - The pose blocks and b_c reduce over each keyframe's ``n`` lanes
      (:func:`_pose_sums`): their rows are unique.
    - H_cl: each lane writes its 6x3 cross block straight into its
      keyframe's six rows at its point's column, and H_ll and b_l take each
      lane's 3x3 and 3 at its point, both through :func:`_sum_at`, which
      sums each destination's lanes one after another in lane order: in
      H_ll keyframe 0 comes first, the mono bundle before the stereo one, as
      in the reference's scan.  A keyframe that binds one point from two
      keypoints puts two lanes on one H_cl entry; they are summed, as the
      reference's one-hot sums them.
    - A lane with no weight (invalid, or a zero Huber weight) writes to a
      slot of its own past the end, as the reference points it at the
      one-hot's dropped column P: so no destination gathers the window's
      thousands of empty lanes into one serial sum.

    No (K, P, .) buffer is made beside H_cl, so nothing needs chunking over
    keyframes.  Besides H_cl (D x P x 3 floats: 10.0 MB for the local
    window, D = 204 and P = 4096; 1.21 GB for the global BA's largest
    bucket, 512 keyframes, D = 3084, P = 32768) the buffers are per lane: the
    6x3 cross blocks and H_cl's spill slots, 72 bytes a lane each, and the
    (P + F, 12) H_ll / b_l accumulator, 48 bytes a lane: 6.5 MB for the
    32 x 1024 mono lanes of the local window, 102 MB for 512 x 1024, and
    the sorts' int64 keys (seven a lane).  The generic path holds two more
    H_cl-sized buffers (its (K P, 6, 3) sum and the transposed copy)."""
    dev = lanes[0].r.device
    pose_blocks, pose_b = _pose_sums(lanes, n, K, batched=dev.type == "cuda")
    point_payload, cross = [], []
    for x in lanes:
        wgt = x.wgt[:, None, None]
        JpW, JxW = x.Jp * wgt, x.Jx * wgt
        point_payload.append(torch.cat([torch.einsum("fri,frj->fij", JxW, x.Jx).flatten(1),
                                        -torch.einsum("fri,fr->fi", JxW, x.r)], dim=1))
        cross.append(torch.einsum("fri,frj->fij", JpW, x.Jx))
    kf = torch.cat([x.kf for x in lanes])
    pt = torch.cat([x.pt for x in lanes])
    live = torch.cat([x.wgt > 0 for x in lanes])
    F = kf.shape[0]
    lane = torch.arange(F, device=dev)
    acc = _sum_at(torch.zeros((P + F, 12), device=dev), torch.where(live, pt, P + lane), torch.cat(point_payload))
    H_ll = acc[:P, :9].reshape(P, 3, 3)
    b_l = acc[:P, 9:]
    six = torch.arange(6, device=dev)
    dest = torch.where(live[:, None], (6 * kf[:, None] + six) * P + pt[:, None], D * P + 6 * lane[:, None] + six)
    H_cl = _sum_at(torch.zeros((D * P + 6 * F, 3), device=dev), dest.reshape(-1), torch.cat(cross).reshape(-1, 3))
    H_cl = H_cl[: D * P].view(D, P, 3)
    return pose_blocks, pose_b, H_ll, b_l, H_cl


def build_system(state: BAState, data: BAData, w: BAWeights, reproj_n: int = 0):
    """Normal equations of every present bundle and their robust total chi2:
    (H_cc (D, D), H_cl (D, P, 3), H_ll (P, 3, 3), b_c (D,), b_l (P, 3), chi2).

    ``reproj_n > 0`` claims, as in the reference, that the mono lanes, and
    apart from them the stereo lanes, are kf-major: ``reproj_n`` lanes per
    keyframe in ``repeat(arange(K), reproj_n)`` order, as ``pack_local_ba``
    and ``pack_global_ba`` lay them out.  It selects
    :func:`_assemble_reproj_blocked`, whose sums have a fixed order on the
    card.  A bundle with another lane count raises ``ValueError`` (a
    coincidentally divisible layout that is not kf-major would corrupt the
    normal equations); a one-lane bundle (the reference's ``.empty()``
    placeholder) takes the generic path.  ``reproj_n=0`` takes the generic
    path, :func:`_assemble_reproj_generic`, for every lane layout (the
    factor-sharded solve of ``dist/ba.py``)."""
    K, C, Q, D = _layout(state)
    P = state.points.shape[0]
    dev = state.points.device
    lanes = _reproj_lanes(state, data, w)
    chi2_total = sum(x.chi2 for _, x in lanes)
    blocked, generic = [], []
    for name, x in lanes:
        F = x.kf.shape[0]
        if reproj_n and F > 1:  # 1 lane == the .empty() placeholder
            if F != reproj_n * K:
                raise ValueError(f"reproj_n={reproj_n} claims kf-major {name} lanes but {F} != {reproj_n}*{K}")
            blocked.append(x)
        else:
            generic.append(x)
    parts = ([_assemble_reproj_blocked(blocked, reproj_n, K, P, D)] if blocked else []) + (
        [_assemble_reproj_generic(generic, K, P, D)] if generic else [])
    pose_blocks, pose_b, H_ll, b_l, H_cl = (sum(p) if len(p) > 1 else p[0] for p in zip(*parts))
    rows = 6 * torch.arange(K, device=dev)[:, None] + torch.arange(6, device=dev)[None, :]
    H_cc = torch.zeros((D, D), device=dev).index_put((rows[:, :, None], rows[:, None, :]), pose_blocks)
    b_c = torch.zeros(D, device=dev).index_put((rows.reshape(-1),), pose_b.reshape(-1))
    if any(getattr(data, k) is not None for k in BUNDLES):
        H_cc, b_c, chi2_sem = _semantic_system(state, data, w, H_cc, b_c)
        chi2_total = chi2_total + chi2_sem
    return H_cc, H_cl, H_ll, b_c, b_l, chi2_total


# ---------------------------------------------------------------------------
# Plane and cuboid factors: residuals, information and their blocks
# ---------------------------------------------------------------------------


def _kmat(data: BAData, dev):
    """The camera matrix on ``dev``, filled without a host copy."""
    K = torch.zeros((3, 3), device=dev)
    for (i, j), v in (((0, 0), data.fx), ((1, 1), data.fy), ((0, 2), data.cx), ((1, 2), data.cy), ((2, 2), 1.0)):
        K[i, j].fill_(v)
    return K


def _full3(n, a, b, c, dev):
    """(n, 3) rows [a, b, c] of Python numbers."""
    return torch.stack([torch.full((n,), float(v), device=dev) for v in (a, b, c)], dim=-1)


def _plane_chi2(r3, rv, rp, kind, w: BAWeights):
    c3 = (r3[:, 0] ** 2 + r3[:, 1] ** 2) * w.plane_angle_info + r3[:, 2] ** 2 * w.plane_dist_info
    cv = (rv[:, 0] ** 2 + rv[:, 1] ** 2) * w.plane_vp_info
    cp = (rp[:, 0] ** 2 + rp[:, 1] ** 2) * w.plane_vp_info
    return torch.where(kind == 0, c3, torch.where(kind == 1, cv, cp)), _plane_delta2(kind, w)


def _plane_delta2(kind, w: BAWeights):
    return torch.where(kind == 0, w.plane_chi, w.plane_vp_chi)


def _cub_plane_chi2(r, w: BAWeights):
    return (r[:, 0] ** 2 + r[:, 1] ** 2) * w.cub_plane_angle_info + r[:, 2] ** 2 * w.cub_plane_dist_info


def _semantic_residuals(state: BAState, data: BAData, w: BAWeights):
    """{bundle: (residuals, chi2, Huber delta^2)} of the present plane and
    cuboid bundles, for the accept test and the outlier gate."""
    out = {}
    Kmat = _kmat(data, state.poses.device)
    po = data.plane_obs
    if po is not None:
        T, pw = state.poses[po.kf], state.planes[po.plane]
        r3 = fac.plane_residual(T, pw, po.meas)
        rv = fac.plane_ver_residual(T, pw, po.meas)
        rp = fac.plane_par_residual(T, pw, po.meas)
        out["plane_obs"] = (r3, *_plane_chi2(r3, rv, rp, po.kind, w))
    for key, res, meas, delta2 in (("cub_bbox", fac.cuboid_bbox_residual, "bbox", w.bbox_chi),
                                   ("cub_corner", fac.cuboid_corner_residual, "corners", w.corner_chi)):
        b = getattr(data, key)
        if b is not None:
            r = res(state.poses[b.kf], state.cuboid_pose[b.cub], state.cuboid_scale[b.cub], getattr(b, meas), Kmat)
            out[key] = (r, torch.sum(r * r, dim=-1) * b.weight**2, delta2)
    c3 = data.cub_se3
    if c3 is not None:
        r = fac.cuboid_se3_residual(state.poses[c3.kf], state.cuboid_pose[c3.cub], state.cuboid_scale[c3.cub],
                                    c3.meas_pose, c3.meas_scale)
        out["cub_se3"] = (r, torch.sum(r * r, dim=-1) * (c3.weight**2 * w.se3_weight**2), w.se3_chi)
    pc = data.pt_cub
    if pc is not None:
        r = fac.point_cuboid_residual(state.cuboid_pose[pc.cub], state.cuboid_scale[pc.cub], state.points[pc.pts],
                                      pc.pts_mask, w.max_outside_margin_ratio, w.pt_obj_prior_weight)
        out["pt_cub"] = (r, torch.sum(r * r, dim=-1) * (pc.weight**2 * w.pt_obj_weight**2), w.pt_obj_chi)
    cq = data.cub_plane
    if cq is not None:
        r = fac.cuboid_plane_residual(state.cuboid_pose[cq.cub], state.cuboid_scale[cq.cub],
                                      state.planes[cq.plane], cq.face)
        out["cub_plane"] = (r, _cub_plane_chi2(r, w), w.cub_plane_chi)
    return out


def _mask_lin(valid, r, *jacs):
    """Zero the residuals and Jacobians of invalid factors before weighting:
    padded lanes can be NaN, and NaN * 0 would poison the sums."""
    return (torch.where(valid[:, None], r, 0.0),
            *(torch.where(valid[:, None, None], J, 0.0) for J in jacs))


def _sum_at(target, idx, vals):
    """``target`` with each row of ``vals`` added at its row ``idx``, the
    rows that meet at one destination summed one after another in the
    order of ``idx``, on either device.  On the card ``index_put(accumulate=
    True)`` does that (it sorts the destinations with a stable radix sort,
    then sums each run in order), where ``index_add`` adds with float
    atomics; on the CPU ``index_add`` does it (serially), where
    ``index_put(accumulate=True)`` adds atomically across threads."""
    if target.is_cuda:
        return target.index_put((idx,), vals, accumulate=True)
    return target.index_add(0, idx, vals)


def _add_cc(H, rows0, cols0, blocks):
    di, dj = blocks.shape[-2], blocks.shape[-1]
    dev = H.device
    rows = rows0[:, None, None] + torch.arange(di, device=dev)[None, :, None]
    cols = cols0[:, None, None] + torch.arange(dj, device=dev)[None, None, :]
    flat = (rows * H.shape[1] + cols).reshape(-1)
    return _sum_at(H.reshape(-1), flat, blocks.reshape(-1)).view(H.shape)


def _add_b(b, rows0, vecs):
    rows = rows0[:, None] + torch.arange(vecs.shape[-1], device=b.device)[None, :]
    return _sum_at(b, rows.reshape(-1), vecs.reshape(-1))


def _binary_cc(H_cc, b_c, r, J_i, J_j, wf, row_i, row_j, info):
    """A binary factor whose two variables both live in the reduced block
    (pose-cuboid, pose-plane, cuboid-plane)."""
    iw = (info * wf[:, None])[:, :, None]
    JiW, JjW = J_i * iw, J_j * iw
    Wr = info * r * wf[:, None]
    H_cc = _add_cc(H_cc, row_i, row_i, torch.einsum("fdi,fdj->fij", JiW, J_i))
    H_cc = _add_cc(H_cc, row_j, row_j, torch.einsum("fdi,fdj->fij", JjW, J_j))
    Hij = torch.einsum("fdi,fdj->fij", JiW, J_j)
    H_cc = _add_cc(H_cc, row_i, row_j, Hij)
    H_cc = _add_cc(H_cc, row_j, row_i, Hij.transpose(-1, -2))
    b_c = _add_b(b_c, row_i, -torch.einsum("fdi,fd->fi", J_i, Wr))
    b_c = _add_b(b_c, row_j, -torch.einsum("fdi,fd->fi", J_j, Wr))
    return H_cc, b_c


def _semantic_system(state: BAState, data: BAData, w: BAWeights, H_cc, b_c):
    """Add the plane and cuboid bundles to (H_cc, b_c), summed in a fixed
    order (:func:`_sum_at`); returns (H_cc, b_c, their robust chi2).
    Jacobians come from :func:`factors.linearize` (forward mode), as the
    reference's come from ``jacfwd``."""
    K, C, Q, D = _layout(state)
    dev = H_cc.device
    chi2_total = torch.zeros((), device=dev)
    Kmat = _kmat(data, dev)
    pose_r, cub_r, plane_r = (fac.retract_pose, 6), (fac.retract_cuboid, 9), (fac.retract_plane, 3)

    def pose_row(kf):
        return 6 * kf

    def cub_row(c):
        return 6 * K + 9 * c

    def plane_row(q):
        return 6 * K + 9 * C + 3 * q

    def robust(r, info, delta2, valid):
        chi2 = torch.sum(r * r * info, dim=-1)
        return fac.huber_weight(chi2, delta2) * valid, _rho_sum(chi2, delta2, valid)

    po = data.plane_obs
    if po is not None:
        # the three relations share one bundle: each is linearized on every
        # lane and the lane's kind picks; the 2-dim ones are embedded in 3
        ests = (state.poses[po.kf], state.planes[po.plane])
        r3, (j3p, j3q) = fac.linearize(fac.plane_residual, (pose_r, plane_r), ests, po.meas)
        rv, (jvp, jvq) = fac.linearize(fac.plane_ver_residual, (pose_r, plane_r), ests, po.meas)
        rp, (jpp, jpq) = fac.linearize(fac.plane_par_residual, (pose_r, plane_r), ests, po.meas)
        k0, k1 = po.kind == 0, po.kind == 1
        pad = torch.zeros_like(r3[:, :1])
        r2 = torch.where(k1[:, None], rv, rp)
        j2p = torch.where(k1[:, None, None], jvp, jpp)
        j2q = torch.where(k1[:, None, None], jvq, jpq)
        r = torch.where(k0[:, None], r3, torch.cat([r2, pad], dim=-1))
        Jp = torch.where(k0[:, None, None], j3p, torch.cat([j2p, torch.zeros_like(j3p[:, :1])], dim=1))
        Jq = torch.where(k0[:, None, None], j3q, torch.cat([j2q, torch.zeros_like(j3q[:, :1])], dim=1))
        r, Jp, Jq = _mask_lin(po.valid, r, Jp, Jq)
        n = r.shape[0]
        info = torch.where(k0[:, None], _full3(n, w.plane_angle_info, w.plane_angle_info, w.plane_dist_info, dev),
                           _full3(n, w.plane_vp_info, w.plane_vp_info, 0.0, dev))
        wf, rho = robust(r, info, _plane_delta2(po.kind, w), po.valid)
        chi2_total = chi2_total + rho
        H_cc, b_c = _binary_cc(H_cc, b_c, r, Jp, Jq, wf, pose_row(po.kf), plane_row(po.plane), info)

    def pose_cuboid(bundle, res, meas, delta2, info_w):
        nonlocal H_cc, b_c, chi2_total
        ests = (state.poses[bundle.kf], (state.cuboid_pose[bundle.cub], state.cuboid_scale[bundle.cub]))
        r, (Jp, Jc) = fac.linearize(res, (pose_r, cub_r), ests, *meas)
        r, Jp, Jc = _mask_lin(bundle.valid, r, Jp, Jc)
        info = info_w[:, None].expand(r.shape)
        wf, rho = robust(r, info, delta2, bundle.valid)
        chi2_total = chi2_total + rho
        H_cc, b_c = _binary_cc(H_cc, b_c, r, Jp, Jc, wf, pose_row(bundle.kf), cub_row(bundle.cub), info)

    cb = data.cub_bbox
    if cb is not None:
        pose_cuboid(cb, lambda T, cp, cs, bb: fac.cuboid_bbox_residual(T, cp, cs, bb, Kmat), (cb.bbox,),
                    w.bbox_chi, cb.weight**2)
    cc = data.cub_corner
    if cc is not None:
        pose_cuboid(cc, lambda T, cp, cs, co: fac.cuboid_corner_residual(T, cp, cs, co, Kmat), (cc.corners,),
                    w.corner_chi, cc.weight**2)
    c3 = data.cub_se3
    if c3 is not None:
        pose_cuboid(c3, fac.cuboid_se3_residual, (c3.meas_pose, c3.meas_scale), w.se3_chi,
                    c3.weight**2 * w.se3_weight**2)

    pc = data.pt_cub
    if pc is not None:  # unary on the cuboid; its points are fixed
        def res_pc(cp, cs, pts, pm):
            return fac.point_cuboid_residual(cp, cs, pts, pm, w.max_outside_margin_ratio, w.pt_obj_prior_weight)

        r, (Jc,) = fac.linearize(res_pc, (cub_r,), ((state.cuboid_pose[pc.cub], state.cuboid_scale[pc.cub]),),
                                 state.points[pc.pts], pc.pts_mask)
        r, Jc = _mask_lin(pc.valid, r, Jc)
        info = (pc.weight**2 * w.pt_obj_weight**2)[:, None].expand(r.shape)
        wf, rho = robust(r, info, w.pt_obj_chi, pc.valid)
        chi2_total = chi2_total + rho
        JcW = Jc * (info * wf[:, None])[:, :, None]
        H_cc = _add_cc(H_cc, cub_row(pc.cub), cub_row(pc.cub), torch.einsum("fdi,fdj->fij", JcW, Jc))
        b_c = _add_b(b_c, cub_row(pc.cub), -torch.einsum("fdi,fd->fi", JcW, r))

    cq = data.cub_plane
    if cq is not None:
        ests = ((state.cuboid_pose[cq.cub], state.cuboid_scale[cq.cub]), state.planes[cq.plane])
        r, (Jc, Jq) = fac.linearize(fac.cuboid_plane_residual, (cub_r, plane_r), ests, cq.face)
        r, Jc, Jq = _mask_lin(cq.valid, r, Jc, Jq)
        info = _full3(r.shape[0], w.cub_plane_angle_info, w.cub_plane_angle_info, w.cub_plane_dist_info, dev)
        wf, rho = robust(r, info, w.cub_plane_chi, cq.valid)
        chi2_total = chi2_total + rho
        H_cc, b_c = _binary_cc(H_cc, b_c, r, Jc, Jq, wf, cub_row(cq.cub), plane_row(cq.plane), info)
    return H_cc, b_c, chi2_total


def total_chi2(state: BAState, data: BAData, w: BAWeights):
    """Robust total chi2 of every present bundle (LM accept/reject;
    lm.py:751-765 for the mono and stereo ones)."""
    m = data.mono
    r = fac.mono_residual(state.poses[m.kf], state.points[m.pt], m.uv, data.fx, data.fy, data.cx, data.cy)
    chi2 = _rho_sum(torch.sum(r * r, dim=-1) * m.inv_sigma2, w.chi2_mono, m.valid)
    s = data.stereo
    if s is not None:
        r = fac.stereo_residual(state.poses[s.kf], state.points[s.pt], s.uvr, data.fx, data.fy, data.cx, data.cy,
                                data.bf)
        chi2 = chi2 + _rho_sum(torch.sum(r * r, dim=-1) * s.inv_sigma2, w.chi2_stereo, s.valid)
    for key, (_, c, delta2) in _semantic_residuals(state, data, w).items():
        chi2 = chi2 + _rho_sum(c, delta2, getattr(data, key).valid)
    return chi2


def retract_state(state: BAState, data: BAData, delta_c, delta_l, fixrollpitch=True,
                  fixheight=True) -> BAState:
    """Apply a step: poses by left SE3 retraction (fixed ones held), active
    points additively, cuboids and planes by their retractions with the
    inactive ones' steps zeroed.  As in the reference every plane is
    retracted, and a zero step moves a plane by rounding only."""
    K, C, Q, D = _layout(state)
    free = (~data.pose_fixed)[:, None].to(delta_c.dtype)
    poses = fac.retract_pose(state.poses, delta_c[: 6 * K].reshape(K, 6) * free)
    dc = delta_c[6 * K: 6 * K + 9 * C].reshape(C, 9) * data.cuboid_active[:, None].to(delta_c.dtype)
    cub_pose, cub_scale = fac.retract_cuboid(state.cuboid_pose, state.cuboid_scale, dc, fixrollpitch, fixheight)
    dq = delta_c[6 * K + 9 * C:].reshape(Q, 3) * data.plane_active[:, None].to(delta_c.dtype)
    points = fac.retract_point(state.points, delta_l * data.point_active[:, None])
    return BAState(poses=poses, points=points, planes=fac.retract_plane(state.planes, dq),
                   cuboid_pose=cub_pose, cuboid_scale=cub_scale)


def _free_mask(state: BAState, data: BAData):
    K, C, Q, D = _layout(state)
    pose_free = (~data.pose_fixed).to(torch.float32).repeat_interleave(6)
    cub_free = data.cuboid_active.to(torch.float32).repeat_interleave(9)
    dim9 = torch.arange(9, device=cub_free.device).repeat(C)
    cub_free = cub_free * torch.where((dim9 >= 6) & (data.cuboid_fix_scale > 0), 0.0, 1.0)
    plane_free = data.plane_active.to(torch.float32).repeat_interleave(3)
    return torch.cat([pose_free, cub_free, plane_free])


def lm_iterations(state: BAState, data: BAData, w: BAWeights, n_iters: int, lam0: float = 1e-4,
                  reproj_n: int = 0, reduce=None):
    """``n_iters`` LM iterations with accept/reject and adaptive damping.
    Returns (state, chi2 of each iteration's trial step (n_iters,)).

    ``reproj_n``: the lanes per keyframe of kf-major mono and stereo
    bundles, which selects the fixed-order assembly (:func:`build_system`).

    ``reduce``: given a list of tensors, returns their sums over the ranks
    that hold the other factors (``dist/ba.py``, where ``data`` is one
    rank's shard of the factor bundles and every gauge field is whole).  It
    is called once per iteration on the normal equations and the current
    chi2, and once on the trial's chi2.

    A trial with a non-finite variable (pose, point, plane or cuboid) is
    rejected.  The reference accepts one whose chi2 fell, and its chi2 masks
    non-finite factors out: a step that overflows some poses drops their
    factors and "lowers" the chi2, and the outlier gate then unlinks every
    observation of those poses.  On the card, which sums in another order
    than the CPU, one such step emptied most of the golden replay's map and
    tracking was lost for good.  Where every trial is finite, as in all the
    parity tests, the two agree."""
    free_c = _free_mask(state, data)
    point_active = data.point_active.to(torch.float32)
    lam = torch.full((), lam0, device=free_c.device)
    chi2s = []
    reduce = reduce or (lambda xs: xs)
    for _ in range(n_iters):
        H_cc, H_cl, H_ll, b_c, b_l, chi2_cur = reduce(list(build_system(state, data, w, reproj_n)))
        delta_c, delta_l = schur_solve(H_cc, H_cl, H_ll, b_c, b_l, lam, free_c, point_active)
        trial = retract_state(state, data, delta_c, delta_l)
        chi2_new = reduce([total_chi2(trial, data, w)])[0]
        finite = torch.stack([torch.isfinite(x).all() for x in trial]).all()
        ok = (chi2_new < chi2_cur) & torch.isfinite(chi2_new) & finite
        state = BAState(*(torch.where(ok, b, a) for a, b in zip(state, trial)))
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-7), torch.clamp(lam * 8.0, max=1e4))
        chi2s.append(chi2_new)
    return state, torch.stack(chi2s)


def gate_observations(state: BAState, data: BAData, w: BAWeights) -> BAData:
    """Disable observations above their type's threshold, and mono and
    stereo ones that see their point behind the camera (Optimizer.cc:700-786,
    2727-2838; lm.py:891-947 of the reference).
    Plane factors are gated on chi2; the bbox, corner and cuboid-plane ones
    on the residual's norm, as the reference does; the cuboid SE3 and
    point-cuboid factors are not gated."""
    m = data.mono
    T, X = state.poses[m.kf], state.points[m.pt]
    r = fac.mono_residual(T, X, m.uv, data.fx, data.fy, data.cx, data.cy)
    chi2 = torch.sum(r * r, dim=-1) * m.inv_sigma2
    z = geo.se3_apply(T, X)[:, 2]
    out = {"mono": m._replace(valid=m.valid & (chi2 <= w.chi2_mono) & (z > 0))}
    s = data.stereo
    if s is not None:
        T, X = state.poses[s.kf], state.points[s.pt]
        r = fac.stereo_residual(T, X, s.uvr, data.fx, data.fy, data.cx, data.cy, data.bf)
        chi2 = torch.sum(r * r, dim=-1) * s.inv_sigma2
        z = geo.se3_apply(T, X)[:, 2]
        out["stereo"] = s._replace(valid=s.valid & (chi2 <= w.chi2_stereo) & (z > 0))
    for key, (r, c, delta2) in _semantic_residuals(state, data, w).items():
        b = getattr(data, key)
        if key == "plane_obs":
            out[key] = b._replace(valid=b.valid & (c <= delta2))
        elif key in ("cub_bbox", "cub_corner", "cub_plane"):
            out[key] = b._replace(valid=b.valid & (geo._vnorm(r) <= delta2))
    return data._replace(**out)


def local_ba(state: BAState, data: BAData, w: BAWeights, phase1_iters: int = 5, phase2_iters: int = 10,
             reproj_n: int = 0):
    """Two-phase local BA (LocalBundleAdjustment, Optimizer.cc:461-786):
    optimize, gate outliers, optimize again, gate again; ``reproj_n`` as in
    :func:`lm_iterations`.  Returns (state, data with the final gate,
    phase-2 chi2s), tensors of the caller's own: the fields the gate left
    alone are the caller's own inputs, never a graph's static buffer.

    CUDA tensors replay the signature's CUDA graph of both phases (captured
    at its first call; :func:`ba_graph_key`), on the inputs' device
    whichever device is current; CPU tensors, a stream that is itself
    capturing, constants that are not Python numbers, inputs on more than
    one device, and a signature whose capture failed run the eager body,
    :func:`_local_ba_body`.  Either way the result is the body's."""
    consts = _ba_consts(data, w, phase1_iters, phase2_iters, reproj_n)
    out = cuda_graph.run(_run_ba_body, _ba_leaves(state, data), consts, state.points.device, _BA_GRAPHS,
                         _BA_GRAPH_COUNTS, "local_ba", "ba_graph_capture")
    state_out, data_out = _ba_from_leaves(out[:-1], consts[:len(_BA_CAMERA)])
    return state_out, data_out, out[-1]


# per-process cache: ba_graph_key -> cuda_graph.Graph, or None once its capture failed
_BA_GRAPHS: dict = {}
_BA_GRAPH_COUNTS = cuda_graph.new_counts()
# BAData's Python numbers, and its optional bundles with their factor types
_BA_CAMERA = ("fx", "fy", "cx", "cy", "bf", "cuboid_fix_scale")
_BA_GAUGES = ("pose_fixed", "point_active", "plane_active", "cuboid_active")
_BA_SLOTS = (("stereo", StereoFactors), *BUNDLES.items())


def ba_graph_counts() -> dict:
    """``local_ba`` calls so far in this process, by path
    (``utils/cuda_graph.new_counts``)."""
    return dict(_BA_GRAPH_COUNTS)


def ba_graph_key(state: BAState, data: BAData, w: BAWeights, phase1_iters: int = 5, phase2_iters: int = 10,
                 reproj_n: int = 0):
    """What a captured graph of ``local_ba`` is specific to: the device, each
    tensor of ``state`` and ``data`` by shape, strides and dtype (``None``
    for each field of an absent bundle), the camera, ``cuboid_fix_scale``,
    every weight, both phases' iterations and ``reproj_n``.  None where one
    of those constants is not a Python number or an input lies on another
    device than ``state.points``."""
    return cuda_graph.signature_key(state.points.device, _ba_leaves(state, data),
                                    _ba_consts(data, w, phase1_iters, phase2_iters, reproj_n))


def _ba_consts(data: BAData, w: BAWeights, phase1_iters, phase2_iters, reproj_n) -> tuple:
    return (*(getattr(data, k) for k in _BA_CAMERA), *w, phase1_iters, phase2_iters, reproj_n)


def _ba_leaves(state: BAState, data: BAData) -> tuple:
    """The tensors of ``state`` and ``data`` in a fixed layout: an absent
    bundle gives one None per field."""
    out = [*state, *(getattr(data, k) for k in _BA_GAUGES), *data.mono]
    for k, cls in _BA_SLOTS:
        b = getattr(data, k)
        out.extend((None,) * len(cls._fields) if b is None else b)
    return tuple(out)


def _ba_from_leaves(leaves, camera):
    """(state, data) back from :func:`_ba_leaves`' layout and the camera's
    numbers."""
    it = iter(leaves)

    def take(cls):
        fields = [next(it) for _ in cls._fields]
        return None if fields[0] is None else cls(*fields)

    state = take(BAState)
    gauges = {k: next(it) for k in _BA_GAUGES}
    mono = take(MonoFactors)
    bundles = {k: take(cls) for k, cls in _BA_SLOTS}
    return state, BAData(**gauges, mono=mono, **dict(zip(_BA_CAMERA, camera)), **bundles)


def _run_ba_body(leaves, consts):
    n = len(_BA_CAMERA)
    camera, w, iters = consts[:n], BAWeights(*consts[n:-3]), consts[-3:]
    state, data, chi2s = _local_ba_body(*_ba_from_leaves(leaves, camera), w, *iters)
    return (*_ba_leaves(state, data), chi2s)


def _local_ba_body(state: BAState, data: BAData, w: BAWeights, phase1_iters: int = 5, phase2_iters: int = 10,
                   reproj_n: int = 0):
    """The eager two-phase local BA of :func:`local_ba`, the body its CUDA
    graphs capture: no host read, fixed shapes and trip counts."""
    state, _ = lm_iterations(state, data, w, phase1_iters, reproj_n=reproj_n)
    data = gate_observations(state, data, w)
    state, chi2s = lm_iterations(state, data, w, phase2_iters, reproj_n=reproj_n)
    data = gate_observations(state, data, w)
    return state, data, chi2s
