"""Factors of the heterogeneous SLAM graph: residuals, retractions and
Jacobians (port of ``tpuslam/graph/factors.py``).

The reference writes single-factor closures and vmaps them; here each
function takes a batch of factors in its leading dimensions.  The mono and
stereo factors have analytic Jacobians; the plane and cuboid factors are
differentiated in forward mode by :func:`linearize`, as the reference
differentiates all of them.

Update conventions (shared with lm.py):
  pose:   T' = exp(delta) @ T, a left perturbation, tangent [omega, upsilon]
  point:  X' = X + delta
  plane:  azimuth / elevation / distance oplus (G2O_Plane3D.h:74-87)
  cuboid: right-multiplicative yaw-only twist + additive scale
          (g2o_cuboid.cc:39-67)
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..core import geometry as geo


def retract_pose(T, delta6):
    return geo.se3_exp(delta6) @ T


def retract_point(X, delta3):
    return X + delta3


def retract_plane(c, delta3):
    """Azimuth / elevation / distance update (G2O_Plane3D.h:74-87)."""
    az, el, dd = delta3[..., 0], delta3[..., 1], delta3[..., 2]
    s, co = torch.sin(el), torch.cos(el)
    n_local = torch.stack([co * torch.cos(az), co * torch.sin(az), s], dim=-1)
    R = geo.plane_rotation(c[..., :3])
    d = (-c[..., 3]) + dd  # distance() = -coeffs(3)
    n_new = torch.einsum("...ij,...j->...i", R, n_local)
    return geo.plane_normalize(torch.cat([n_new, -d[..., None]], dim=-1))


def retract_cuboid(pose, scale, delta9, fixrollpitch=True, fixheight=True):
    return geo.cuboid_oplus(pose, scale, delta9, fixrollpitch, fixheight)


def _safe_z(p):
    return torch.where(torch.abs(p[..., 2]) < 1e-6, 1e-6, p[..., 2])


def mono_residual(T_cw, X, uv, fx, fy, cx, cy):
    """Pixel reprojection residual (..., 2), EdgeSE3ProjectXYZ semantics."""
    p = geo.se3_apply(T_cw, X)
    z = _safe_z(p)
    u = fx * p[..., 0] / z + cx
    v = fy * p[..., 1] / z + cy
    return torch.stack([u - uv[..., 0], v - uv[..., 1]], dim=-1)


def stereo_residual(T_cw, X, uvr, fx, fy, cx, cy, bf):
    """(u, v, u_right) residual (..., 3), EdgeStereoSE3ProjectXYZ semantics."""
    p = geo.se3_apply(T_cw, X)
    z = _safe_z(p)
    u = fx * p[..., 0] / z + cx
    v = fy * p[..., 1] / z + cy
    ur = u - bf / z
    return torch.stack([u - uvr[..., 0], v - uvr[..., 1], ur - uvr[..., 2]], dim=-1)


def _stereo_dr_dp(T_cw, X, fx, fy, bf):
    """(d stereo_residual / d p (..., 3, 3), p = T X)."""
    p = geo.se3_apply(T_cw, X)
    z = _safe_z(p)
    live = (torch.abs(p[..., 2]) >= 1e-6).to(p.dtype)
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    du = torch.stack([fx * inv_z, zero, -fx * p[..., 0] * inv_z * inv_z * live], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * p[..., 1] * inv_z * inv_z * live], dim=-1)
    dur = du + torch.stack([zero, zero, bf * inv_z * inv_z * live], dim=-1)
    return torch.stack([du, dv, dur], dim=-2), p


def stereo_jacobian(T_cw, X, fx, fy, bf):
    """d stereo_residual / d delta at delta = 0 for ``retract_pose``: (..., 3, 6).

    Analytic form of the reference's forward-mode Jacobian: with p = T X, a left
    perturbation moves p by ``omega x p + upsilon``, so dp/d[omega, upsilon]
    = [-[p]_x, I]; the depth clamp of ``stereo_residual`` has zero slope."""
    dr_dp, p = _stereo_dr_dp(T_cw, X, fx, fy, bf)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    dp_dxi = torch.cat([-geo.so3_hat(p), eye], dim=-1)  # (..., 3, 6)
    return dr_dp @ dp_dxi


def stereo_jacobians(T_cw, X, fx, fy, bf):
    """d stereo_residual / d (pose delta, point delta) at zero for
    ``retract_pose`` and ``retract_point``: ((..., 3, 6), (..., 3, 3)), the
    reference's forward-mode pair (lm.py:490-503); dp/dX = R."""
    dr_dp, p = _stereo_dr_dp(T_cw, X, fx, fy, bf)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    dp_dxi = torch.cat([-geo.so3_hat(p), eye], dim=-1)
    return dr_dp @ dp_dxi, dr_dp @ T_cw[..., :3, :3]


def mono_jacobians(T_cw, X, fx, fy):
    """d mono_residual / d (pose delta, point delta) at zero for
    ``retract_pose`` and ``retract_point``: ((..., 2, 6), (..., 2, 3)).

    The reference differentiates through ``factors.linearize`` (forward
    mode); with p = T X, dp/d[omega, upsilon] = [-[p]_x, I] and dp/dX = R.
    The depth clamp of ``mono_residual`` has zero slope."""
    p = geo.se3_apply(T_cw, X)
    z = _safe_z(p)
    live = (torch.abs(p[..., 2]) >= 1e-6).to(p.dtype)
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    du = torch.stack([fx * inv_z, zero, -fx * p[..., 0] * inv_z * inv_z * live], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * p[..., 1] * inv_z * inv_z * live], dim=-1)
    dr_dp = torch.stack([du, dv], dim=-2)  # (..., 2, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    dp_dxi = torch.cat([-geo.so3_hat(p), eye], dim=-1)  # (..., 3, 6)
    return dr_dp @ dp_dxi, dr_dp @ T_cw[..., :3, :3]


def plane_residual(T_cw, plane_w, meas_c):
    """The world plane seen from the camera, ominus the measured local plane
    (..., 3): EdgePlane::computeError (G2O_Plane3D.h:181-192)."""
    return geo.plane_ominus(geo.plane_transform(T_cw, plane_w), meas_c)


def plane_ver_residual(T_cw, plane_w, meas_c):
    """2-dim vertical-relation residual (G2O_Plane3D.h:220-231)."""
    return geo.plane_ominus_ver(geo.plane_transform(T_cw, plane_w), meas_c)


def plane_par_residual(T_cw, plane_w, meas_c):
    """2-dim parallel-relation residual (G2O_Plane3D.h:279-290)."""
    return geo.plane_ominus_par(geo.plane_transform(T_cw, plane_w), meas_c)


def cuboid_bbox_residual(T_cw, cub_pose, cub_scale, bbox_meas, K):
    """Projected [cx, cy, w, h] minus the measured bbox (..., 4):
    EdgeSE3CuboidProj (g2o_cuboid.cc:70-91)."""
    return geo.cuboid_project_bbox(cub_pose, cub_scale, T_cw, K) - bbox_meas


def cuboid_corner_residual(T_cw, cub_pose, cub_scale, corners_meas16, K):
    """The 8 projected corners minus the measurement (..., 16):
    EdgeSE3CuboidCornerProj (g2o_cuboid.cc:103-120)."""
    pts = geo.cuboid_project_corners(cub_pose, cub_scale, T_cw, K)
    return pts.reshape(pts.shape[:-2] + (16,)) - corners_meas16


def cuboid_se3_residual(T_cw, cub_pose, cub_scale, meas_pose_c, meas_scale_c):
    """9-dim camera-cuboid residual, EdgeSE3Cuboid (g2o_cuboid.h:331-340):
    the camera-frame measurement taken into the world with Twc, and the
    yaw-ambiguity-minimal log error."""
    est_pose = geo.se3_inv(T_cw) @ meas_pose_c
    return geo.cuboid_min_log_error(cub_pose, cub_scale, est_pose, meas_scale_c)


def point_cuboid_residual(cub_pose, cub_scale, points, points_mask, max_outside_margin_ratio,
                          prior_weight):
    """Mean hinge error of the owned points against the cuboid plus a scale
    prior (..., 3): EdgePointCuboidOnlyObject (g2o_cuboid.cc:132-160).
    ``points`` (..., M, 3) is padded; masked entries add nothing."""
    errs = geo.cuboid_point_boundary_error(cub_pose[..., None, :, :], cub_scale[..., None, :], points,
                                           max_outside_margin_ratio)
    errs = torch.abs(errs) * points_mask[..., None]
    count = torch.clamp(torch.sum(points_mask, dim=-1), min=1.0)
    mean_err = torch.sum(errs, dim=-2) / count[..., None]
    mean_err = mean_err / torch.clamp(cub_scale, min=1e-6)
    return mean_err + prior_weight * cub_scale


def cuboid_plane_residual(cub_pose, cub_scale, plane_w, face_idx):
    """The plane ominus the cuboid's face ``face_idx`` (..., 3), the
    geometric form of the reference's dead-code EdgeCuboidPlane residual
    (G2O_Plane3D.h:348-400); the face is fixed at association time."""
    faces = geo.cuboid_face_planes(cub_pose, cub_scale)  # (..., 6, 4)
    idx = face_idx.long()[..., None, None].expand(faces.shape[:-2] + (1, 4))
    return geo.plane_ominus(plane_w, torch.take_along_dim(faces, idx, dim=-2)[..., 0, :])


def linearize(res_fn, retractions, estimates, *args):
    """Residuals and Jacobians of ``res_fn`` with respect to the tangent
    deltas of its variables, at zero (the reference takes ``jacfwd`` of each factor).

    ``retractions``: (retraction, dim) per variable; ``estimates``: each
    variable's batch of values, a tensor or a tuple of tensors (a cuboid is
    (pose, scale)) with the factor batch F leading; ``args``: further
    per-factor inputs, tensors with F leading, or Python numbers.

    All the columns come from one forward-mode pass: every tensor is
    expanded to (D, F, ...) and the deltas carry the identity as their
    tangent, D the sum of the dims.  Returns (r (F, R), [J_i (F, R, d_i)])."""
    dims = [d for _, d in retractions]
    total = sum(dims)
    first = estimates[0][0] if isinstance(estimates[0], tuple) else estimates[0]
    F, dev, dt = first.shape[0], first.device, first.dtype

    def wide(x):
        return x.unsqueeze(0).expand((total,) + tuple(x.shape)) if isinstance(x, torch.Tensor) else x

    tangent = torch.eye(total, dtype=dt, device=dev)[:, None, :].expand(total, F, total).contiguous()
    with fwAD.dual_level():
        dz = fwAD.make_dual(torch.zeros((total, F, total), dtype=dt, device=dev), tangent)
        vals, off = [], 0
        for (ret, d), est in zip(retractions, estimates):
            delta = dz[..., off:off + d]
            off += d
            v = ret(*map(wide, est), delta) if isinstance(est, tuple) else ret(wide(est), delta)
            vals.extend(v if isinstance(v, tuple) else (v,))
        out = fwAD.unpack_dual(res_fn(*vals, *map(wide, args)))
    r, J = out.primal[0], out.tangent.permute(1, 2, 0)
    return r, list(torch.split(J, dims, dim=-1))


def huber_weight(chi2, delta2):
    """IRLS weight of the Huber kernel with squared threshold ``delta2``."""
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
