"""Reprojection factors for pose optimization and bundle adjustment (port of
the point-factor part of ``tpuslam/graph/factors.py``).

The reference writes single-factor closures and vmaps them; here each
function takes a batch of points in its leading dimensions.

Update convention (shared with lm.py): ``T' = exp(delta) @ T``, a left
perturbation with the 6-dim tangent ``[omega, upsilon]``.
"""

from __future__ import annotations

import torch

from ..core import geometry as geo


def retract_pose(T, delta6):
    return geo.se3_exp(delta6) @ T


def retract_point(X, delta3):
    return X + delta3


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


def stereo_jacobian(T_cw, X, fx, fy, bf):
    """d stereo_residual / d delta at delta = 0 for ``retract_pose``: (..., 3, 6).

    Analytic form of the reference's forward-mode Jacobian: with p = T X, a left
    perturbation moves p by ``omega x p + upsilon``, so dp/d[omega, upsilon]
    = [-[p]_x, I]; the depth clamp of ``stereo_residual`` has zero slope."""
    p = geo.se3_apply(T_cw, X)
    z = _safe_z(p)
    live = (torch.abs(p[..., 2]) >= 1e-6).to(p.dtype)
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    du = torch.stack([fx * inv_z, zero, -fx * p[..., 0] * inv_z * inv_z * live], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * p[..., 1] * inv_z * inv_z * live], dim=-1)
    dur = du + torch.stack([zero, zero, bf * inv_z * inv_z * live], dim=-1)
    dr_dp = torch.stack([du, dv, dur], dim=-2)  # (..., 3, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    dp_dxi = torch.cat([-geo.so3_hat(p), eye], dim=-1)  # (..., 3, 6)
    return dr_dp @ dp_dxi


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


def huber_weight(chi2, delta2):
    """IRLS weight of the Huber kernel with squared threshold ``delta2``."""
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
