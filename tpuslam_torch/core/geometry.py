"""Batched SE3 / SO3, Sim3, plane and cuboid geometry (port of
``tpuslam/core/geometry.py``).

Same conventions as the reference: ``(..., 4, 4)`` homogeneous matrices
mapping source to destination frame, se3 tangents ``[omega, upsilon]``
(rotation first, g2o order), planes as Hessian ``[n, d]`` with unit n and
d >= 0, cuboids as an object->world pose and half extents, float32
throughout.  The functions broadcast over leading dimensions and run under
forward-mode AD (``graph/factors.linearize``).
"""

from __future__ import annotations

import numpy as np
import torch


def so3_hat(w):
    """Skew-symmetric matrix of ``w`` (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w):
    """Rodrigues' formula, numerically safe around theta = 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = so3_hat(w)
    W2 = W @ W
    big = theta2 > 1e-12
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def _so3_left_jacobian(w):
    """V such that exp([w, u]) has translation V @ u (rotation-first se3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = so3_hat(w)
    W2 = W @ W
    big = theta2 > 1e-12
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(
        big, (theta - torch.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0
    )
    return _eye3_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def se3_from_Rt(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # a kernel; assigning a Python number copies from the host
    return T


def se3_identity(batch=(), dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(*batch, 4, 4)


def se3_R(T):
    return T[..., :3, :3]


def se3_t(T):
    return T[..., :3, 3]


def se3_exp(xi):
    """se3 exp with tangent ``[omega, upsilon]`` (rotation first, g2o order)."""
    w, u = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", V, u)
    return se3_from_Rt(R, t)


def se3_inv(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_from_Rt(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def se3_renorm(T):
    """Project the rotation block back onto SO(3) (row-wise Gram-Schmidt);
    see ``tpuslam/core/geometry.py:se3_renorm`` for why every pose entering
    an optimizer goes through it."""
    R = T[..., :3, :3]
    r0 = R[..., 0, :]
    r0 = r0 / (torch.linalg.vector_norm(r0, dim=-1, keepdim=True) + 1e-12)
    r1 = R[..., 1, :]
    r1 = r1 - torch.sum(r0 * r1, dim=-1, keepdim=True) * r0
    r1 = r1 / (torch.linalg.vector_norm(r1, dim=-1, keepdim=True) + 1e-12)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    Rn = torch.stack([r0, r1, r2], dim=-2)
    return se3_from_Rt(Rn, T[..., :3, 3])


def se3_apply(T, p):
    """Transform points ``p`` (..., 3) by ``T`` (..., 4, 4)."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def _vnorm(v, keepdim=False):
    """Euclidean norm written as sqrt(sum(v * v)), as the reference's
    ``jnp.linalg.norm`` is: its forward derivative at zero is NaN, where
    ``torch.linalg.vector_norm``'s is 0, and factor Jacobians keep NaN where
    the reference has it."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def _matvec(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _stack33(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def so3_log(R):
    """Inverse of :func:`so3_exp`, safe at theta = 0 and near pi; theta is
    arctan2(|antisym|, trace) so the derivative stays finite at 0."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = 0.5 * torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-5
    near_pi = theta > torch.pi - 1e-3
    sin_t_safe = torch.where(small | near_pi, 1.0, sin_t)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_t_safe))
    w_generic = scale[..., None] * v
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + 1e-32), min=0.0)
    axis = torch.sqrt(axis2 + 1e-12)
    sx = torch.where(v[..., 0] >= 0, 1.0, -1.0)
    sy = torch.where((R[..., 0, 1] + R[..., 1, 0]) * sx >= 0, sx, -sx)
    sz = torch.where((R[..., 0, 2] + R[..., 2, 0]) * sx >= 0, sx, -sx)
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    w_pi = theta[..., None] * axis / (_vnorm(axis, keepdim=True) + 1e-32)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian_inv(w):
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = so3_hat(w)
    W2 = W @ W
    half = theta * 0.5
    cot = torch.where(
        theta2 > 1e-12,
        (1.0 - half * torch.cos(half) / (torch.sin(half) + 1e-32)) / (theta2 + 1e-32),
        1.0 / 12.0 + theta2 / 720.0,
    )
    return _eye3_like(W) - 0.5 * W + cot[..., None, None] * W2


def se3_log(T):
    """Inverse of :func:`se3_exp` -> ``[omega, upsilon]``."""
    w = so3_log(T[..., :3, :3])
    u = _matvec(_so3_left_jacobian_inv(w), T[..., :3, 3])
    return torch.cat([w, u], dim=-1)


# ---------------------------------------------------------------------------
# Sim3 (loop closing), stored as (..., 4, 4) with sR top-left
# ---------------------------------------------------------------------------


def sim3_from_sRt(s, R, t):
    return se3_from_Rt(s[..., None, None] * R, t)


def sim3_scale(S):
    return _vnorm(S[..., :3, 0])


def sim3_R(S):
    return S[..., :3, :3] / sim3_scale(S)[..., None, None]


def sim3_inv(S):
    s = sim3_scale(S)
    Rt = sim3_R(S).transpose(-1, -2)
    s_inv = 1.0 / s
    return sim3_from_sRt(s_inv, Rt, -s_inv[..., None] * _matvec(Rt, S[..., :3, 3]))


def sim3_apply(S, p):
    return torch.einsum("...ij,...j->...i", S[..., :3, :3], p) + S[..., :3, 3]


def sim3_log(S):
    """Sim3 log -> ``[omega(3), upsilon(3), sigma(1)]`` (..., 7)."""
    sigma = torch.log(sim3_scale(S))
    w = so3_log(sim3_R(S))
    u = torch.linalg.solve(_sim3_W(w, sigma), S[..., :3, 3:4])[..., 0]
    return torch.cat([w, u, sigma[..., None]], dim=-1)


def sim3_exp(xi):
    """Inverse of :func:`sim3_log`."""
    w, u, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return sim3_from_sRt(torch.exp(sigma), so3_exp(w), _matvec(_sim3_W(w, sigma), u))


def _sim3_W(w, sigma):
    """Sim3 translation matrix W = C I + A hat(w) + B hat(w)^2 (Strasdat's
    closed form, as g2o's sim3), with the small-angle and small-scale
    branches selected by ``where``."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    s = torch.exp(sigma)
    Wm = so3_hat(w)
    W2 = Wm @ Wm
    eps = 1e-5
    small_sigma = torch.abs(sigma) < eps
    small_theta = theta < eps
    sigma_safe = torch.where(small_sigma, 1.0, sigma)
    theta_safe = torch.where(small_theta, 1.0, theta)
    theta2_safe = torch.where(small_theta, 1.0, theta2)

    # sigma ~ 0: the SE3 left-Jacobian coefficients
    A_s0 = torch.where(small_theta, 0.5, (1.0 - torch.cos(theta_safe)) / theta2_safe)
    B_s0 = torch.where(small_theta, 1.0 / 6.0, (theta_safe - torch.sin(theta_safe)) / (theta2_safe * theta_safe))
    C_s0 = torch.ones_like(sigma)
    C_g = (s - 1.0) / sigma_safe
    # theta ~ 0
    A_t0 = ((sigma_safe - 1.0) * s + 1.0) / (sigma_safe * sigma_safe)
    B_t0 = ((0.5 * sigma_safe * sigma_safe - sigma_safe + 1.0) * s - 1.0) / (sigma_safe**3)
    a_ = s * torch.sin(theta_safe)
    b_ = s * torch.cos(theta_safe)
    c_ = theta2_safe + sigma_safe * sigma_safe
    A_g = (a_ * sigma_safe + (1.0 - b_) * theta_safe) / (theta_safe * c_)
    B_g = (C_g - ((b_ - 1.0) * sigma_safe + a_ * theta_safe) / c_) / theta2_safe

    A = torch.where(small_sigma, A_s0, torch.where(small_theta, A_t0, A_g))
    B = torch.where(small_sigma, B_s0, torch.where(small_theta, B_t0, B_g))
    C = torch.where(small_sigma, C_s0, C_g)
    return C[..., None, None] * _eye3_like(Wm) + A[..., None, None] * Wm + B[..., None, None] * W2


def se3_exp_norollpitch(xi):
    """g2o ``exptwist_norollpitch``: a yaw-only rotation with the full-SE3
    V(omega) on the translation (g2o_cuboid.cc:6-36)."""
    w, u = xi[..., :3], xi[..., 3:]
    yaw = w[..., 2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    R = _stack33([[c, -s, z], [s, c, z], [z, z, o]])
    return se3_from_Rt(R, _matvec(_so3_left_jacobian(w), u))


def quat_to_R(q):
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / (n + 1e-32), 0.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return _stack33([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def R_to_quat(R):
    """Rotation matrix -> unit quaternion (x, y, z, w), branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = 0.5 * torch.sqrt(torch.clamp(1.0 + tr, min=1e-12))
    qx = 0.5 * torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12))
    qy = 0.5 * torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12))
    qz = 0.5 * torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12))
    qx = qx * torch.sign(torch.where(m21 - m12 == 0, 1.0, m21 - m12))
    qy = qy * torch.sign(torch.where(m02 - m20 == 0, 1.0, m02 - m20))
    qz = qz * torch.sign(torch.where(m10 - m01 == 0, 1.0, m10 - m01))
    q = torch.stack([qx, qy, qz, qw], dim=-1)
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-32)


def euler_zyx_to_R(roll, pitch, yaw):
    """ZYX euler, applied as Rz(yaw) Ry(pitch) Rx(roll) (g2o_cuboid.h:43-48)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return _stack33([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def R_to_euler_zyx(R):
    """Rotation matrix -> (roll, pitch, yaw) (g2o_cuboid.h:149-159)."""
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


# ---------------------------------------------------------------------------
# Planes: Hessian form [n, d], unit n, d >= 0 (G2O_Plane3D.h)
# ---------------------------------------------------------------------------


def plane_normalize(c):
    """Scale to a unit normal, flip so c[3] >= 0 (G2O_Plane3D.h:120-125)."""
    c = c / (_vnorm(c[..., :3], keepdim=True) + 1e-32)
    return torch.where(c[..., 3:4] < 0.0, -c, c)


def plane_transform(T, c):
    """A plane through the point transform ``T``: n' = R n, d' = d - t . n',
    sign-normalized (G2O_Plane3D.h:131-140)."""
    n2 = _matvec(T[..., :3, :3], c[..., :3])
    d2 = c[..., 3] - torch.sum(T[..., :3, 3] * n2, dim=-1)
    c2 = torch.cat([n2, d2[..., None]], dim=-1)
    return torch.where(c2[..., 3:4] < 0.0, -c2, c2)


def _azimuth(v):
    return torch.atan2(v[..., 1], v[..., 0])


def _elevation(v):
    return torch.atan2(v[..., 2], _vnorm(v[..., :2]))


def plane_rotation(v):
    """Rotation sending (1, 0, 0) to the direction ``v`` (G2O_Plane3D.h:66-72)."""
    az, el = _azimuth(v), _elevation(v)
    cz, sz = torch.cos(az), torch.sin(az)
    cy, sy = torch.cos(-el), torch.sin(-el)
    z, o = torch.zeros_like(az), torch.ones_like(az)
    Rz = _stack33([[cz, -sz, z], [sz, cz, z], [z, z, o]])
    Ry = _stack33([[cy, z, sy], [z, o, z], [-sy, z, cy]])
    return Rz @ Ry


def plane_ominus(c_self, c_other):
    """3-dim residual [azimuth, elevation, distance_self - distance_other] of
    ``other``'s normal in the frame whose x axis is ``self``'s normal; the
    distance is -d (G2O_Plane3D.h:58-60, 89-95)."""
    n = _matvec(plane_rotation(c_self[..., :3]).transpose(-1, -2), c_other[..., :3])
    d = (-c_self[..., 3]) - (-c_other[..., 3])
    return torch.stack([_azimuth(n), _elevation(n), d], dim=-1)


def plane_ominus_ver(c_self, c_other):
    """2-dim residual for perpendicular planes (G2O_Plane3D.h:97-106)."""
    n_self, n_other = c_self[..., :3], c_other[..., :3]
    v = torch.linalg.cross(n_self, n_other, dim=-1)
    axis = v / (_vnorm(v, keepdim=True) + 1e-32)
    half = np.float32(np.pi / 4.0)
    q = torch.cat([float(np.sin(half)) * axis, torch.full_like(axis[..., :1], float(np.cos(half)))], dim=-1)
    b = _matvec(quat_to_R(q), n_self)
    n = _matvec(plane_rotation(b).transpose(-1, -2), n_other)
    return torch.stack([_azimuth(n), _elevation(n)], dim=-1)


def plane_ominus_par(c_self, c_other):
    """2-dim residual for parallel planes (G2O_Plane3D.h:108-117)."""
    n_self, n_other = c_self[..., :3], c_other[..., :3]
    dot = torch.sum(n_self * n_other, dim=-1, keepdim=True)
    nor = torch.where(dot < 0, -n_self, n_self)
    n = _matvec(plane_rotation(nor).transpose(-1, -2), n_other)
    return torch.stack([_azimuth(n), _elevation(n)], dim=-1)


# ---------------------------------------------------------------------------
# Cuboids: 9 DoF, an object->world SE3 pose and half extents (3,)
# ---------------------------------------------------------------------------

# rows are the corners of g2o_cuboid.h:200-204 (x, y, z signs)
_CORNER_SIGNS = np.array(
    [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
     [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32)


_CORNER_SIGNS_ON: dict = {}


def _corner_signs(like):
    """The corner signs on ``like``'s device, copied there once."""
    dev = like.device
    if dev not in _CORNER_SIGNS_ON:
        _CORNER_SIGNS_ON[dev] = torch.from_numpy(_CORNER_SIGNS).to(dev)
    return _CORNER_SIGNS_ON[dev]


def cuboid_corners(pose, scale):
    """The 8 corners in the world frame, (..., 8, 3) (g2o_cuboid.h:198-207)."""
    local = _corner_signs(scale) * scale[..., None, :]
    return se3_apply(pose[..., None, :, :], local)


def cuboid_from_minimal(v9):
    """[x y z roll pitch yaw sx sy sz] -> (pose, scale) (g2o_cuboid.h:43-48)."""
    R = euler_zyx_to_R(v9[..., 3], v9[..., 4], v9[..., 5])
    return se3_from_Rt(R, v9[..., :3]), v9[..., 6:9]


def cuboid_to_minimal(pose, scale):
    roll, pitch, yaw = R_to_euler_zyx(pose[..., :3, :3])
    return torch.cat([pose[..., :3, 3], torch.stack([roll, pitch, yaw], dim=-1), scale], dim=-1)


def cuboid_rotate(pose, scale, k):
    """Turn the cuboid's front face by ``k`` x 90 degrees about its body z,
    swapping the x and y half extents for odd ``k`` (g2o_cuboid.h:112-122)."""
    yaw = k.to(pose.dtype) * (torch.pi / 2.0)
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    rot = se3_from_Rt(_stack33([[c, -s, z], [s, c, z], [z, z, o]]),
                      torch.zeros(yaw.shape + (3,), dtype=pose.dtype, device=pose.device))
    odd = (torch.abs(k) % 2 == 1)[..., None]
    swapped = torch.stack([scale[..., 1], scale[..., 0], scale[..., 2]], dim=-1)
    return pose @ rot, torch.where(odd, swapped, scale)


def cuboid_log_error(pose_a, scale_a, pose_b, scale_b):
    """9-vector [se3 log of pose_b^-1 pose_a, scale_a - scale_b]
    (g2o_cuboid.h:73-80)."""
    return torch.cat([se3_log(se3_inv(pose_b) @ pose_a), scale_a - scale_b], dim=-1)


def cuboid_min_log_error(pose_a, scale_a, pose_b, scale_b):
    """The log error of the smallest norm over cuboid b turned by -90, 0,
    90 and 180 degrees about its z (g2o_cuboid.h:83-109); the first of tied
    norms wins."""
    ks = torch.arange(-1, 3, dtype=torch.int32, device=pose_a.device)
    kb = ks.reshape((4,) + (1,) * (pose_b.dim() - 2))
    pb, sb = cuboid_rotate(pose_b[None], scale_b[None], kb.expand((4,) + pose_b.shape[:-2]))
    errs = cuboid_log_error(pose_a[None], scale_a[None], pb, sb)  # (4, ..., 9)
    best = torch.argmin(_vnorm(errs), dim=0)
    return torch.take_along_dim(errs, best[None, ..., None], dim=0)[0]


def cuboid_project_corners(pose, scale, Tcw, K):
    """The 8 corners in the image, (..., 8, 2) (g2o_cuboid.h:210-215)."""
    cam = se3_apply(Tcw[..., None, :, :], cuboid_corners(pose, scale))
    uvw = torch.einsum("...ij,...kj->...ki", K, cam)
    return uvw[..., :2] / (uvw[..., 2:3] + 1e-32)


def cuboid_project_bbox(pose, scale, Tcw, K):
    """The projected bbox [cx, cy, w, h] (g2o_cuboid.h:218-234).  Min and max
    share their derivative among tied corners, as the reference's do."""
    pts = cuboid_project_corners(pose, scale, Tcw, K)
    topleft, bottomright = torch.amin(pts, dim=-2), torch.amax(pts, dim=-2)
    return torch.cat([0.5 * (topleft + bottomright), bottomright - topleft], dim=-1)


def cuboid_point_boundary_error(pose, scale, point, max_outside_margin_ratio):
    """Hinge penalty of a point outside the cuboid (g2o_cuboid.h:237-255)."""
    local = torch.abs(se3_apply(se3_inv(pose), point))
    capped = torch.minimum(local - scale, max_outside_margin_ratio * scale)
    return torch.where(local < scale, 0.0, capped)


def cuboid_oplus(pose, scale, delta9, fixrollpitch=True, fixheight=True):
    """Right-multiplicative cuboid update (g2o_cuboid.cc:39-67): with
    ``fixrollpitch`` the rotation update is yaw-only, with ``fixheight`` the
    world-frame y of the translation is kept.  The reference's comment takes
    y for the height (a y-up ground); in a z-up world, as the golden scene's,
    this pins a horizontal coordinate and leaves the height free.  Mirrored,
    not fixed (ROADMAP section 3)."""
    if fixrollpitch:
        zero2 = torch.zeros_like(delta9[..., :2])
        new_pose = pose @ se3_exp_norollpitch(torch.cat([zero2, delta9[..., 2:6]], dim=-1))
    else:
        new_pose = pose @ se3_exp(delta9[..., :6])
    if fixheight:
        t = new_pose[..., :3, 3]
        t = torch.stack([t[..., 0], pose[..., 1, 3].expand_as(t[..., 1]), t[..., 2]], dim=-1)
        new_pose = torch.cat([torch.cat([new_pose[..., :3, :3], t[..., None]], dim=-1), new_pose[..., 3:, :]],
                             dim=-2)
    return new_pose, scale + delta9[..., 6:9]


def cuboid_face_planes(pose, scale):
    """The 6 face planes of a cuboid in Hessian form, (..., 6, 4): the body
    axes as normals, through corner 0 for the first three faces and corner 6
    for the last three (Tracking.cc:2719-2734, G2O_Plane3D.h:365-390)."""
    R = pose[..., :3, :3]
    corners = cuboid_corners(pose, scale)
    planes = []
    for k in range(6):
        axis = R[..., :, k % 3]
        anchor = corners[..., 0, :] if k < 3 else corners[..., 6, :]
        d = -torch.sum(axis * anchor, dim=-1)
        planes.append(torch.cat([axis, d[..., None]], dim=-1))
    return plane_normalize(torch.stack(planes, dim=-2))
