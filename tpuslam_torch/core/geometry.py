"""Batched SE3 / SO3 geometry (port of the SE3 part of
``tpuslam/core/geometry.py``).

Same conventions as the reference: ``(..., 4, 4)`` homogeneous matrices
mapping source to destination frame, se3 tangents ``[omega, upsilon]``
(rotation first, g2o order), float32 throughout.
"""

from __future__ import annotations

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
