"""Batched RANSAC PnP for relocalization (port of
``tpuslam/frontend/pnp.py``; the role of PnPsolver.cc).

Each hypothesis is a 6-point DLT estimate of the projection matrix (the
smallest eigenvector of its 12 x 12 normal matrix, batched ``eigh``),
orthonormalized to SE3; every hypothesis is scored against every
correspondence at once.  The reference's docstring names EPnP, but its
code is this DLT, which is what is ported.  The reference draws the samples
from its own random stream inside the solver; here they are an input.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import geometry as geo


class PnPResult(NamedTuple):
    ok: torch.Tensor  # () bool
    T_cw: torch.Tensor  # (4, 4)
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _dlt_pose(X, uv, fx, fy, cx, cy):
    """(..., M, 3) points and their (..., M, 2) pixels, M >= 6 -> T_cw
    (..., 4, 4): the DLT of P = [R | t] on normalized coordinates, scaled
    to det R = 1 with the points in front, R projected onto SO(3)."""
    xn = (uv[..., 0] - cx) / fx
    yn = (uv[..., 1] - cy) / fy
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (..., M, 4)
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, -xn[..., None] * Xh], dim=-1)
    r2 = torch.cat([zero, Xh, -yn[..., None] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2M, 12)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    p = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 4)
    det = torch.linalg.det(p[..., :3])
    det_cbrt = torch.sign(det) * torch.abs(det) ** (1.0 / 3.0)
    p = p / torch.where(torch.abs(det_cbrt) < 1e-12, 1e-12, det_cbrt)[..., None, None]
    front = torch.sign(torch.sum(geo._matvec(Xh, p[..., 2, :]), dim=-1) + 1e-12)
    p = p * front[..., None, None]
    U, _, Vt = torch.linalg.svd(p[..., :3])
    R = U @ Vt
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    return geo.se3_from_Rt(R, p[..., 3])


def ransac_pnp(X, uv, valid, fx, fy, cx, cy, samples, th_chi2: float = 5.991):
    """Every hypothesis at once: ``samples`` (iters, 6) correspondence
    indices, one DLT each; the hypothesis with the most inliers (reprojection
    chi2 below ``th_chi2`` and in front) wins, ok with >= 10 of them."""
    samples = samples.to(X.device)
    Ts = _dlt_pose(X[samples], uv[samples], fx, fy, cx, cy)  # (iters, 4, 4)
    pc = geo.se3_apply(Ts[:, None], X)  # (iters, N, 3)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    e = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    inls = valid & (e < th_chi2) & (pc[..., 2] > 0)
    n_inls = torch.sum(inls, dim=-1)
    best = torch.argmax(n_inls)
    return PnPResult(ok=n_inls[best] >= 10, T_cw=Ts[best], inliers=inls[best], n_inliers=n_inls[best].to(torch.int32))
