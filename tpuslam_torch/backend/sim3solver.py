"""Batched Sim3 RANSAC and refinement for loop closing (port of
``tpuslam/backend/sim3solver.py``).

Every RANSAC hypothesis is a Horn alignment of a 3-point sample, solved
batched, and scored against every match with the symmetric reprojection
test (Sim3Solver::CheckInliers); the best one is refitted on its inliers.
The reference draws the samples from its own random stream inside the
solver; here they are an input (``initializer.ransac_samples`` draws the
same stream on the host), so a test can pass any draw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import geometry as geo
from ..graph import factors as fac


class Sim3Result(NamedTuple):
    ok: torch.Tensor  # () bool
    s: torch.Tensor  # () scale (2 -> 1)
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _rotation_from_svd(M):
    """The rotation closest to ``M`` (..., 3, 3) with det +1: U S Vt, S the
    identity with its last entry the sign of det(U) det(Vt)."""
    U, _, Vt = torch.linalg.svd(M)
    sign = torch.where(torch.linalg.det(U) * torch.linalg.det(Vt) < 0, -1.0, 1.0)
    ones = torch.ones_like(sign)
    return (U * torch.stack([ones, ones, sign], dim=-1)[..., None, :]) @ Vt


def horn_alignment(P1, P2, fix_scale: bool = False):
    """Closed-form s, R, t with P1 ~= s R P2 + t for (..., M, 3) point sets
    (Sim3Solver::ComputeSim3, Horn 1987, SVD form)."""
    c1 = P1.mean(dim=-2)
    c2 = P2.mean(dim=-2)
    x1 = P1 - c1[..., None, :]
    x2 = P2 - c2[..., None, :]
    R = _rotation_from_svd(x1.transpose(-1, -2) @ x2)
    if fix_scale:
        s = torch.ones(P1.shape[:-2], dtype=P1.dtype, device=P1.device)
    else:
        num = torch.sum(x1 * (x2 @ R.transpose(-1, -2)), dim=(-1, -2))
        s = num / torch.clamp(torch.sum(x2 * x2, dim=(-1, -2)), min=1e-12)
    t = c1 - s[..., None] * geo._matvec(R, c2)
    return s, R, t


def _project(K, p):
    z = torch.clamp(p[..., 2], min=1e-6)
    return torch.stack([K[0, 0] * p[..., 0] / z + K[0, 2], K[1, 1] * p[..., 1] / z + K[1, 2]], dim=-1)


def solve_sim3(P1, P2, valid, uv1, uv2, K, samples, fix_scale: bool = False, th_chi2: float = 9.210):
    """RANSAC Sim3 between matched 3D point sets, with the symmetric
    reprojection inlier test (chi2 9.21: 2 DoF at 99%).

    P1/P2: (N, 3) camera-frame points in keyframes 1 and 2; uv1/uv2 their
    pixels; ``samples``: (iters, 3) match indices, one hypothesis each.
    Returns the transform S12 mapping frame-2 points into frame 1."""
    samples = samples.to(P1.device)
    ss, Rs, ts = horn_alignment(P1[samples], P2[samples], fix_scale)

    def score(s, R, t):
        p2_in_1 = s[..., None, None] * (P2 @ R.transpose(-1, -2)) + t[..., None, :]
        e1 = torch.sum((_project(K, p2_in_1) - uv1) ** 2, dim=-1)
        s_inv = 1.0 / torch.clamp(s, min=1e-12)
        p1_in_2 = s_inv[..., None, None] * ((P1 - t[..., None, :]) @ R)
        e2 = torch.sum((_project(K, p1_in_2) - uv2) ** 2, dim=-1)
        inl = valid & (e1 < th_chi2) & (e2 < th_chi2)
        return torch.sum(inl, dim=-1), inl

    n_inls, inls = score(ss, Rs, ts)
    best = torch.argmax(n_inls)
    s, R, t = ss[best], Rs[best], ts[best]
    # refit on the best hypothesis' inliers (weighted Horn)
    w = inls[best].to(P1.dtype)[:, None]
    nw = torch.clamp(w.sum(), min=3.0)
    c1 = torch.sum(P1 * w, dim=0) / nw
    c2 = torch.sum(P2 * w, dim=0) / nw
    x1 = (P1 - c1) * w
    R2 = _rotation_from_svd(x1.T @ (P2 - c2))
    if fix_scale:
        s2 = torch.ones((), dtype=P1.dtype, device=P1.device)
    else:
        num = torch.sum(x1 * ((P2 - c2) @ R2.T))
        s2 = num / torch.clamp(torch.sum(((P2 - c2) * w) * (P2 - c2)), min=1e-12)
    t2 = c1 - s2 * (R2 @ c2)
    n2, inl2 = score(s2, R2, t2)
    better = n2 >= n_inls[best]
    n = torch.where(better, n2, n_inls[best])
    return Sim3Result(
        ok=n >= 20, s=torch.where(better, s2, s), R=torch.where(better, R2, R), t=torch.where(better, t2, t),
        inliers=torch.where(better, inl2, inls[best]), n_inliers=n.to(torch.int32),
    )


def optimize_sim3(S, P1, P2, uv1, uv2, K, valid, n_iters: int = 10, th2: float = 10.0, fix_scale: bool = False,
                  huber2: float = 10.0):
    """Gauss-Newton refinement of a Sim3 with bidirectional reprojection
    residuals (Optimizer::OptimizeSim3, Optimizer.cc:1054-1249): Huber
    sqrt(10), two rounds with the chi2 > ``th2`` matches pruned between
    them, a step kept only where the robust cost of the active set falls.

    S: (4, 4) Sim3 mapping frame-2 points into frame 1; P1/P2: (N, 3) points
    in their own camera frames; uv1/uv2: (N, 2) pixels (uv2[i] observes
    P1[i] in frame 2, uv1[i] observes P2[i] in frame 1).  The Jacobians of
    the left-multiplied update exp(d) S at d = 0 come from forward mode, as
    the reference's ``jacfwd``.  Returns (S_refined, inliers (N,) bool,
    n_inliers)."""
    N = P1.shape[0]
    dev, dt = P1.device, P1.dtype

    def residuals(S_, p1, p2, q1, q2):
        r1 = _project(K, geo.sim3_apply(S_[..., None, :, :], p2)) - q1
        r2 = _project(K, geo.sim3_apply(geo.sim3_inv(S_)[..., None, :, :], p1)) - q2
        return r1, r2

    def chi2(S_):
        r1, r2 = residuals(S_, P1, P2, uv1, uv2)
        return torch.sum(r1**2, -1), torch.sum(r2**2, -1)

    def flat_res(Sd, p1, p2, q1, q2):
        return torch.cat(residuals(Sd, p1, p2, q1, q2), dim=-2).flatten(-2)

    def rho(c):
        return torch.where(c > huber2, 2 * torch.sqrt(huber2 * c) - huber2, c)

    def cost(Sx, active):
        c1, c2 = chi2(Sx)
        return torch.sum(torch.where(active, rho(c1) + rho(c2), 0.0))

    eye7 = torch.eye(7, dtype=dt, device=dev)

    def step(S_, active):
        r0, (J,) = fac.linearize(flat_res, [(lambda S0, d: geo.sim3_exp(d) @ S0, 7)], [S_[None]],
                                 P1[None], P2[None], uv1[None], uv2[None])
        r0, J = r0[0].reshape(2 * N, 2), J[0].reshape(2 * N, 2, 7)
        w = torch.cat([active, active]).to(dt)
        e2 = torch.sum(r0**2, -1)
        w = w * torch.where(e2 > huber2, torch.sqrt(huber2 / torch.clamp(e2, min=1e-12)), 1.0)
        Jw = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", Jw, J) + 1e-6 * eye7
        g = torch.einsum("nij,ni->j", Jw, r0)
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            g = torch.cat([g[:6], torch.zeros_like(g[6:])])
        d = -torch.linalg.solve(H, g)
        S_new = geo.sim3_exp(d) @ S_
        return torch.where(cost(S_new, active) < cost(S_, active), S_new, S_)

    active = valid
    for _ in range(2):
        for _ in range(n_iters // 2):
            S = step(S, active)
        c1, c2 = chi2(S)
        active = valid & (c1 < th2) & (c2 < th2)
    return S, active, torch.sum(active.to(torch.int32))
