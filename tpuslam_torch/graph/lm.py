"""Motion-only pose optimization (port of ``tpuslam/graph/lm.py:
optimize_pose`` and ``_rho_huber``).

The reference stops an LM round early, through ``lax.while_loop``, once an
accepted step is smaller than 1e-6.  Stopping on the host would wait for the
device on every iteration, so here each round runs all its iterations and an
iteration whose round has converged changes nothing: ``T``, ``lam`` and the
step norm are frozen where ``active = dn > 1e-6`` is false.  The result is
that of the early exit.
"""

from __future__ import annotations

import torch

from ..core import geometry as geo
from . import factors as fac


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

