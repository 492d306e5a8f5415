"""Sim3 essential-graph optimization, the back end of loop closing (port of
``tpuslam/backend/posegraph.py``; Optimizer::OptimizeEssentialGraph,
Optimizer.cc:789-1052).

Vertices are per-keyframe Sim3 world->camera poses (scale 1 before the
loop); edges are relative Sim3 measurements.  Each Gauss-Newton iteration
linearizes every edge residual r = log(M_ji S_i S_j^-1) in forward mode
with respect to left-multiplied tangents, scatter-adds the dense (7K, 7K)
normal equations and solves them with ``torch.linalg.solve``.  The scatter
goes through ``graph.lm._sum_at``, so each entry's terms are summed in edge
order on either device (on the CPU ``index_put(accumulate=True)`` would add
them atomically across threads, in no fixed order).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import geometry as geo
from ..graph import factors as fac
from ..graph import lm


class Sim3Edges(NamedTuple):
    i: torch.Tensor  # (E,) from-vertex
    j: torch.Tensor  # (E,) to-vertex
    meas: torch.Tensor  # (E, 4, 4) measured S_ji = S_j S_i^-1
    weight: torch.Tensor  # (E,)
    valid: torch.Tensor  # (E,) bool


def edge_residual(S_i, S_j, M_ji):
    """(..., 7) Sim3 log of M_ji S_i S_j^-1 (zero when consistent)."""
    return geo.sim3_log(M_ji @ S_i @ geo.sim3_inv(S_j))


def _retract(S, d):
    return geo.sim3_exp(d) @ S


def assemble_sim3_system(S, edges: Sim3Edges, D: int):
    """Linearize the edges and scatter-add the (D, D) normal equations.
    Returns (H, b, cost)."""
    ei, ej = edges.i.long(), edges.j.long()
    r, (Ji, Jj) = fac.linearize(edge_residual, [(_retract, 7), (_retract, 7)], [S[ei], S[ej]], edges.meas)
    valid = edges.valid
    w = edges.weight * valid
    r = torch.where(valid[:, None], r, 0.0)
    Ji = torch.where(valid[:, None, None], Ji, 0.0)
    Jj = torch.where(valid[:, None, None], Jj, 0.0)
    dev = S.device
    ar = torch.arange(7, device=dev)

    def flat(ri, ci):
        rows = 7 * ri[:, None, None] + ar[None, :, None]
        return (rows * D + 7 * ci[:, None, None] + ar[None, None, :]).reshape(-1)

    JiW = Ji * w[:, None, None]
    JjW = Jj * w[:, None, None]
    Hij = torch.einsum("fdi,fdj->fij", JiW, Jj)
    # the reference's four H scatters and two b scatters, in its order
    # (posegraph.py:68-76), each as one run of terms summed in edge order
    blocks = ((ei, ei, torch.einsum("fdi,fdj->fij", JiW, Ji)), (ej, ej, torch.einsum("fdi,fdj->fij", JjW, Jj)),
              (ei, ej, Hij), (ej, ei, Hij.transpose(-1, -2)))
    H = lm._sum_at(torch.zeros(D * D, dtype=S.dtype, device=dev), torch.cat([flat(ri, ci) for ri, ci, _ in blocks]),
                   torch.cat([blk.reshape(-1) for _, _, blk in blocks])).view(D, D)
    b = lm._sum_at(torch.zeros(D, dtype=S.dtype, device=dev), (7 * torch.cat([ei, ej])[:, None] + ar).reshape(-1),
                   -torch.cat([torch.einsum("fdi,fd->fi", JiW, r), torch.einsum("fdi,fd->fi", JjW, r)]).reshape(-1))
    return H, b, torch.sum(r * r * w[:, None])


def solve_sim3_step(S, H, b, free, lam: float):
    """Mask the gauge (fixed vertices get unit diagonal rows), damp, solve,
    retract."""
    K = S.shape[0]
    D = 7 * K
    H = H * (free[:, None] * free[None, :]) + torch.diag(1.0 - free)
    H = H + (lam + 1e-6) * torch.eye(D, dtype=H.dtype, device=H.device)
    delta = torch.linalg.solve(H, b * free) * free
    return geo.sim3_exp(delta.reshape(K, 7)) @ S


def optimize_essential_graph(S, fixed, edges: Sim3Edges, n_iters: int = 20, lam: float = 1e-6):
    """Gauss-Newton over Sim3 vertices.  ``S``: (K, 4, 4) Sim3 world->camera;
    ``fixed``: (K,) bool (the loop keyframe and the empty slots).
    Returns (optimized (K, 4, 4), cost before each iteration (n_iters,))."""
    K = S.shape[0]
    D = 7 * K
    free = (~fixed).to(S.dtype).repeat_interleave(7)
    costs = []
    for _ in range(n_iters):
        H, b, cost = assemble_sim3_system(S, edges, D)
        S = solve_sim3_step(S, H, b, free, lam)
        costs.append(cost)
    return S, torch.stack(costs)


def se3_to_sim3(T):
    """SE3 (..., 4, 4) -> Sim3 with scale 1 (the same matrix)."""
    return T


def sim3_to_se3(S):
    """Sim3 -> SE3 with the scale folded into the translation, Tcw = [R | t/s]
    (LoopClosing::CorrectLoop, LoopClosing.cc:488-494)."""
    s = geo.sim3_scale(S)
    return geo.se3_from_Rt(geo.sim3_R(S), S[..., :3, 3] / s[..., None])


def correct_points_for_sim3(points, first_kf, old_S, new_S):
    """Re-anchor points through their reference keyframe's correction:
    X' = S_new_kf^-1 (S_old_kf X) (LoopClosing.cc:443-516)."""
    a = first_kf.long()
    return geo.sim3_apply(geo.sim3_inv(new_S[a]), geo.sim3_apply(old_S[a], points))
