"""Distributed bundle adjustment over ``torch.distributed`` ranks (port of
``tpuslam/dist/ba.py``).

Factors are split across ranks along the factor axis: every rank assembles
partial normal equations from its contiguous slice of each bundle (rank r
takes rows ``[r n / k, (r + 1) n / k)``, as the reference's ``_to_global``,
ba.py:162-164), the blocks are summed with one all-reduce, and the reduced
(Schur) solve is replicated: it is small (D x D for D = 6K + 9C + 3Q) and
the landmark back-substitution is elementwise.  So the collective traffic
per LM iteration is one all-reduce of H_cc, H_cl, H_ll, b_c, b_l and chi2,
packed into one flat buffer, and one of the trial's chi2.

Layout:
  state (poses, points, planes, cuboids): replicated
  factor bundles:                         split along F over the ranks
  H_cc, H_cl, H_ll, b_c, b_l, chi2:       all-reduced, then replicated

One path covers the reference's two (its single-process ``shard_map`` mesh
and its cross-process ``multihost_*`` one): one rank per device
(``dist/mesh.py``).  Every rank must call these functions collectively with
identical inputs, as the reference asks of its multi-host path
(ba.py:176-178); the results are then equal on every rank.

The ranks' collectives go through the group's backend as they are: NCCL for
CUDA tensors when each rank owns a card, gloo for CPU ranks and for ranks
that share a card.  ``ALLREDUCE`` counts the all-reduce calls and the bytes
they carried (each rank's buffer once).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..backend.posegraph import Sim3Edges, assemble_sim3_system, solve_sim3_step
from ..graph import lm
from . import mesh

# the factor bundles of BAData (the gauge fields stay whole on every rank)
FACTOR_FIELDS = ("mono", "stereo") + tuple(lm.BUNDLES)

ALLREDUCE = {"calls": 0, "bytes": 0}


def _padded(n: int, k: int) -> int:
    return -(-n // k) * k


def _pad_rows(a, n: int):
    return torch.cat([a, a.new_zeros((n - a.shape[0],) + tuple(a.shape[1:]))]) if n > a.shape[0] else a


def _bundles(data):
    return {k: getattr(data, k) for k in FACTOR_FIELDS if getattr(data, k) is not None}


def pad_factors_for_mesh(data: lm.BAData, n_ranks: int) -> lm.BAData:
    """Pad every factor bundle's leading axis with zeros (invalid factors)
    to a multiple of ``n_ranks``."""
    return data._replace(**{k: type(b)(*(_pad_rows(a, _padded(b[0].shape[0], n_ranks)) for a in b))
                            for k, b in _bundles(data).items()})


def unpad_factors(data_padded: lm.BAData, data_orig: lm.BAData) -> lm.BAData:
    """Cut every factor bundle back to ``data_orig``'s leading dims (the
    inverse of :func:`pad_factors_for_mesh`)."""
    return data_padded._replace(**{k: type(b)(*(a[:getattr(data_orig, k)[0].shape[0]] for a in b))
                                   for k, b in _bundles(data_padded).items()})


def pad_edges_for_mesh(edges: Sim3Edges, n_ranks: int) -> Sim3Edges:
    """Pad the edge bundle's leading axis to a multiple of ``n_ranks``."""
    n = _padded(edges.i.shape[0], n_ranks)
    return Sim3Edges(*(_pad_rows(a, n) for a in edges))


def _slice(bundle, r: int, k: int):
    n = bundle[0].shape[0]
    if n % k:
        raise ValueError(f"a factor axis of {n} does not split over {k} ranks: pad it first")
    return type(bundle)(*(a[r * n // k:(r + 1) * n // k] for a in bundle))


def shard_factors(data: lm.BAData, r: int, k: int) -> lm.BAData:
    """Rank ``r``'s contiguous slice of every factor bundle of ``k``."""
    return data._replace(**{key: _slice(b, r, k) for key, b in _bundles(data).items()})


def all_reduce_sum(tensors, group=None):
    """The tensors summed over the group's ranks, in one all-reduce of one
    flat buffer.  Returns new tensors of the same shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    ALLREDUCE["calls"] += 1
    ALLREDUCE["bytes"] += flat.numel() * flat.element_size()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def distributed_lm_iterations(state: lm.BAState, data: lm.BAData, w: lm.BAWeights, n_iters: int = 5,
                              lam0: float = 1e-4, group=None):
    """LM iterations with factor-sharded assembly and all-reduced normal
    equations: ``lm.lm_iterations`` on this rank's slice of the factors,
    with the sums over the ranks.  The factor bundles' leading dims must
    divide by the group's size (:func:`pad_factors_for_mesh`).  Like the
    local solve, it rejects a trial with a non-finite variable.  Returns
    (state, chi2 of each iteration's trial step)."""
    group = group or mesh.default_group()
    shard = shard_factors(data, mesh.rank(group), mesh.world_size(group))
    return lm.lm_iterations(state, shard, w, n_iters, lam0, reduce=lambda xs: all_reduce_sum(xs, group))


def distributed_local_ba(state: lm.BAState, data: lm.BAData, w: lm.BAWeights, phase1_iters: int = 5,
                         phase2_iters: int = 10, group=None):
    """Two-phase local BA across the ranks, the twin of ``lm.local_ba``:
    optimize, gate outliers, optimize again, gate again.  The gates run on
    every rank over the whole replicated problem (a masked residual pass,
    small next to assembly).  Returns (state, data, phase-2 chi2s)."""
    state, _ = distributed_lm_iterations(state, data, w, phase1_iters, group=group)
    data = lm.gate_observations(state, data, w)
    state, chi2s = distributed_lm_iterations(state, data, w, phase2_iters, group=group)
    return state, lm.gate_observations(state, data, w), chi2s


def distributed_essential_graph(S, fixed, edges: Sim3Edges, n_iters: int = 20, lam: float = 1e-6, group=None):
    """Edge-sharded Sim3 pose-graph optimization, the twin of
    ``posegraph.optimize_essential_graph``: each rank linearizes its slice of
    the edges (pad them with :func:`pad_edges_for_mesh` first), one
    all-reduce of H, b and the cost per Gauss-Newton iteration, and the
    dense solve replicated.  Returns (S_opt, cost before each iteration)."""
    group = group or mesh.default_group()
    e = _slice(edges, mesh.rank(group), mesh.world_size(group))
    K = S.shape[0]
    free = (~fixed).to(S.dtype).repeat_interleave(7)
    costs = []
    for _ in range(n_iters):
        H, b, cost = all_reduce_sum(list(assemble_sim3_system(S, e, 7 * K)), group)
        S = solve_sim3_step(S, H, b, free, lam)
        costs.append(cost)
    return S, torch.stack(costs)
