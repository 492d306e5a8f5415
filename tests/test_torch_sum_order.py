"""Float sums in a fixed order (ROADMAP, ground rules).

* The essential graph (``backend/posegraph.py``) solved three times with
  torch's CPU pool at 4 threads, on graphs of 256 and 512 slots with four
  valid edges per slot, large enough that a scatter of its normal
  equations runs on several threads: the results must be equal bit for
  bit, as the reference's are.
* Every scatter-add in ``tpuslam_torch/`` (``index_add``, ``index_add_``,
  ``index_put`` / ``index_put_`` with ``accumulate=True``, ``scatter_add``
  and ``scatter_add_``), found by AST with the function around it, must
  stand in the allowlist below with its reason: a float scatter-add sums in
  no fixed order on one device or the other (``graph/lm.py:_sum_at``), so
  a new one fails here until someone shows why its order does not matter.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import tpuslam_torch
from tpuslam_torch.backend import posegraph as tpg
from tpuslam_torch.core import geometry as geo

SCATTERS = {"index_add", "index_add_", "index_put", "index_put_", "scatter_add", "scatter_add_"}

# (module, enclosing function, method) -> why its order does not matter
ALLOWED = {
    ("graph/lm.py", "_sum_at", "index_put"): "the fixed-order sum itself: sorted runs on the card",
    ("graph/lm.py", "_sum_at", "index_add"): "the fixed-order sum itself: serial on the CPU",
    ("graph/lm.py", "_pose_sums", "index_add"): "the CPU branch only (lane order, serial there); the card's "
                                                "branch is a batched einsum",
    ("place/vocab.py", "train_kmeans", "index_add"): "sums of +-1 bits and of ones: exact in float32",
    ("place/vocab.py", "bow_vector", "index_add"): "a histogram of ones: exact in float32",
    ("frontend/tracking.py", "_count", "index_add"): "int32 counts",
    ("backend/mapping.py", "fuse_into_keyframe", "index_add"): "int32 counters",
    ("kernels/match.py", "rotation_consistency", "index_add"): "int32 counts",
    ("kernels/planes.py", "hough_votes", "index_add_"): "int32 votes",
    ("semantic/associate.py", "associate_planes", "index_add"): "int32 counts",
    ("semantic/associate.py", "cuboid_point_votes", "index_add"): "int32 counts",
    ("semantic/associate.py", "associate_cuboids", "index_add"): "int32 counts",
    ("map/mapstate.py", "incidence", "index_put"): "a sum of ones: exact in float32",
    ("map/mapstate.py", "keyframe_redundancy", "index_add"): "a histogram of ones: exact in float32",
    ("io/synth.py", "forward", "index_add_"): "int64 pixel counts, and float64 face sums that give only the "
                                              "plane rows' centroid column, which no caller reads",
}


def _scatter_calls():
    """{(module, enclosing function, method)} of every scatter-add call."""
    root = pathlib.Path(tpuslam_torch.__file__).parent
    found = set()
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        rel = path.relative_to(root).as_posix()

        def visit(node, fn):
            for child in ast.iter_child_nodes(node):
                name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
                if (isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute)
                        and child.func.attr in SCATTERS):
                    meth = child.func.attr
                    accumulate = any(k.arg == "accumulate" and not (isinstance(k.value, ast.Constant)
                                                                    and k.value.value is False)
                                     for k in child.keywords)
                    if not meth.startswith("index_put") or accumulate:
                        found.add((rel, fn, meth))
                visit(child, name)

        visit(tree, "<module>")
    return found


def test_every_scatter_add_in_the_port_is_allowlisted_with_its_reason():
    found = _scatter_calls()
    assert found - set(ALLOWED) == set(), "scatter-adds with no reason in ALLOWED (a float sum in no fixed order?)"
    assert set(ALLOWED) - found == set(), "ALLOWED names scatter-adds the port no longer has"


def _big_graph(n_slots=512, n_valid=2048, n_edges=2304, seed=0):
    """A drifted Sim3 graph over every slot: ``n_valid`` edges between random
    slot pairs (a chain through all slots among them), the rest invalid."""
    rng = np.random.RandomState(seed)
    xi = rng.normal(0, 0.5, (n_slots, 7)).astype(np.float32)
    xi[:, 6] = rng.normal(0, 0.05, n_slots)
    gt = geo.sim3_exp(torch.from_numpy(xi))
    ii = np.concatenate([np.arange(n_slots - 1), rng.randint(0, n_slots, n_edges - n_slots + 1)])
    jj = np.concatenate([np.arange(1, n_slots), rng.randint(0, n_slots, n_edges - n_slots + 1)])
    jj = np.where(jj == ii, (jj + 1) % n_slots, jj)
    i_t, j_t = torch.from_numpy(ii).to(torch.int32), torch.from_numpy(jj).to(torch.int32)
    meas = gt[j_t.long()] @ geo.sim3_inv(gt[i_t.long()])
    noise = geo.sim3_exp(torch.from_numpy(rng.normal(0, 0.01, (n_edges, 7)).astype(np.float32)))
    valid = torch.from_numpy(np.arange(n_edges) < n_valid)
    edges = tpg.Sim3Edges(i=i_t, j=j_t, meas=noise @ meas, weight=torch.ones(n_edges), valid=valid)
    drift = geo.sim3_exp(torch.from_numpy(rng.normal(0, 0.02, (n_slots, 7)).astype(np.float32)))
    fixed = torch.zeros(n_slots, dtype=torch.bool)
    fixed[0] = True
    return drift @ gt, fixed, edges


@pytest.mark.parametrize("n_slots", [256, 512])
def test_essential_graph_repeats_bit_for_bit_on_four_threads(n_slots):
    S, fixed, edges = _big_graph(n_slots, 4 * n_slots, 4 * n_slots + n_slots // 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [tpg.optimize_essential_graph(S, fixed, edges, n_iters=2) for _ in range(3)]
    finally:
        torch.set_num_threads(threads)
    (S0, c0) = runs[0]
    assert bool(torch.isfinite(S0).all())
    assert float(c0[-1]) < float(c0[0])
    for S1, c1 in runs[1:]:
        assert torch.equal(S0, S1) and torch.equal(c0, c1)
