"""Parity of the port's distributed BA (tpuslam_torch.dist: ``mesh``,
``ba``, ``shard`` and the dispatch of ``backend/local_ba``) with the JAX
package, on the CPU.

The port's collectives run in two OS processes joined into a gloo group
through a ``file://`` rendezvous under the test's temporary directory
(``tests/_torch_dist_worker.py``; one group for the whole file).  The
reference runs on the suite's 8-device virtual CPU mesh.  Tolerances are
``tests/test_dist.py``'s and ``tests/test_shard.py``'s: chi2 rtol 2e-3,
poses atol 2e-4 (1e-3 on the clustered layout), points atol 2e-3, the
Sim3 vertices atol 1e-4; ``run_local_ba`` and ``run_global_ba`` against the
port's single solve of the same map within 2e-3.  A sharded sum adds in
another order than the single solve, so these are tolerances, not
equalities; the two ranks' results are equal bit for bit.  Padding,
clustering and the cluster reorder are exact.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_scene  # noqa: F401  (caps torch's threads)
from __graft_entry__ import _small_problem
from test_global_ba import CAM, NKF, build
from tpuslam.backend import posegraph as jpg
from tpuslam.core import geometry as jgeo
from tpuslam.dist import ba as jdba
from tpuslam.dist import shard as jshard
from tpuslam.graph import lm as jlm
from tpuslam_torch.backend import local_ba as tba
from tpuslam_torch.backend import posegraph as tpg
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.dist import ba as tdba
from tpuslam_torch.dist import mesh as tmesh
from tpuslam_torch.dist import shard as tshard
from tpuslam_torch.graph import lm as tlm
from tpuslam_torch.map import mapstate as tms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
TCAM = Camera.make(CAM.fx, CAM.fy, CAM.cx, CAM.cy, "cpu", width=CAM.width, height=CAM.height)


def _port_problem(state, data):
    st = tlm.ba_state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")
    fields = {k: np.asarray(getattr(data, k)) for k in
              ("pose_fixed", "point_active", "plane_active", "cuboid_active", "fx", "fy", "cx", "cy", "bf")}
    fields["mono"] = {k: np.asarray(v) for k, v in data.mono._asdict().items()}
    fields["cuboid_fix_scale"] = data.cuboid_fix_scale
    return st, tlm.ba_data_from_numpy(fields, "cpu")


def _mesh8():
    return Mesh(np.array(jax.devices()[:8]), axis_names=("dp",))


def _chain_graph():
    """``tests/test_dist.py:49-84``'s graph: a noisy chain of 12 Sim3 poses
    with a loop edge back to the start."""
    rng = np.random.RandomState(0)
    K = 12
    S_gt = [jnp.eye(4)]
    for _ in range(1, K):
        d = jnp.asarray(np.r_[rng.randn(3) * 0.05, rng.randn(3) * 0.3, 0.0].astype(np.float32))
        S_gt.append(jgeo.sim3_exp(d) @ S_gt[-1])
    S_gt = jnp.stack(S_gt)
    noise = [jnp.eye(4)]
    for _ in range(1, K):
        d = jnp.asarray(np.r_[rng.randn(3) * 0.01, rng.randn(3) * 0.05, rng.randn(1) * 0.01].astype(np.float32))
        noise.append(jgeo.sim3_exp(d))
    S0 = jnp.stack([n @ s for n, s in zip(noise, S_gt)])
    ii = list(range(K - 1)) + [0]
    jj = list(range(1, K)) + [K - 1]
    meas = jnp.stack([S_gt[j] @ jgeo.sim3_inv(S_gt[i]) for i, j in zip(ii, jj)])
    edges = jpg.Sim3Edges(i=jnp.asarray(ii, jnp.int32), j=jnp.asarray(jj, jnp.int32), meas=meas,
                          weight=jnp.ones(len(ii)), valid=jnp.ones(len(ii), bool))
    fixed = jnp.zeros(K, bool).at[0].set(True)
    return S0, fixed, edges


def _port_edges(e):
    return tpg.Sim3Edges(*(torch.from_numpy(np.array(a)) for a in e))


def _covisibility(data, K, P):
    kf, pt, val = (np.asarray(x) for x in (data.mono.kf, data.mono.pt, data.mono.valid))
    inc = np.zeros((K, P))
    inc[kf[val], pt[val]] = 1
    return inc @ inc.T


def _tcfg(cfg_j):
    c = cfg_j.caps
    caps = tcfg.Capacities(**{k: getattr(c, k) for k in tcfg.Capacities.__dataclass_fields__})
    return tcfg.SlamConfig(caps=caps)


@pytest.fixture(scope="module")
def problems():
    lm_p = _small_problem(n_kf=4, n_pts=256, n_factors=1024)
    cl_p = _small_problem(n_kf=8, n_pts=256, n_factors=1024)
    cov = _covisibility(cl_p[1], 8, 256)
    cl = jshard.cluster_keyframes(cov, np.ones(8, bool), 8)
    cfg, m, _, _ = build()
    return {"lm": lm_p, "clustered": cl_p, "clusters": cl, "graph": _chain_graph(), "map": (cfg, m)}


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    """Both ranks' results (``tests/_torch_dist_worker.py``), and the cases."""
    work = tmp_path_factory.mktemp("dist")
    st, d = _port_problem(*problems["lm"][:2])
    st8, d8 = _port_problem(*problems["clustered"][:2])
    S0, fixed, edges = problems["graph"]
    cfg_j, m = problems["map"]
    cases = {
        "lm": (st, d, tlm.BAWeights()),
        "clustered": (st8, tshard.partition_data(d8, problems["clusters"], 8), tlm.BAWeights()),
        "essential_graph": (torch.from_numpy(np.array(S0)), torch.from_numpy(np.array(fixed)),
                            _port_edges(edges)),
        "map": ({k: np.asarray(getattr(m, k)) for k in m._fields}, TCAM, _tcfg(cfg_j), 100, NKF),
    }
    torch.save(cases, work / "cases.pt")
    init = f"file://{work / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", init, str(work / "cases.pt"), str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)], cases


# --- padding, clustering, partitioning: exact ------------------------------------


@pytest.mark.parametrize("n", [2, 3, 8])
def test_pad_factors_for_mesh_matches_reference(problems, n):
    state, data, _ = problems["lm"]
    data = data._replace(mono=data.mono._replace(
        **{k: v[:1021] for k, v in data.mono._asdict().items()}))  # not a multiple of n
    ref = jdba.pad_factors_for_mesh(data, n)
    got = tdba.pad_factors_for_mesh(_port_problem(state, data)[1], n)
    for k in tlm.MonoFactors._fields:
        np.testing.assert_array_equal(getattr(got.mono, k).numpy(), np.asarray(getattr(ref.mono, k)), err_msg=k)
    assert got.mono.kf.shape[0] % n == 0


def test_unpad_factors_inverts_the_padding(problems):
    state, data, _ = problems["lm"]
    data = data._replace(mono=data.mono._replace(**{k: v[:1021] for k, v in data.mono._asdict().items()}))
    _, d = _port_problem(state, data)
    got = tdba.unpad_factors(tdba.pad_factors_for_mesh(d, 8), d)
    ref = jdba.unpad_factors(jdba.pad_factors_for_mesh(data, 8), data)
    for k in tlm.MonoFactors._fields:
        assert torch.equal(getattr(got.mono, k), getattr(d.mono, k))
        np.testing.assert_array_equal(getattr(got.mono, k).numpy(), np.asarray(getattr(ref.mono, k)))


@pytest.mark.parametrize("n", [2, 5, 8])
def test_pad_edges_for_mesh_matches_reference(problems, n):
    _, _, edges = problems["graph"]
    ref = jdba.pad_edges_for_mesh(edges, n)
    got = tdba.pad_edges_for_mesh(_port_edges(edges), n)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _blobs():
    K = 12
    cov = np.zeros((K, K))
    for blob in (range(0, 6), range(6, 12)):
        for i in blob:
            for j in blob:
                if i != j:
                    cov[i, j] = 50
    cov[5, 6] = cov[6, 5] = 2
    return cov, np.ones(K, bool), 2


@pytest.mark.parametrize("case", ["blobs", "invalid_excluded", "random"])
def test_cluster_keyframes_matches_reference(case):
    """``tests/test_shard.py``'s two cases and a random weighted graph."""
    if case == "blobs":
        cov, valid, n = _blobs()
    elif case == "invalid_excluded":
        cov, valid, n = np.ones((6, 6)), np.array([True, True, True, False, False, False]), 2
    else:
        rng = np.random.RandomState(4)
        cov = rng.randint(0, 40, (20, 20)).astype(float)
        cov = cov + cov.T
        valid, n = rng.rand(20) > 0.2, 3
    got = tshard.cluster_keyframes(cov, valid, n)
    np.testing.assert_array_equal(got, jshard.cluster_keyframes(cov, valid, n))
    assert got.dtype == np.int32


@pytest.mark.parametrize("n_clusters", [2, 8])
def test_partition_data_matches_reference_field_for_field(problems, n_clusters):
    state, data, _ = problems["clustered"]
    cl = jshard.cluster_keyframes(_covisibility(data, 8, 256), np.ones(8, bool), n_clusters)
    ref = jshard.partition_data(data, cl, n_clusters)
    got = tshard.partition_data(_port_problem(state, data)[1], cl, n_clusters)
    for k in tlm.MonoFactors._fields:
        np.testing.assert_array_equal(getattr(got.mono, k).numpy(), np.asarray(getattr(ref.mono, k)), err_msg=k)
    assert int(got.mono.valid.sum()) == int(np.asarray(data.mono.valid).sum())
    assert got.mono.kf.shape[0] % n_clusters == 0


def test_spread_bundle_matches_reference():
    """The landmark-only bundles (point-cuboid, cuboid-plane) go round-robin."""
    rng = np.random.RandomState(1)
    n = 5
    fields = {"cub": rng.randint(0, 3, n).astype(np.int32), "pts": rng.randint(0, 9, (n, 4)).astype(np.int32),
              "pts_mask": rng.rand(n, 4).astype(np.float32), "weight": rng.rand(n).astype(np.float32),
              "valid": rng.rand(n) > 0.3}
    ref = jshard._spread_bundle(jlm.PointCuboidFactors(**{k: jnp.asarray(v) for k, v in fields.items()}), 3)
    got = tshard._spread_bundle(tlm.PointCuboidFactors(**{k: torch.from_numpy(v) for k, v in fields.items()}), 3)
    for k in tlm.PointCuboidFactors._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)


# --- the process-group helpers and the dispatch, without a group -------------------


def test_mesh_helpers_without_a_process_group():
    assert tmesh.default_group() is None
    assert (tmesh.world_size(), tmesh.rank(), tmesh.mesh_size(), tmesh.make_group()) == (1, 0, 1, None)
    assert tmesh.backend_for("cpu") == "gloo" and tmesh.backend_for("cuda:0") == "nccl"


@pytest.mark.parametrize("flag, force", [(True, None), (True, "1"), (False, None)])
def test_use_distributed_ba_needs_more_than_one_rank(monkeypatch, flag, force):
    """Without a process group of two or more ranks the local solve runs,
    whatever the flag and ``TPUSLAM_FORCE_LOCAL_BA`` say."""
    if force is None:
        monkeypatch.delenv("TPUSLAM_FORCE_LOCAL_BA", raising=False)
    else:
        monkeypatch.setenv("TPUSLAM_FORCE_LOCAL_BA", force)
    cfg = tcfg.SlamConfig().replace(flags=tcfg.FeatureFlags(distributed_ba=flag))
    assert tba.use_distributed_ba(cfg) is False


# --- two gloo ranks ------------------------------------------------------------------


def test_ranks_agree_bit_for_bit(ranks):
    (r0, r1), _ = ranks
    assert (r0["rank"], r1["rank"], r0["world"], r1["world"]) == (0, 1, 2, 2)
    def leaves(x):
        return [y for v in x for y in leaves(v)] if isinstance(x, tuple) else [x]

    for key in ("lm", "clustered", "essential_graph", "nonfinite", "local_ba", "global_ba"):
        for a, b in zip(leaves(r0[key]), leaves(r1[key])):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, key


def test_distributed_lm_matches_the_single_solve(ranks):
    (r0, _), cases = ranks
    st, d, w = cases["lm"]
    s1, c1 = tlm.lm_iterations(st, d, w, 3)
    s2, c2 = r0["lm"]
    np.testing.assert_allclose(c2.numpy(), c1.numpy(), rtol=2e-3)
    np.testing.assert_allclose(s2.poses.numpy(), s1.poses.numpy(), atol=2e-4)
    np.testing.assert_allclose(s2.points.numpy(), s1.points.numpy(), atol=2e-3)


def test_distributed_lm_matches_the_reference_mesh(ranks, problems):
    (r0, _), _ = ranks
    state, data, w = problems["lm"]
    s8, c8 = jdba.distributed_lm_iterations(_mesh8(), state, jdba.pad_factors_for_mesh(data, 8), w, n_iters=3)
    s2, c2 = r0["lm"]
    np.testing.assert_allclose(c2.numpy(), np.asarray(c8), rtol=2e-3)
    np.testing.assert_allclose(s2.poses.numpy(), np.asarray(s8.poses), atol=2e-4)
    np.testing.assert_allclose(s2.points.numpy(), np.asarray(s8.points), atol=2e-3)


def test_clustered_distributed_lm_matches_single_and_reference(ranks, problems):
    """``tests/test_shard.py:47``: the 8-cluster layout split over 2 ranks
    (4 clusters each) against the single solve and the reference's 8-device
    run of the same layout."""
    (r0, _), cases = ranks
    state, data, w = problems["clustered"]
    st8, d8 = _port_problem(state, data)
    s1, c1 = tlm.lm_iterations(st8, d8, tlm.BAWeights(), 3)
    s8, c8 = jdba.distributed_lm_iterations(_mesh8(), state, jshard.partition_data(data, problems["clusters"], 8),
                                            w, n_iters=3)
    s2, c2 = r0["clustered"]
    for s_ref, c_ref in ((s1.poses.numpy(), c1.numpy()), (np.asarray(s8.poses), np.asarray(c8))):
        np.testing.assert_allclose(c2.numpy(), c_ref, rtol=2e-3)
        np.testing.assert_allclose(s2.poses.numpy(), s_ref, atol=1e-3)


def test_distributed_essential_graph_matches_single_and_reference(ranks, problems):
    (r0, _), cases = ranks
    S0, fixed, edges = problems["graph"]
    S8, _ = jdba.distributed_essential_graph(_mesh8(), S0, fixed, jdba.pad_edges_for_mesh(edges, 8), n_iters=10)
    S1, _ = tpg.optimize_essential_graph(*cases["essential_graph"], n_iters=10)
    S2, c2 = r0["essential_graph"]
    np.testing.assert_allclose(S2.numpy(), S1.numpy(), atol=1e-4)
    np.testing.assert_allclose(S2.numpy(), np.asarray(S8), atol=1e-4)
    assert float(c2[-1]) < 1e-6


def test_distributed_lm_rejects_a_non_finite_trial(ranks):
    """The port's departure (``lm.lm_iterations`` rejects a trial with a
    non-finite variable) holds on the distributed path too."""
    (r0, _), cases = ranks
    st, _, _ = cases["lm"]
    s, c = r0["nonfinite"]
    assert all(torch.equal(a, b) for a, b in zip(s, st))
    assert c.shape == (1,)


def test_run_local_ba_takes_distributed_path_and_matches(ranks):
    (r0, _), cases = ranks
    fields, cam, cfg, center, _ = cases["map"]
    assert r0["uses_distributed"]
    pose, pts, kf_pt, chi2, calls = r0["local_ba"]
    assert calls == 2 * (5 + 10), calls  # one round per iteration and one per trial chi2, both phases
    m1, chi2_1 = tba.run_local_ba(tms.map_from_numpy(fields, "cpu"), center, cam, cfg)
    np.testing.assert_allclose(pose.numpy(), m1.kf_pose.numpy(), atol=2e-3)
    np.testing.assert_allclose(pts.numpy(), m1.pt_pos.numpy(), atol=2e-3)
    np.testing.assert_array_equal(kf_pt.numpy(), m1.kf_pt.numpy())
    np.testing.assert_allclose(chi2.numpy(), chi2_1.numpy(), rtol=2e-3)
    assert float(chi2[-1]) <= float(chi2[0])


def test_run_global_ba_takes_distributed_path_unchunked_and_matches(ranks):
    """The distributed global BA is chosen before the chunked
    ``should_abort`` path: all 5 iterations run, the poll never asked."""
    (r0, _), cases = ranks
    fields, cam, cfg, _, n_kf = cases["map"]
    pose, pts, chi2, calls, polls = r0["global_ba"]
    assert calls == 2 * 5 and polls == 0 and chi2.shape == (5,)
    m1, chi2_1 = tba.run_global_ba(tms.map_from_numpy(fields, "cpu"), cam, cfg, n_iters=5, n_kf=n_kf)
    np.testing.assert_allclose(pose.numpy(), m1.kf_pose.numpy(), atol=2e-3)
    np.testing.assert_allclose(chi2.numpy(), chi2_1.numpy(), rtol=2e-3)
