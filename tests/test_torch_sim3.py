"""Parity of the port's Sim3 math (tpuslam_torch.core.geometry), Sim3
solvers (tpuslam_torch.backend.sim3solver) and essential graph
(tpuslam_torch.backend.posegraph) with the JAX package, on the CPU.

Inputs are made with numpy from a seed; the RANSAC gets the reference's own
``jax.random`` draw.  Tolerances (float32 in both packages, sums in another
order): the Sim3 functions 2e-5 absolute on tangents near zero and 2e-5
relative elsewhere; Horn and the RANSAC winner 1e-4, inlier sets equal;
the Gauss-Newton refinement and the essential graph 2e-4 on the poses,
the normal equations 1e-3 relative to their largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_loop_scene import jax_draw, t, torch_draw
from tpuslam.backend import posegraph as jpg
from tpuslam.backend import sim3solver as jss
from tpuslam.core import geometry as jgeo
from tpuslam_torch.backend import posegraph as tpg
from tpuslam_torch.backend import sim3solver as tss
from tpuslam_torch.core import geometry as tgeo

K_NP = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def _sim3_tangents(n=48, seed=0):
    """(n, 7) tangents: generic ones, then the branches of _sim3_W: omega
    zero or ~1e-7 (below its 1e-5 switch), sigma zero or ~1e-7, both, and
    values just either side of the switch."""
    rng = np.random.RandomState(seed)
    xi = rng.normal(0.0, 0.5, (n, 7)).astype(np.float32)
    xi[0:4, :3] = 0.0
    xi[4:8, :3] *= 1e-7
    xi[8:12, 6] = 0.0
    xi[12:16, 6] = 1e-7
    xi[16:20, :3] = 0.0
    xi[16:20, 6] = 0.0
    xi[20:22, :3] = [2e-5, 0.0, 0.0]
    xi[22:24, 6] = 2e-5
    return xi


def test_sim3_functions_match_reference():
    xi = _sim3_tangents()
    S_j = jgeo.sim3_exp(jnp.asarray(xi))
    S_t = tgeo.sim3_exp(t(xi))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=2e-5, atol=2e-6)
    W_j = jgeo._sim3_W(jnp.asarray(xi[:, :3]), jnp.asarray(xi[:, 6]))
    np.testing.assert_allclose(tgeo._sim3_W(t(xi[:, :3]), t(xi[:, 6])).numpy(), np.asarray(W_j), rtol=2e-5,
                               atol=2e-6)
    S = np.asarray(S_j)
    np.testing.assert_allclose(tgeo.sim3_log(t(S)).numpy(), np.asarray(jgeo.sim3_log(jnp.asarray(S))), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tgeo.sim3_inv(t(S)).numpy(), np.asarray(jgeo.sim3_inv(jnp.asarray(S))), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(tgeo.sim3_scale(t(S)).numpy(), np.asarray(jgeo.sim3_scale(jnp.asarray(S))),
                               rtol=2e-6)
    np.testing.assert_allclose(tgeo.sim3_R(t(S)).numpy(), np.asarray(jgeo.sim3_R(jnp.asarray(S))), atol=2e-6)
    p = np.random.RandomState(1).normal(0, 3, (48, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeo.sim3_apply(t(S), t(p)).numpy(),
                               np.asarray(jgeo.sim3_apply(jnp.asarray(S), jnp.asarray(p))), rtol=2e-5, atol=2e-5)
    s, R, tt = np.exp(xi[:, 6]), np.asarray(jgeo.so3_exp(jnp.asarray(xi[:, :3]))), xi[:, 3:6]
    np.testing.assert_allclose(tgeo.sim3_from_sRt(t(s), t(R), t(tt)).numpy(),
                               np.asarray(jgeo.sim3_from_sRt(jnp.asarray(s), jnp.asarray(R), jnp.asarray(tt))),
                               rtol=1e-6)
    T = tgeo.se3_identity((3,))
    np.testing.assert_array_equal(T.numpy(), np.asarray(jgeo.se3_identity((3,))))
    np.testing.assert_array_equal(tgeo.se3_R(t(S)).numpy(), np.asarray(jgeo.se3_R(jnp.asarray(S))))
    np.testing.assert_array_equal(tgeo.se3_t(t(S)).numpy(), np.asarray(jgeo.se3_t(jnp.asarray(S))))
    # the round trip at zero and near zero (rows up to 22); just above the
    # 1e-5 switch (rows 22-23) the generic (s - 1) / sigma cancels in float32
    # in both packages
    np.testing.assert_allclose(tgeo.sim3_log(S_t)[:22].numpy(), xi[:22], atol=2e-5, rtol=2e-4)


def _sim3_pair(seed=1, n=100, n_bad=20):
    """tests/test_loop.py:30's matched point sets: a known Sim3, 20% of P1
    corrupted, their pixels."""
    rng = np.random.RandomState(seed)
    P2 = rng.uniform(-2, 2, (n, 3)).astype(np.float32) + np.array([0, 0, 6], np.float32)
    R = np.asarray(jgeo.so3_exp(jnp.array([0.1, -0.2, 0.3])))
    P1 = (1.3 * (P2 @ R.T) + np.array([0.5, -0.3, 0.8], np.float32)).astype(np.float32)
    P1[:n_bad] += (rng.randn(n_bad, 3) * 2.0).astype(np.float32)

    def proj(P):
        return np.stack([500 * P[:, 0] / P[:, 2] + 320, 500 * P[:, 1] / P[:, 2] + 240], -1).astype(np.float32)

    return P1, P2, proj(P1), proj(P2)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_alignment_matches_reference(fix_scale):
    P1, P2, _, _ = _sim3_pair()
    out_j = jss.horn_alignment(jnp.asarray(P1[20:]), jnp.asarray(P2[20:]), fix_scale)
    out_t = tss.horn_alignment(t(P1[20:]), t(P2[20:]), fix_scale)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_solve_sim3_matches_reference_with_its_draw(fix_scale):
    P1, P2, uv1, uv2 = _sim3_pair()
    valid = np.ones(100, bool)
    valid[90:] = False
    res_j = jss.solve_sim3(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(valid), jnp.asarray(uv1),
                           jnp.asarray(uv2), jnp.asarray(K_NP), __import__("jax").random.PRNGKey(0),
                           n_iters=300, fix_scale=fix_scale)
    res_t = tss.solve_sim3(t(P1), t(P2), t(valid), t(uv1), t(uv2), t(K_NP), torch_draw(t(valid), 0, 300, 3),
                           fix_scale=fix_scale)
    assert bool(res_t.ok) == bool(res_j.ok)
    assert int(res_t.n_inliers) == int(res_j.n_inliers)
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    for key in ("s", "R", "t"):
        np.testing.assert_allclose(getattr(res_t, key).numpy(), np.asarray(getattr(res_j, key)), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    if not fix_scale:
        assert bool(res_t.ok) and abs(float(res_t.s) - 1.3) < 0.02


def test_ransac_samples_draw_distinct_valid_indices():
    """The port's draw: distinct valid indices per iteration, the
    reference's own."""
    from tpuslam_torch.frontend.initializer import ransac_samples

    valid = torch.from_numpy(np.random.RandomState(0).rand(64) > 0.3)
    s = ransac_samples(valid, 11, n_iters=300, n_pick=3)
    assert s.shape == (300, 3)
    assert bool(valid[s].all())
    assert all(len(set(row.tolist())) == 3 for row in s)
    np.testing.assert_array_equal(s.numpy(), jax_draw(valid.numpy(), 11, 300, 3))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_reference(fix_scale):
    """tests/test_loop.py:109's refinement: a known Sim3, noisy pixels, 10
    planted outliers, a perturbed start."""
    rng = np.random.RandomState(0)
    N = 120
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)
    xi = np.array([0.05, -0.08, 0.03, 0.2, -0.1, 0.15, 0.1], np.float32)
    S_gt = np.asarray(jgeo.sim3_exp(jnp.asarray(xi)))
    P2 = rng.uniform([-2, -2, 3], [2, 2, 8], (N, 3)).astype(np.float32)
    P1 = np.asarray(jgeo.sim3_apply(jnp.asarray(S_gt), jnp.asarray(P2)))

    def proj(p):
        return np.stack([400.0 * p[:, 0] / p[:, 2] + 320, 400.0 * p[:, 1] / p[:, 2] + 240], -1)

    uv1 = (proj(P1) + rng.randn(N, 2) * 0.3).astype(np.float32)
    uv2 = (proj(P2) + rng.randn(N, 2) * 0.3).astype(np.float32)
    uv1[:10] += 40.0
    valid = np.ones(N, bool)
    S0 = np.asarray(jgeo.sim3_exp(jnp.asarray(xi + np.array([0.02, 0.01, -0.02, 0.1, 0.05, -0.08, 0.05],
                                                              np.float32))))
    S_j, inl_j, n_j = jss.optimize_sim3(*(jnp.asarray(a) for a in (S0, P1, P2, uv1, uv2, K, valid)),
                                        fix_scale=fix_scale)
    S_t, inl_t, n_t = tss.optimize_sim3(*(t(a) for a in (S0, P1, P2, uv1, uv2, K, valid)), fix_scale=fix_scale)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= 100


def _drifted_loop(n=20):
    """tests/test_loop.py:53's pose graph: 20 poses around a circle with
    drifted odometry edges and one true loop edge from the last to the first."""
    gt = []
    for i in range(n):
        a = 2 * np.pi * i / n
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = np.asarray(jgeo.so3_exp(jnp.array([0.0, a, 0.0])))
        T_wc[:3, 3] = [np.sin(a) * 3, 0.0, 3 - np.cos(a) * 3]
        gt.append(np.linalg.inv(T_wc))
    gt = np.stack(gt).astype(np.float32)
    rng = np.random.RandomState(2)
    est, rels = [gt[0]], []
    for i in range(1, n):
        rel = np.asarray(jnp.asarray(gt[i]) @ jgeo.se3_inv(jnp.asarray(gt[i - 1])))
        noise = np.asarray(jgeo.se3_exp(jnp.asarray(rng.randn(6).astype(np.float32) * 0.01)))
        rels.append(noise @ rel)
        est.append(rels[-1] @ est[-1])
    meas = rels + [np.asarray(jnp.asarray(gt[0]) @ jgeo.se3_inv(jnp.asarray(gt[n - 1])))]
    ii = np.array(list(range(n - 1)) + [n - 1], np.int32)
    jj = np.array(list(range(1, n)) + [0], np.int32)
    weight = np.ones(n, np.float32)
    weight[n - 1] = 5.0
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return np.stack(est).astype(np.float32), ii, jj, np.stack(meas).astype(np.float32), weight, fixed


def _edges(mod, conv, ii, jj, meas, weight):
    return mod.Sim3Edges(i=conv(ii), j=conv(jj), meas=conv(meas), weight=conv(weight),
                         valid=conv(np.ones(len(ii), bool)))


def test_pose_graph_matches_reference_on_the_drifted_loop():
    est, ii, jj, meas, weight, fixed = _drifted_loop()
    n = len(est)
    e_j = _edges(jpg, jnp.asarray, ii, jj, meas, weight)
    e_t = _edges(tpg, t, ii, jj, meas, weight)
    H_j, b_j, c_j = jpg.assemble_sim3_system(jnp.asarray(est), e_j, 7 * n)
    H_t, b_t, c_t = tpg.assemble_sim3_system(t(est), e_t, 7 * n)
    scale = float(np.abs(np.asarray(H_j)).max())
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), atol=1e-3 * scale)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-3 * float(np.abs(np.asarray(b_j)).max()))
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-3)
    # the per-edge residual and the solve
    np.testing.assert_allclose(tpg.edge_residual(t(est[-1]), t(est[0]), t(meas[-1])).numpy(),
                               np.asarray(jpg.edge_residual(*(jnp.asarray(a) for a in (est[-1], est[0], meas[-1])))),
                               atol=2e-5)
    S_j, costs_j = jpg.optimize_essential_graph(jnp.asarray(est), jnp.asarray(fixed), e_j, n_iters=25)
    S_t, costs_t = tpg.optimize_essential_graph(t(est), t(fixed), e_t, n_iters=25)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=2e-4)
    np.testing.assert_allclose(costs_t.numpy(), np.asarray(costs_j), rtol=1e-2, atol=1e-6)
    np.testing.assert_array_equal(S_t[0].numpy(), est[0])  # the fixed vertex stays
    before = float(np.linalg.norm(np.asarray(jpg.edge_residual(*(jnp.asarray(a) for a in (est[-1], est[0],
                                                                                          meas[-1]))))))
    after = float(torch.linalg.vector_norm(tpg.edge_residual(S_t[-1], S_t[0], t(meas[-1]))))
    assert after < 0.1 * before, (before, after)


def test_sim3_to_se3_and_point_correction_match_reference():
    xi = _sim3_tangents(16, seed=3)
    S_old = np.asarray(jgeo.sim3_exp(jnp.asarray(xi)))
    S_new = np.asarray(jgeo.sim3_exp(jnp.asarray(xi * 0.7)))
    rng = np.random.RandomState(4)
    pts = rng.normal(0, 4, (64, 3)).astype(np.float32)
    first = rng.randint(0, 16, 64).astype(np.int32)
    np.testing.assert_allclose(tpg.sim3_to_se3(t(S_old)).numpy(), np.asarray(jpg.sim3_to_se3(jnp.asarray(S_old))),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(tpg.se3_to_sim3(t(S_old)).numpy(), S_old)
    want = jpg.correct_points_for_sim3(jnp.asarray(pts), jnp.asarray(first), jnp.asarray(S_old), jnp.asarray(S_new))
    got = tpg.correct_points_for_sim3(t(pts), t(first), t(S_old), t(S_new))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
