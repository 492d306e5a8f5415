"""The last functions of the JAX package without a caller, ported and held
to it on the CPU on seeded numpy inputs: ``camera.distort_normalized`` and
``in_image``, ``mapstate.local_window`` and ``replace_point``,
``factors.se3_prior_residual``, ``geometry.R_to_quat`` (which
``io/trajectory.R_to_quat`` now calls), and ``dbow_compat.bow_sparse``'s
float sum in a fixed order.

Tolerances: ``in_image``, ``local_window`` and ``replace_point`` exact (the
window's ids and mask, ties included: ``lax.top_k`` keeps the lower slot
first); ``distort_normalized`` 1e-6 relative (float32, the same
expression); ``R_to_quat`` 2e-7 (``test_torch_synth.py``'s limit for the
numpy twin it replaces); ``se3_prior_residual`` 1e-5 (float32 ``so3_log``
near small angles); ``bow_sparse`` 1e-6 against the reference, and on the
CPU bit for bit against the ``index_add`` it replaced.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_loop_scene as ls
from tpuslam.core import camera as jcam
from tpuslam.core import config as jcfg
from tpuslam.core import geometry as jgeo
from tpuslam.graph import factors as jfac
from tpuslam.map import mapstate as jms
from tpuslam.place import dbow_compat as jdc
from tpuslam_torch.core import camera as tcam
from tpuslam_torch.core import geometry as tgeo
from tpuslam_torch.graph import factors as tfac
from tpuslam_torch.io import trajectory as ttraj
from tpuslam_torch.map import mapstate as tms
from tpuslam_torch.place import dbow_compat as tdc


def _cameras(dist):
    kw = dict(width=320, height=240)
    return (jcam.Camera.make(260.0, 258.0, 159.5, 119.5, dist=dist, **kw),
            tcam.Camera.make(260.0, 258.0, 159.5, 119.5, "cpu", dist=dist, **kw))


@pytest.mark.parametrize("seed", range(3))
def test_distort_normalized_matches_reference(seed):
    rng = np.random.RandomState(seed)
    dist = rng.uniform(-0.3, 0.3, 5).astype(np.float32) * np.array([1, 0.3, 0.01, 0.01, 0.1], np.float32)
    xy = rng.uniform(-0.8, 0.8, (7, 33, 2)).astype(np.float32)
    jc, tc = _cameras(dist)
    ref = np.asarray(jcam.distort_normalized(jc, jnp.asarray(xy)))
    got = tcam.distort_normalized(tc, torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    # undistort_points inverts it (a fixed point of the same model)
    uv = np.stack([xy[..., 0] * 260.0 + 159.5, xy[..., 1] * 258.0 + 119.5], -1)[:1, :4] * 0.25 + 120
    xy0 = np.stack([(uv[..., 0] - 159.5) / 260.0, (uv[..., 1] - 119.5) / 258.0], -1).astype(np.float32)
    xyd = tcam.distort_normalized(tc, torch.from_numpy(xy0))
    uvd = torch.stack([xyd[..., 0] * 260.0 + 159.5, xyd[..., 1] * 258.0 + 119.5], -1)
    np.testing.assert_allclose(tcam.undistort_points(tc, uvd, iters=20).numpy(), uv, atol=1e-2)


@pytest.mark.parametrize("margin", [0.0, 3.0, 10.5])
def test_in_image_matches_reference(margin):
    rng = np.random.RandomState(int(margin * 10))
    uv = rng.uniform(-20, 340, (500, 2)).astype(np.float32)
    edges = np.array([[margin, margin], [320 - margin, 100], [100, 240 - margin], [319.999, 239.999],
                      [margin - 1e-3, 50], [0, 0], [320, 240]], np.float32)
    uv = np.concatenate([uv, edges])
    jc, tc = _cameras(None)
    ref = np.asarray(jcam.in_image(jc, jnp.asarray(uv), margin))
    got = tcam.in_image(tc, torch.from_numpy(uv), margin).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < len(ref)


K, N, P = 16, 48, 256


def _window_map(case: str):
    """A JAX map whose covisibility with keyframe 0 holds ties, an invalid
    keyframe with the best weight, and weights below the 15-point edge."""
    rng = np.random.RandomState({"ties": 0, "random": 1, "few": 2}[case])
    kf_pt = np.full((K, N), -1, np.int32)
    valid = np.ones(K, bool)
    if case == "random":
        for k in range(K):
            n = rng.randint(0, N)
            kf_pt[k, :n] = rng.choice(P, n, replace=False)
        valid[rng.choice(K, 4, replace=False)] = False
        valid[0] = True
    else:
        kf_pt[0, :40] = np.arange(40)
        shared = {1: 20, 2: 20, 3: 20, 4: 30, 5: 10, 6: 30, 7: 20, 9: 16, 12: 15}
        for k, n in shared.items():
            kf_pt[k, :n] = np.arange(n)
            kf_pt[k, n:n + 5] = 100 + 5 * k + np.arange(5)
        valid[[4, 11]] = False  # 4 would come first; 11 observes nothing
        if case == "few":
            valid[[1, 2, 3, 6, 7, 9, 12]] = False
    caps = jcfg.Capacities(max_keypoints=N, max_keyframes=K, max_points=P)
    m = jms.empty_map(caps)
    return m._replace(kf_pt=jnp.asarray(kf_pt), kf_valid=jnp.asarray(valid), pt_valid=jnp.ones(P, bool))


@pytest.mark.parametrize("case,center,max_kfs", [("ties", 0, 6), ("ties", 0, 12), ("ties", 3, 5),
                                                  ("random", 0, 8), ("random", 5, 16), ("few", 0, 6)])
def test_local_window_matches_reference_with_ties_and_invalid_keyframes(case, center, max_kfs):
    m_j = _window_map(case)
    ids_j, mask_j = jms.local_window(m_j, center, max_kfs)
    ids_t, mask_t = tms.local_window(ls.tmap(m_j), center, max_kfs)
    assert ids_t.dtype == torch.int32
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert int(ids_t[0]) == center and bool(mask_t[0])
    if case == "ties" and center == 0:
        # 6 (30 shared) first, then the 20s in slot order; 4 (30, invalid) never
        assert ids_t[:6].tolist() == [0, 6, 1, 2, 3, 7]
        assert 4 not in ids_t[mask_t].tolist()


@pytest.mark.parametrize("old,new", [(3, 7), (0, 255), (42, 42)])
def test_replace_point_matches_reference(old, new):
    rng = np.random.RandomState(old)
    kf_pt = rng.randint(-1, 50, (K, N)).astype(np.int32)
    kf_pt[0, :3] = old
    caps = jcfg.Capacities(max_keypoints=N, max_keyframes=K, max_points=P)
    m_j = jms.empty_map(caps)._replace(kf_pt=jnp.asarray(kf_pt), pt_valid=jnp.ones(P, bool))
    out_j = jms.replace_point(m_j, old, new)
    out_t = tms.replace_point(ls.tmap(m_j), old, new)
    for f in tms.FIELDS:
        np.testing.assert_array_equal(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)), err_msg=f)
    assert not bool(out_t.pt_valid[old])


def _poses(n, seed):
    xi = np.random.RandomState(seed).normal(size=(n, 6)).astype(np.float32)
    return np.array(jgeo.se3_exp(jnp.asarray(xi)))


@pytest.mark.parametrize("scale", [1e-3, 0.3, 1.5])
def test_se3_prior_residual_matches_reference(scale):
    T = _poses(40, 0)
    meas = np.array(jgeo.se3_exp(jnp.asarray(np.random.RandomState(1).normal(size=(40, 6)).astype(np.float32)
                                               * np.float32(scale)))) @ T
    ref = np.asarray(jfac.se3_prior_residual(jnp.asarray(T), jnp.asarray(meas)))
    got = tfac.se3_prior_residual(torch.from_numpy(T), torch.from_numpy(meas)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tfac.se3_prior_residual(torch.from_numpy(T), torch.from_numpy(T)).numpy(), 0,
                               atol=1e-5)


def test_R_to_quat_matches_reference_on_every_branch():
    R = _poses(64, 2)[:, :3, :3]
    # the identity and the three half turns about the axes
    turns = np.stack([np.diag(d).astype(np.float32) for d in ([1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    R = np.concatenate([R, turns])
    ref = np.asarray(jgeo.R_to_quat(jnp.asarray(R)))
    got = tgeo.R_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-7)
    for r, q in zip(R, got):  # the trajectory writer's quaternion is this one
        np.testing.assert_array_equal(ttraj.R_to_quat(r), q)


def _bow_sparse_index_add(words, weights):
    """``bow_sparse`` as it summed before, with ``index_add``."""
    n = words.shape[0]
    order = torch.argsort(torch.where(words >= 0, words, 1 << 30), stable=True)
    w = words[order]
    wt = torch.where(w >= 0, weights[order], 0.0)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool), w[1:] != w[:-1]])
    run_id = torch.cumsum(is_start.to(torch.int64), 0) - 1
    run_mass = torch.zeros(n, dtype=wt.dtype).index_add(0, run_id, wt)
    mass = torch.where(is_start, run_mass[run_id], 0.0)
    uwords = torch.where((w >= 0) & (mass > 0), w, -1)
    mass = torch.where(uwords >= 0, mass, 0.0)
    return uwords, mass / torch.clamp(mass.sum(), min=1e-12)


@pytest.mark.parametrize("n_words", [7, 300, 5000])
def test_bow_sparse_sums_in_order_and_matches_reference(n_words):
    rng = np.random.RandomState(n_words)
    words = rng.randint(-1, n_words, 1024).astype(np.int32)
    weights = rng.uniform(0, 3, 1024).astype(np.float32) * (words >= 0)
    uw_j, ut_j = (np.asarray(x) for x in jdc.bow_sparse(jnp.asarray(words), jnp.asarray(weights)))
    uw_t, ut_t = tdc.bow_sparse(torch.from_numpy(words), torch.from_numpy(weights))
    np.testing.assert_array_equal(uw_t.numpy(), uw_j)
    np.testing.assert_allclose(ut_t.numpy(), ut_j, rtol=0, atol=1e-6)
    uw_0, ut_0 = _bow_sparse_index_add(torch.from_numpy(words), torch.from_numpy(weights))
    assert torch.equal(uw_t, uw_0) and torch.equal(ut_t, ut_0)
