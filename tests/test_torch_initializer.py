"""Parity of tpuslam_torch.frontend.initializer, match_for_init and
epipolar_gate with the JAX package, on the CPU, on the golden synth frames
at 320x240 (tests/_torch_scene.py).

Tolerances: match_for_init and epipolar_gate exact; initialize_two_view,
given the reference's own RANSAC samples: ok, used_h and good equal, the
rotation of T_21 within 1e-4 and its unit translation within 3e-4, and the
good points within 1e-3 m + 1e-3 relative.  The model is the smallest
eigenvector of a float32 9x9 normal matrix, then two SVDs; both packages
call LAPACK, in different builds and with sums in another order, and the
unit translation carries that rounding at the 1e-4 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene as sc
from tpuslam.frontend import initializer as jin
from tpuslam.frontend import tracking as jtr
from tpuslam.kernels import match as jm
from tpuslam_torch.core.camera import Camera, camera_matrix
from tpuslam_torch.frontend import initializer as tin
from tpuslam_torch.frontend import tracking as ttr
from tpuslam_torch.kernels import match as tm
from tpuslam_torch.map import mapstate as tms


def _t(a):
    return tms.tensor_from_numpy(np.asarray(a), "cpu")


def _frame(fid):
    return ttr.Frame(*(_t(x) for x in sc.jax_frame(fid)))


def jax_samples(valid, frame_id, n_iters=200):
    """The reference's RANSAC draw (initializer.py:281-287) for one attempt."""
    keys = jax.random.split(jax.random.PRNGKey(frame_id), n_iters)
    pen = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    g = jax.vmap(lambda k: jax.random.gumbel(k, (valid.shape[0],)))(keys) + pen
    return np.asarray(jax.lax.top_k(g, 8)[1])


@pytest.mark.parametrize("pair", [(0, 3), (0, 8)])
def test_match_for_init_matches_reference(pair):
    a, b = pair
    idx_j, ok_j = jtr.match_for_init(sc.jax_frame(a), sc.jax_frame(b))
    idx_t, ok_t = ttr.match_for_init(_frame(a), _frame(b))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(idx_t.numpy()[ok], np.asarray(idx_j)[ok])
    assert ok.sum() > 100


def test_epipolar_gate_matches_reference():
    rng = np.random.RandomState(0)
    uv_a = rng.uniform([0, 0], [320, 240], (300, 2)).astype(np.float32)
    uv_b = rng.uniform([0, 0], [320, 240], (280, 2)).astype(np.float32)
    F = rng.normal(size=(3, 3)).astype(np.float32) * np.float32(1e-3)
    scale = (1.2 ** rng.randint(0, 8, 280)).astype(np.float32)
    ref = np.asarray(jm.epipolar_gate(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(F), jnp.asarray(scale)))
    got = tm.epipolar_gate(*map(torch.from_numpy, (uv_a, uv_b, F, scale))).numpy()
    assert 0 < ref.sum() < ref.size
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("pair", [(0, 4), (0, 5), (0, 8)])
def test_initialize_two_view_matches_reference_given_its_samples(pair):
    a, b = pair
    fa, fb = sc.jax_frame(a), sc.jax_frame(b)
    idx, ok = jtr.match_for_init(fa, fb)
    cam = sc.jax_camera()
    ref = jin.initialize_two_view(fa.uv, fb.uv[idx], ok, cam.K, jax.random.PRNGKey(b))
    samples = jax_samples(np.asarray(ok), b)
    tcam = Camera.make(cam.fx, cam.fy, cam.cx, cam.cy, "cpu", width=cam.width, height=cam.height)
    got = tin.initialize_two_view(_t(fa.uv), _t(np.asarray(fb.uv)[np.asarray(idx)]), _t(ok),
                                  camera_matrix(tcam), torch.from_numpy(samples.copy()))
    assert bool(got.ok) == bool(ref.ok)
    assert bool(got.used_h) == bool(ref.used_h)
    np.testing.assert_array_equal(got.good.numpy(), np.asarray(ref.good))
    T_g, T_r = got.T_21.numpy(), np.asarray(ref.T_21)
    np.testing.assert_allclose(T_g[:3, :3], T_r[:3, :3], atol=1e-4, rtol=0)
    np.testing.assert_allclose(T_g[:3, 3], T_r[:3, 3], atol=3e-4, rtol=0)
    good = np.asarray(ref.good)
    np.testing.assert_allclose(got.points.numpy()[good], np.asarray(ref.points)[good], atol=1e-3, rtol=1e-3)
    if pair == (0, 4):
        assert bool(ref.ok) and good.sum() > 80


@pytest.mark.parametrize("seed,n,p_valid,n_iters,n_pick", [
    (3, 1024, 0.4, 200, 8),  # an initialization attempt at full width
    (4, 300, 0.7, 200, 8),
    (17, 512, 0.5, 200, 6),  # a relocalization candidate's PnP draw
    (1004, 64, 0.5, 300, 3),  # a Sim3 draw
    (0, 10, 0.3, 20, 8),  # fewer valid entries than picks
])
def test_ransac_samples_are_the_reference_draw(seed, n, p_valid, n_iters, n_pick):
    """The port's host Threefry draw equals the reference's ``jax.random``
    draw index for index (initializer.py:281-287, pnp.py:64-68,
    sim3solver.py:73-77 of the reference)."""
    valid = np.random.RandomState(seed).rand(n) < p_valid
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iters)
    g = jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(keys) + jnp.where(jnp.asarray(valid), 0.0, -1e9)
    want = np.asarray(jax.lax.top_k(g, n_pick)[1])
    np.testing.assert_array_equal(tin.ransac_samples(torch.from_numpy(valid), seed, n_iters, n_pick).numpy(), want)


def test_ransac_samples_are_distinct_valid_and_seeded():
    valid = torch.from_numpy(np.random.RandomState(1).rand(300) > 0.3)
    s = tin.ransac_samples(valid, 7)
    assert s.shape == (200, 8) and bool(valid[s].all())
    assert all(len(set(row.tolist())) == 8 for row in s)
    assert torch.equal(s, tin.ransac_samples(valid, 7)) and not torch.equal(s, tin.ransac_samples(valid, 8))
