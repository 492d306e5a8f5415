"""Parity of tpuslam_torch.core (SE3 helpers, camera) with the JAX package.

Inputs are made with numpy from a seed and go through both packages on the
CPU.  Tolerance: SE3 helpers atol 1e-6 (float32 arithmetic in both).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuslam.core import camera as jcam
from tpuslam.core import geometry as jgeo
from tpuslam_torch.core import camera as tcam
from tpuslam_torch.core import geometry as tgeo


def _tangents(n=64, seed=0):
    """(n, 6) se3 tangents: generic angles plus exact zeros and tiny angles,
    which take the Taylor branches."""
    rng = np.random.RandomState(seed)
    xi = rng.normal(0.0, 0.6, (n, 6)).astype(np.float32)
    xi[:4, :3] = 0.0
    xi[4:8, :3] *= 1e-7
    return xi


def _poses(n=16, seed=1):
    xi = jnp.asarray(_tangents(n, seed))
    return np.array(jgeo.se3_exp(xi))


CASES = {
    "so3_hat": lambda g, x: g.so3_hat(x[:, :3]),
    "so3_exp": lambda g, x: g.so3_exp(x[:, :3]),
    "so3_left_jacobian": lambda g, x: g._so3_left_jacobian(x[:, :3]),
    "se3_exp": lambda g, x: g.se3_exp(x),
    "se3_from_Rt": lambda g, x: g.se3_from_Rt(g.so3_exp(x[:, :3]), x[:, 3:]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tangent_functions_match_reference(name):
    xi = _tangents()
    ref = np.asarray(CASES[name](jgeo, jnp.asarray(xi)))
    got = CASES[name](tgeo, torch.from_numpy(xi)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["se3_inv", "se3_renorm", "se3_apply"])
def test_pose_functions_match_reference(name):
    T = _poses()
    # a slightly non-orthogonal rotation block, as a velocity product drifts
    T[:, :3, :3] *= np.float32(1.0 + 1e-3)
    pts = np.random.RandomState(2).normal(0.0, 3.0, (16, 3)).astype(np.float32)
    jf, tf = getattr(jgeo, name), getattr(tgeo, name)
    if name == "se3_apply":
        ref = np.asarray(jf(jnp.asarray(T), jnp.asarray(pts)))
        got = tf(torch.from_numpy(T), torch.from_numpy(pts)).numpy()
        # one pose applied to a batch of points, as the tracking code calls it
        ref1 = np.asarray(jf(jnp.asarray(T[3]), jnp.asarray(pts)))
        got1 = tf(torch.from_numpy(T[3]), torch.from_numpy(pts)).numpy()
        np.testing.assert_allclose(got1, ref1, atol=1e-5, rtol=1e-6)
    else:
        ref = np.asarray(jf(jnp.asarray(T)))
        got = tf(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 if name == "se3_apply" else 1e-6, rtol=1e-6)


def _cams():
    kw = dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7, width=640, height=480, bf=40.0)
    dist = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]
    return jcam.Camera.make(dist=dist, **kw), tcam.Camera.make(device="cpu", dist=dist, **kw)


def test_camera_numpy_round_trip():
    jc, tc = _cams()
    fields = {k: np.asarray(v) for k, v in jc._asdict().items()}
    back = tcam.camera_to_numpy(tcam.camera_from_numpy(fields, "cpu"))
    assert sorted(back) == sorted(jc._fields)
    for k in jc._fields:
        np.testing.assert_array_equal(back[k], fields[k])
    assert tcam.camera_to_numpy(tc)["fx"] == np.float32(520.9)


@pytest.mark.parametrize("name", ["project", "backproject", "undistort_points"])
def test_camera_functions_match_reference(name):
    jc, tc = _cams()
    rng = np.random.RandomState(3)
    uv = rng.uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 8.0, 200).astype(np.float32)
    p = np.concatenate([rng.normal(0, 1, (200, 2)), rng.uniform(0.5, 6, (200, 1))], 1).astype(np.float32)
    args = {"project": (p,), "backproject": (uv, depth), "undistort_points": (uv,)}[name]
    ref = np.asarray(getattr(jcam, name)(jc, *map(jnp.asarray, args)))
    got = getattr(tcam, name)(tc, *map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
