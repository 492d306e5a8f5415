"""Parity of the port's stereo matcher (tpuslam_torch.kernels.stereo) with the
JAX package's, on the CPU, and the rendered stereo pair it is driven with.

Inputs: the constant-disparity texture of ``tests/test_stereo.py`` and one
golden pair at 320x240 (fx = fy = 260) rendered by the numpy oracle
``synth.render_frame``, the right view at the camera moved 0.075 m along its
own +x axis (``synth.right_poses``).  Both packages get the same keypoints:
the JAX package's ORB features of each view.

Tolerances: the SAD values, their argmin and the ``ok`` masks are integers
or decided by integers, and are equal; ``ur`` within 1e-4 px (the
parabola's division rounds); the depth within 1e-5 relative.  The rendered
pair obeys uL - uR = bf / Z: every left pixel's point, taken into the right
camera, lands at that column within 1e-3 px, and where it is not occluded
the right view's depth there is the left's within 1%.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

import _torch_scene as sc
from test_stereo import _textured_pair
from tpuslam.io import synth as js
from tpuslam.kernels import orb as jorb
from tpuslam.kernels import stereo as jks
from tpuslam_torch.io import synth as ts
from tpuslam_torch.kernels import stereo as tks

FID = 40


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


def _features(img, n, levels=8):
    return jorb.extract(jnp.asarray(img, jnp.float32), n_features=n, n_levels=levels)


@functools.lru_cache(maxsize=None)
def _golden_pair():
    spec = js.SceneSpec()
    T = js.trajectory(560, spec, total_angle_deg=400.0)[FID]
    left = js.render_frame(T, sc.CSPEC, spec)
    right = js.render_frame(ts.right_poses(T[None], sc.CSPEC.baseline)[0], sc.CSPEC, spec)
    return T, left, right


def _both(left, right, n, bf, fx, levels=8):
    fl, fr = _features(left, n, levels), _features(right, n, levels)
    args = (fl.uv, fl.octave, fl.desc, fl.valid, fr.uv, fr.octave, fr.desc, fr.valid)
    ref = jks.compute_stereo_matches(jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32), *args,
                                     bf=bf, fx=fx)
    got = tks.compute_stereo_matches(torch.from_numpy(np.asarray(left, np.float32)),
                                     torch.from_numpy(np.asarray(right, np.float32)),
                                     *(_t(a) for a in args), bf=bf, fx=fx)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_matches(ref, got, min_ok):
    (ur_r, d_r, ok_r), (ur_g, d_g, ok_g) = ref, got
    np.testing.assert_array_equal(ok_g, ok_r)
    assert ok_r.sum() >= min_ok, ok_r.sum()
    np.testing.assert_allclose(ur_g, ur_r, rtol=0, atol=1e-4)
    np.testing.assert_allclose(d_g, d_r, rtol=1e-5)


def test_sad_subpixel_matches_reference():
    left, right = _textured_pair(disparity=8.0)
    ys, xs = np.linspace(30, 200, 40), np.linspace(40, 280, 40)
    uv_l = np.stack([xs, ys], axis=1).astype(np.float32)
    u_r0 = (uv_l[:, 0] - 8.0 + np.random.default_rng(1).integers(-3, 4, 40)).astype(np.float32)
    octv = np.random.default_rng(2).integers(0, 4, 40).astype(np.int32)
    ref = jks.sad_subpixel(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv_l), jnp.asarray(u_r0),
                           jnp.asarray(octv))
    got = tks.sad_subpixel(torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(uv_l),
                           torch.from_numpy(u_r0), torch.from_numpy(octv))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-4)
    assert np.asarray(ref[2]).sum() >= 30


def test_constant_disparity_matches_reference():
    left, right = _textured_pair(disparity=12.0)
    ref, got = _both(left, right, 512, bf=40.0, fx=320.0, levels=4)
    _assert_matches(ref, got, 50)


def test_golden_pair_matches_reference():
    _, (left, _, _, _), (right, _, _, _) = _golden_pair()
    c = sc.CSPEC
    ref, got = _both(left.astype(np.uint8), right.astype(np.uint8), 512, bf=c.fx * c.baseline, fx=c.fx)
    _assert_matches(ref, got, 100)


def test_rendered_pair_obeys_the_disparity_rule():
    T, (_, depth_l, _, _), (_, depth_r, _, _) = _golden_pair()
    c = sc.CSPEC
    bf = c.fx * c.baseline
    v, u = np.mgrid[0:c.height:7, 0:c.width:7].astype(np.float64)
    Z = depth_l[::7, ::7].astype(np.float64)
    p_cam = np.stack([(u - c.cx) / c.fx * Z, (v - c.cy) / c.fy * Z, Z], axis=-1)
    p_w = p_cam @ T[:3, :3].T.astype(np.float64) + T[:3, 3]
    T_r = ts.right_poses(T[None], c.baseline)[0].astype(np.float64)
    p_r = (p_w - T_r[:3, 3]) @ T_r[:3, :3]
    u_r = c.fx * p_r[..., 0] / p_r[..., 2] + c.cx
    np.testing.assert_allclose(u_r, u - bf / Z, rtol=0, atol=1e-3)
    np.testing.assert_allclose(p_r[..., 2], Z, rtol=1e-5)
    col = np.round(u_r).astype(int)
    inside = (col >= 0) & (col < c.width)
    z_r = depth_r[v.astype(int)[inside], col[inside]]
    seen = np.abs(z_r - Z[inside]) <= 0.01 * Z[inside]
    assert seen.mean() > 0.9, seen.mean()
