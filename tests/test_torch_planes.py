"""Parity of the port's online plane segmentation (tpuslam_torch.kernels.planes
and ``semantic.detect.detect_planes_online``) with the JAX package's, on the
CPU.

Inputs: golden frames' depth at 320x240 (fx = fy = 260) from the numpy
oracle ``synth.render_frame``, stored and read back as the golden depth PNGs
are (uint16 of depth * 5000, then / 5000 in float32), and an empty (all
zero) depth.

Tolerances: the point map within 1e-6 m; the Hough votes, the peak bins, the
peak votes and the ``valid`` mask equal (integer scatter-adds of truncated
bins); the inlier counts within 0.5% and the centroids within 1e-3 m (the
least-squares refits sum ~8k points in another order, which moves the
inlier gates' borderline pixels); the valid planes' coefficients within
1e-3 (normal components and distance in metres).  The reference's votes
come from its own code (planes.py:72-106) run on its own point map and
normals, as ``segment_planes`` runs them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene as sc
from tpuslam.core import camera as jcam
from tpuslam.io import synth as js
from tpuslam.kernels import planes as jpl
from tpuslam.semantic import detect as jdet
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.io import synth as ts
from tpuslam_torch.kernels import planes as tpl
from tpuslam_torch.semantic import detect as tdet

C = sc.CSPEC
INTR = (C.fx, C.fy, C.cx, C.cy)


@functools.lru_cache(maxsize=None)
def _depth(fid):
    if fid < 0:
        return np.zeros((C.height, C.width), np.float32)
    spec = js.SceneSpec()
    T = js.trajectory(560, spec, total_angle_deg=400.0)[fid]
    depth = js.render_frame(T, C, spec)[1]
    return np.clip(depth * 5000, 0, 65535).astype(np.uint16).astype(np.float32) / 5000.0


@functools.partial(jax.jit, static_argnames=("max_planes",))
def _reference_votes(depth, max_planes, n_az=24, n_el=12, n_d=64, d_max=12.8):
    """planes.py:72-106 of the reference: its point map and normals, the
    votes and the peaks' top-k."""
    pts = jpl.organized_cloud(depth, *INTR, 3)
    normals = jpl.cloud_normals(pts)
    h, w = pts.shape[:2]
    valid_px = (pts[..., 2] > 0.1) & (jnp.abs(normals).sum(-1) > 0.1)
    valid_px = valid_px & jnp.zeros((h, w), bool).at[1:-1, 1:-1].set(True)
    d_signed = -jnp.sum(normals * pts, axis=-1)
    normals = jnp.where((d_signed < 0)[..., None], -normals, normals)
    d_plane = jnp.abs(d_signed)
    az = jnp.arctan2(normals[..., 1], normals[..., 0])
    el = jnp.arcsin(jnp.clip(normals[..., 2], -1.0, 1.0))
    ia = jnp.clip(((az + jnp.pi) / (2 * jnp.pi) * n_az).astype(jnp.int32), 0, n_az - 1)
    ie = jnp.clip(((el + jnp.pi / 2) / jnp.pi * n_el).astype(jnp.int32), 0, n_el - 1)
    idd = jnp.clip((d_plane / d_max * n_d).astype(jnp.int32), 0, n_d - 1)
    flat = jnp.where(valid_px, (ia * n_el + ie) * n_d + idd, n_az * n_el * n_d)
    votes = jnp.zeros((n_az * n_el * n_d + 1,), jnp.int32).at[flat.reshape(-1)].add(1)[:-1]
    v3 = votes.reshape(n_az * n_el, n_d)
    neigh = jnp.maximum(v3, jnp.maximum(jnp.roll(v3, 1, axis=1), jnp.roll(v3, -1, axis=1)))
    top_votes, top_bins = jax.lax.top_k(jnp.where(v3 >= neigh, v3, 0).reshape(-1), max_planes)
    return pts, votes, top_votes, top_bins


@pytest.mark.parametrize("fid", [40, 150, -1])
def test_votes_and_peaks_equal_reference(fid):
    depth = _depth(fid)
    pts_r, votes_r, tv_r, tb_r = (np.asarray(x) for x in _reference_votes(jnp.asarray(depth), 16))
    pts, _, _, votes = tpl.hough_votes(torch.from_numpy(depth), *INTR)
    np.testing.assert_allclose(pts.numpy(), pts_r.reshape(-1, 3), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(votes.numpy(), votes_r)
    peaks = votes.reshape(-1, 64)
    neigh = torch.maximum(peaks, torch.maximum(torch.roll(peaks, 1, 1), torch.roll(peaks, -1, 1)))
    tv, tb = tpl.topk_stable(torch.where(peaks >= neigh, peaks, 0).reshape(-1), 16)
    np.testing.assert_array_equal(tv.numpy(), tv_r)
    np.testing.assert_array_equal(tb.numpy(), tb_r)
    assert (votes_r.sum() > 5000) == (fid >= 0)


def _assert_planes(got, ref):
    coef, cen, cnt, valid = (g.numpy() for g in got)
    coef_r, cen_r, cnt_r, valid_r = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(valid, valid_r)
    v = valid_r
    np.testing.assert_allclose(cnt[v], cnt_r[v], rtol=5e-3)
    np.testing.assert_allclose(coef[v], coef_r[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(cen[v], cen_r[v], rtol=0, atol=1e-3)
    return int(v.sum())


@pytest.mark.parametrize("fid", [40, 150, -1])
def test_segment_planes_matches_reference(fid):
    depth = _depth(fid)
    ref = jpl.segment_planes(jnp.asarray(depth), *INTR, stride=3, max_planes=16)
    got = tpl.segment_planes(torch.from_numpy(depth), *INTR, stride=3, max_planes=16)
    n = _assert_planes(got, ref)
    assert (n >= 2) if fid >= 0 else (n == 0), n


def test_detect_planes_online_matches_reference():
    depth = _depth(40)
    jc = jcam.Camera.make(*INTR, width=C.width, height=C.height, bf=C.fx * C.baseline)
    tc = Camera.make(*INTR, "cpu", width=C.width, height=C.height, bf=C.fx * C.baseline)
    ref = jdet.detect_planes_online(depth, jc, 16)
    got = tdet.detect_planes_online(torch.from_numpy(depth), tc, 16)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.coef.numpy()[v], np.asarray(ref.coef)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.centroid.numpy()[v], np.asarray(ref.centroid)[v], rtol=0, atol=1e-3)


def test_quantized_depth_equals_the_golden_png_round_trip():
    """``quantize_depth`` is the PNG round trip bit for bit; the port's
    renderer, whose float depth is the oracle's within 2e-6 relative, lands
    one depth unit (0.2 mm) off on a few pixels only."""
    spec = js.SceneSpec()
    T = js.trajectory(560, spec, total_angle_deg=400.0)[[40, 150]]
    r = ts.make_batch_renderer(C, ts.SceneSpec(), "cpu")
    _, depth = ts.render_uint8(r, T, depth=True)
    for j, fid in enumerate((40, 150)):
        raw = js.render_frame(T[j], C, spec)[1]
        np.testing.assert_array_equal(ts.quantize_depth(torch.from_numpy(raw)).numpy(), _depth(fid))
        diff = np.abs(depth[j].numpy() - _depth(fid))
        assert (diff > 0).mean() < 5e-4 and diff.max() <= 1.5 / 5000, ((diff > 0).mean(), diff.max())
