"""Parity of tpuslam_torch.map.mapstate and tpuslam_torch.frontend.tracking
with the JAX package, on the CPU, at a small size: 240x320 images, 4 pyramid
levels, 256 features, 8 keyframes, 1024 points, 512 local points.

Tolerances: map reads and writes exact; ``track_and_decide`` on the same
frame and map: T within 1e-4, kp_pt, scalars and the map's counters equal;
``track_image_and_decide`` over 3 chained frames, each package extracting
its own features: T within 1e-3, kp_pt agreement >= 98%, n_final within 2%.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuslam.core import camera as jcam
from tpuslam.core.config import TrackingConfig
from tpuslam.frontend import tracking as jtr
from tpuslam.kernels import match as jm
from tpuslam.kernels import orb as jorb
from tpuslam.map import mapstate as jms
from tpuslam_torch import workload
from tpuslam_torch.core import camera as tcam
from tpuslam_torch.frontend import tracking as ttr
from tpuslam_torch.kernels.orb import OrbExtractor
from tpuslam_torch.map import mapstate as tms

CAPS = workload.SMALL["caps"]
H, W, LEVELS, N = 240, 320, 4, CAPS.max_keypoints
FX, BF, Z = workload.FX, 40.0, workload.Z_WALL
TC = TrackingConfig()


def _t(a):
    return tms.tensor_from_numpy(np.asarray(a), "cpu")


def _to_torch_frame(f):
    return ttr.Frame(*(_t(x) for x in f))


def _jax_map_fields(m):
    return {k: np.asarray(getattr(m, k)) for k in m._fields}


def _jax_camera(bf=BF):
    return jcam.Camera.make(FX, FX, W / 2.0, H / 2.0, width=W, height=H, bf=bf)


def _pose_x(x):
    """World->camera pose of a camera at world x."""
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -x
    return T


_SCENE = {}


def _scene():
    """A JAX-built map: keyframe 0 = frame 0 at the origin, keyframe 1 =
    frame 2 at its true pose, its keypoints bound to keyframe 0's points
    where the descriptors match and to new points elsewhere; point stats by
    the JAX package's update_point_stats.  Built once per test module."""
    if _SCENE:
        return _SCENE
    frames = workload.make_frames(6, H, W)
    cam = _jax_camera()
    f = {i: jtr.frame_from_features(jorb.extract(jnp.asarray(frames[i]), n_features=N, n_levels=LEVELS), cam)
         for i in (0, 2)}
    step = workload.PX_STEP * Z / FX
    m = jms.empty_map(CAPS)

    def backproject(fr, x_cam):
        uv = np.asarray(fr.uv)
        return np.stack([(uv[:, 0] - W / 2) * Z / FX + x_cam, (uv[:, 1] - H / 2) * Z / FX,
                         np.full(N, Z)], 1).astype(np.float32)

    v0 = np.asarray(f[0].valid)
    m = jms.add_points(m, jnp.arange(N), jnp.asarray(backproject(f[0], 0.0)), f[0].desc,
                       jnp.zeros((N, 3)), jnp.zeros(N), jnp.full(N, 1e9), jnp.zeros(N, jnp.int32),
                       jnp.asarray(v0))
    pt0 = np.where(v0, np.arange(N), -1).astype(np.int32)
    m = jms.add_keyframe(m, 0, jnp.eye(4), 0, f[0].uv, f[0].octave, f[0].angle, f[0].desc,
                         f[0].valid, jnp.asarray(pt0), f[0].ur, f[0].depth)
    gate = jm.window_gate(f[2].uv + jnp.asarray([2 * workload.PX_STEP, 0.0]), f[0].uv, 3.0)
    idx, _, ok = jm.match_descriptors(f[2].desc, f[0].desc, f[2].valid, f[0].valid,
                                      gate_mask=gate, max_dist=50.0, ratio=0.8)
    ok, idx, v2 = np.asarray(ok), np.asarray(idx), np.asarray(f[2].valid)
    new = v2 & ~ok
    m = jms.add_points(m, jnp.arange(N, 2 * N), jnp.asarray(backproject(f[2], 2 * step)), f[2].desc,
                       jnp.zeros((N, 3)), jnp.zeros(N), jnp.full(N, 1e9),
                       jnp.ones(N, jnp.int32), jnp.asarray(new))
    pt1 = np.where(ok, idx, np.where(new, N + np.arange(N), -1)).astype(np.int32)
    m = jms.add_keyframe(m, 1, jnp.asarray(_pose_x(2 * step)), 2, f[2].uv, f[2].octave, f[2].angle,
                         f[2].desc, f[2].valid, jnp.asarray(pt1), f[2].ur, f[2].depth)
    m = jms.update_point_stats(m, n_levels=LEVELS)
    assert ok.sum() > 50 and new.sum() > 20
    _SCENE.update(frames=frames, map=m, kf1=f[2], pt1=pt1, step=step)
    return _SCENE


# ---------------------------------------------------------------------------
# map state
# ---------------------------------------------------------------------------


def test_mapstate_fields_and_empty_map_match_reference():
    assert tms.FIELDS == jms.MapState._fields
    ref = _jax_map_fields(jms.empty_map(CAPS))
    got = tms.map_to_numpy(tms.empty_map(CAPS, "cpu"))
    for k in tms.FIELDS:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_map_numpy_round_trip_is_exact():
    fields = _jax_map_fields(_scene()["map"])
    back = tms.map_to_numpy(tms.map_from_numpy(fields, "cpu"))
    for k in tms.FIELDS:
        assert back[k].dtype == fields[k].dtype and np.array_equal(back[k], fields[k]), k
    assert tms.map_from_numpy(fields, "cpu").kf_desc.dtype == torch.int32


@pytest.mark.parametrize("name", ["incidence", "covisibility", "point_obs_counts"])
def test_map_reads_match_reference(name):
    m = _scene()["map"]
    ref = np.asarray(getattr(jms, name)(m))
    got = getattr(tms, name)(tms.map_from_numpy(_jax_map_fields(m), "cpu")).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.max() > 0


def test_predict_scale_level_matches_reference():
    rng = np.random.RandomState(0)
    dist = rng.uniform(0.5, 12, 500).astype(np.float32)
    max_d = np.where(rng.rand(500) < 0.2, 1e9, rng.uniform(1, 20, 500)).astype(np.float32)
    ref = np.asarray(jms.predict_scale_level(jnp.asarray(dist), jnp.asarray(max_d)))
    got = tms.predict_scale_level(torch.from_numpy(dist), torch.from_numpy(max_d)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_scatter_with_duplicate_indices_keeps_the_last_row():
    """XLA's scatter-set on the CPU applies rows in order, so the last row
    wins: zeros(4).at[[1, 1, 2, 1]].set([5, 7, 3, 9]) == [0, 9, 3, 0]."""
    idx, vals = [1, 1, 2, 1], [5.0, 7.0, 3.0, 9.0]
    ref = np.asarray(jnp.zeros(4).at[jnp.asarray(idx)].set(jnp.asarray(vals)))
    got = tms.scatter_last(torch.zeros(4), torch.tensor(idx), torch.tensor(vals))
    assert got.tolist() == [0.0, 9.0, 3.0, 0.0] == ref.tolist()
    rng = np.random.RandomState(1)
    idx = rng.randint(0, 20, 300)
    vals = rng.normal(size=(300, 3)).astype(np.float32)
    ref = np.asarray(jnp.ones((20, 3)).at[jnp.asarray(idx)].set(jnp.asarray(vals)))
    got = tms.scatter_last(torch.ones(20, 3), torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", ["add_keyframe", "add_points", "assign_observations"])
def test_map_writes_match_reference(name):
    rng = np.random.RandomState(2)
    m_j = _scene()["map"]
    m_t = tms.map_from_numpy(_jax_map_fields(m_j), "cpu")
    if name == "add_keyframe":
        args = (np.array(jms.se3_identity() if hasattr(jms, "se3_identity") else np.eye(4), np.float32),
                7, rng.normal(size=(N, 2)).astype(np.float32), rng.randint(0, 4, N).astype(np.int32),
                rng.normal(size=N).astype(np.float32),
                rng.randint(0, 1 << 32, (N, 8), dtype=np.uint64).astype(np.uint32),
                rng.rand(N) > 0.5, rng.randint(-1, 900, N).astype(np.int32),
                rng.normal(size=N).astype(np.float32), rng.normal(size=N).astype(np.float32))
        ref = jms.add_keyframe(m_j, 5, *map(jnp.asarray, args))
        got = tms.add_keyframe(m_t, 5, *map(_t, args))
    elif name == "add_points":
        n = 64
        slots = rng.randint(600, 700, n).astype(np.int32)  # repeats: the last lane wins
        args = (slots, rng.normal(size=(n, 3)).astype(np.float32),
                rng.randint(0, 1 << 32, (n, 8), dtype=np.uint64).astype(np.uint32),
                rng.normal(size=(n, 3)).astype(np.float32), rng.rand(n).astype(np.float32),
                rng.rand(n).astype(np.float32) + 5, rng.randint(0, 8, n).astype(np.int32),
                rng.rand(n) > 0.3)
        ref = jms.add_points(m_j, *map(jnp.asarray, args))
        got = tms.add_points(m_t, *map(_t, args))
    else:
        kp = rng.randint(0, N, 100).astype(np.int32)
        args = (kp, rng.randint(0, 1000, 100).astype(np.int32), rng.rand(100) > 0.4)
        ref = jms.assign_observations(m_j, 1, *map(jnp.asarray, args))
        got = tms.assign_observations(m_t, 1, *map(_t, args))
    want, have = _jax_map_fields(ref), tms.map_to_numpy(got)
    for k in tms.FIELDS:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the tracking program
# ---------------------------------------------------------------------------


def _depth_frame(cam_t, frame_j):
    """Frame 3 with depth on the right half of the image (RGB-D rows)."""
    depth = np.zeros((H, W), np.float32)
    depth[:, W // 2 :] = Z
    d, ur = jtr.sample_depth_at_keypoints(frame_j.uv, jnp.asarray(depth), BF)
    d_t, ur_t = ttr.sample_depth_at_keypoints(_t(frame_j.uv), torch.from_numpy(depth), cam_t.bf)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d))
    np.testing.assert_allclose(ur_t.numpy(), np.asarray(ur), rtol=1e-6)
    return frame_j._replace(depth=d, ur=ur)


@pytest.mark.parametrize("path", ["motion_model", "reference_kf"])
def test_track_and_decide_matches_reference(path):
    sc = _scene()
    cam_j = _jax_camera()
    cam_t = tcam.camera_from_numpy({k: np.asarray(v) for k, v in cam_j._asdict().items()}, "cpu")
    f3 = jtr.frame_from_features(
        jorb.extract(jnp.asarray(sc["frames"][3]), n_features=N, n_levels=LEVELS), cam_j)
    frame_j = _depth_frame(cam_t, f3)
    T_cur = _pose_x(2 * sc["step"])
    if path == "motion_model":
        vel = _pose_x(0.8 * sc["step"])  # a near-true constant-velocity guess
    else:  # a wild guess: the motion model finds too few matches
        vel = np.array(jnp.asarray(_pose_x(-0.4)) @ jnp.asarray(
            jorb.jnp.eye(4)).at[:3, :3].set(jnp.asarray([[0.9, -0.436, 0], [0.436, 0.9, 0], [0, 0, 1]])))
    args = dict(radius_motion=TC.search_radius_motion, radius_localmap=TC.search_radius_localmap,
                min_track_motion=TC.min_track_motion, th_depth=6.0)
    kf1 = sc["kf1"]
    ref = jtr.track_and_decide(
        sc["map"], frame_j, jnp.asarray(T_cur), jnp.asarray(vel), jnp.asarray(sc["pt1"]),
        kf1.angle, kf1.octave, jnp.int32(1), cam_j, n_local=CAPS.local_ba_points, **args)
    got = ttr.track_and_decide(
        tms.map_from_numpy(_jax_map_fields(sc["map"]), "cpu"), _to_torch_frame(frame_j),
        _t(T_cur), _t(vel), _t(sc["pt1"]), _t(kf1.angle), _t(kf1.octave), 1, cam_t,
        n_local=CAPS.local_ba_points, **args)
    scal = np.asarray(ref.scalars)
    assert scal[2] == (path == "reference_kf") and scal[3] > 100 and scal[7] > 0
    np.testing.assert_array_equal(got.scalars.numpy(), scal)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.kp_pt.numpy(), np.asarray(ref.kp_pt))
    np.testing.assert_array_equal(got.m.pt_visible.numpy(), np.asarray(ref.m.pt_visible))
    np.testing.assert_array_equal(got.m.pt_found.numpy(), np.asarray(ref.m.pt_found))
    np.testing.assert_array_equal(got.T_ref.numpy(), np.asarray(ref.T_ref))
    np.testing.assert_allclose(got.velocity.numpy(), np.asarray(ref.velocity), atol=1e-4, rtol=0)


def _chain(track, m, frames, T, vel, kp, angle, octave, convert):
    """Run ``track`` over ``frames``, chaining outputs as Tracker does."""
    out = []
    for img in frames:
        step, fr = track(m, convert(img), T, vel, kp, angle, octave)
        T, vel, kp, m = step.T, step.velocity, step.kp_pt, step.m
        angle, octave = fr.angle, fr.octave
        out.append((np.asarray(T), np.asarray(kp), np.asarray(step.scalars)))
    return out


def test_track_image_and_decide_chained_frames_match_reference():
    sc = _scene()
    cam_j = _jax_camera(bf=0.0)
    cam_t = tcam.camera_from_numpy({k: np.asarray(v) for k, v in cam_j._asdict().items()}, "cpu")
    T0, vel0 = _pose_x(2 * sc["step"]), _pose_x(sc["step"])
    kf1 = sc["kf1"]
    args = (TC.search_radius_motion, TC.search_radius_localmap, TC.min_track_motion, 0.0)
    extractor = OrbExtractor(H, W, "cpu", n_features=N, n_levels=LEVELS)

    def track_j(m, img, T, vel, kp, angle, octave):
        return jtr.track_image_and_decide(
            m, img, jnp.zeros((1, 1)), T, vel, kp, angle, octave, jnp.int32(1), cam_j, *args,
            n_local=CAPS.local_ba_points, n_features=N, n_levels=LEVELS)

    def track_t(m, img, T, vel, kp, angle, octave):
        step, fr = ttr.track_image_and_decide(
            m, img, None, T, vel, kp, angle, octave, 1, cam_t, *args, extractor,
            n_local=CAPS.local_ba_points)
        return step, fr

    frames = sc["frames"][3:6]
    ref = _chain(track_j, sc["map"], frames, jnp.asarray(T0), jnp.asarray(vel0),
                 jnp.asarray(sc["pt1"]), kf1.angle, kf1.octave, jnp.asarray)
    got = _chain(track_t, tms.map_from_numpy(_jax_map_fields(sc["map"]), "cpu"), frames,
                 _t(T0), _t(vel0), _t(sc["pt1"]), _t(kf1.angle), _t(kf1.octave), torch.from_numpy)
    for (rT, rkp, rs), (gT, gkp, gs) in zip(ref, got):
        np.testing.assert_allclose(gT, rT, atol=1e-3, rtol=0)
        assert (gkp == rkp).mean() >= 0.98
        assert abs(int(gs[3]) - int(rs[3])) <= 0.02 * rs[3] and rs[3] > 100


def test_workload_slice_matches_reference():
    """The chip workload's map and loop (tpuslam_torch.workload) at the small
    size against the same loop in the JAX package."""
    wl = workload.build_workload("cpu", **workload.SMALL)
    traj, scalars = workload.run_slice(wl)
    frames = workload.make_frames(4, H, W)
    cam = jcam.Camera.make(FX, FX, W / 2.0, H / 2.0, width=W, height=H)
    f0 = jtr.frame_from_features(jorb.extract(jnp.asarray(frames[0]), n_features=N, n_levels=LEVELS), cam)
    m = jms.empty_map(CAPS)
    uv = np.asarray(f0.uv)
    pts = np.stack([(uv[:, 0] - W / 2) * Z / FX, (uv[:, 1] - H / 2) * Z / FX, np.full(N, Z)], 1)
    m = jms.add_points(m, jnp.arange(N), jnp.asarray(pts, jnp.float32), f0.desc, jnp.zeros((N, 3)),
                       jnp.zeros(N), jnp.full(N, 1e9), jnp.zeros(N, jnp.int32), f0.valid)
    pt0 = jnp.where(f0.valid, jnp.arange(N), -1).astype(jnp.int32)
    m = jms.add_keyframe(m, 0, jnp.eye(4), 0, f0.uv, f0.octave, f0.angle, f0.desc, f0.valid, pt0,
                         f0.ur, f0.depth)

    def track_j(m, img, T, vel, kp, angle, octave):
        return jtr.track_image_and_decide(
            m, img, jnp.zeros((1, 1)), T, vel, kp, angle, octave, jnp.int32(0), cam,
            TC.search_radius_motion, TC.search_radius_localmap, TC.min_track_motion, 0.0,
            n_local=CAPS.local_ba_points, n_features=N, n_levels=LEVELS)

    ref = _chain(track_j, m, frames, jnp.eye(4), jnp.eye(4), pt0, f0.angle, f0.octave, jnp.asarray)
    np.testing.assert_allclose(traj.numpy(), np.stack([r[0] for r in ref]), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(scalars.numpy(), np.stack([r[2] for r in ref]))
    assert torch.isfinite(traj).all() and scalars.dtype == torch.int32


def test_port_slice_runs_without_jax():
    """Importing the port and running one CPU slice step loads no JAX."""
    code = (
        "import sys, tpuslam_torch\n"
        "from tpuslam_torch import workload as w\n"
        "wl = w.build_workload('cpu', **dict(w.SMALL, n_frames=1))\n"
        "traj, sc = w.run_slice(wl)\n"
        "assert traj.shape == (1, 4, 4) and int(sc[0, 3]) > 100, sc\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]
