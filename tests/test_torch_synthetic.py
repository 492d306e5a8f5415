"""The port's feature-level synthetic sequences (``tpuslam_torch/io/
synthetic.py``) against the JAX package's ``tpuslam/io/synthetic.py``, on the
CPU, and the mono ``Tracker`` driven through ``process_frame`` by them.

The scene is numpy in both packages, so each renderer is fed both packages'
scenes: a difference in a renderer cannot hide behind one in the scene.

Tolerances: the scene's points, descriptors, planes and cuboids equal, its
poses within 1e-6 (float32 sines of the port and of XLA); a frame's uv,
valid, depth and right-view u equal and its descriptors equal bit for bit
(numpy draws in the reference's order); plane detections' valid masks equal
and coefficients within 1e-5; cuboid detections' valid masks and class ids
equal, poses and scales within 1e-5 and the projected box and corners
within 1e-5 relative (a few float32 ulps of pixel coordinates near 500).

The Tracker, mono, on ``tests/test_tracking_e2e.py``'s scene (800 points,
40 frames, 512 features, its capacities, loop closing on): the same tracked
frame ids and keyframe frame ids, every tracked pose within 5e-3, the
golden mono parity tests' tolerance (local BA leaves the mono scale free and
float32 rounding moves the solution along it; 1.8e-3 here when written),
and the live points within 1% (461 against 460 when written: one point
culled on one side of a threshold).
"""

import numpy as np
import pytest
import torch

import _torch_scene  # noqa: F401  (caps torch's threads per worker)
from tpuslam.core import camera as jcam
from tpuslam.core import config as jcfg
from tpuslam.frontend import tracking as jtr
from tpuslam.io import synthetic as js
from tpuslam_torch.apps import feature_replay
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.frontend import tracking as ttr
from tpuslam_torch.io import synthetic as ts

CAM_ARGS = (500.0, 500.0, 320.0, 240.0)
POSE_TOL = 5e-3


def _cams(bf=0.0):
    return jcam.Camera.make(*CAM_ARGS, bf=bf), Camera.make(*CAM_ARGS, "cpu", bf=bf)


@pytest.mark.parametrize("semantic", [False, True], ids=["points", "planes_cuboids"])
def test_make_room_scene_matches_reference(semantic):
    sj = js.make_room_scene(800, 40, 3, with_planes=semantic, with_cuboids=semantic)
    st = ts.make_room_scene(800, 40, 3, with_planes=semantic, with_cuboids=semantic)
    for k in ("points", "desc", "planes", "cuboids"):
        a, b = getattr(sj, k), getattr(st, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert st.poses.dtype == np.float32
    np.testing.assert_allclose(st.poses, sj.poses, rtol=0, atol=1e-6)
    assert len(st.planes) == (3 if semantic else 0) and len(st.cuboids) == (2 if semantic else 0)


def _scene(source):
    mod = js if source == "jax" else ts
    return mod.make_room_scene(800, 40, 0, with_planes=True, with_cuboids=True)


@pytest.mark.parametrize("source", ["jax", "port"], ids=["jax_scene", "port_scene"])
@pytest.mark.parametrize("with_depth", [False, True], ids=["mono", "depth"])
def test_render_frame_matches_reference(with_depth, source):
    scene = _scene(source)
    cj, ct = _cams(bf=40.0)
    for f in (0, 7, 39):
        fj = js.render_frame(scene, f, cj, n_features=512, with_depth=with_depth)
        ft = ts.render_frame(scene, f, ct, n_features=512, with_depth=with_depth, device="cpu")
        for k in ("uv", "valid", "depth", "ur", "octave", "angle"):
            a, b = np.asarray(getattr(fj, k)), getattr(ft, k).numpy()
            assert a.shape == b.shape and np.array_equal(a, b), (f, k)
        assert ft.desc.dtype == torch.int32
        assert np.array_equal(np.asarray(fj.desc).view(np.int32), ft.desc.numpy()), f
        assert 0 < int(ft.valid.sum()) <= 512
        assert bool((ft.depth[ft.valid] > 0).all()) == with_depth


@pytest.mark.parametrize("source", ["jax", "port"], ids=["jax_scene", "port_scene"])
def test_render_detections_match_reference(source):
    scene = _scene(source)
    cj, ct = _cams()
    n_cub = 0
    for f in (0, 7, 20, 39):
        pj = js.render_plane_detections(scene, f, 8)
        pt = ts.render_plane_detections(scene, f, 8, device="cpu")
        np.testing.assert_array_equal(pt.valid, np.asarray(pj.valid))
        np.testing.assert_allclose(pt.coef, np.asarray(pj.coef), rtol=0, atol=1e-5)
        assert pt.valid.sum() >= 1
        dj = js.render_cuboid_detections(scene, f, cj, 4)
        dt = ts.render_cuboid_detections(scene, f, ct, 4, device="cpu")
        np.testing.assert_array_equal(dt.valid, np.asarray(dj.valid))
        np.testing.assert_array_equal(dt.classid, np.asarray(dj.classid))
        for k in ("local_pose", "local_scale", "global_pose", "global_scale", "quality"):
            np.testing.assert_allclose(getattr(dt, k), np.asarray(getattr(dj, k)), rtol=0, atol=1e-5, err_msg=k)
        for k in ("bbox", "corners"):
            ref = np.asarray(getattr(dj, k))
            np.testing.assert_allclose(getattr(dt, k), ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=k)
        n_cub += int(dt.valid.sum())
    assert n_cub >= 1
    # a room without planes or cuboids gives the empty detections
    bare = ts.make_room_scene(800, 40, 0)
    assert not ts.render_plane_detections(bare, 0, 8, device="cpu").valid.any()
    assert not ts.render_cuboid_detections(bare, 0, ct, 4, device="cpu").valid.any()


def test_feature_replay_frames_hold_every_feature():
    """The feature-level replay's room (``apps/feature_replay.py``): every
    one of the 120 frames at the golden camera sees more than 1024 points,
    so each frame holds 1024 valid features."""
    scene, cam, frames, dets = feature_replay.render(120, "cpu")
    assert dets is None and len(frames) == 120 and cam.width == 640 and cam.fx == 520.0
    assert all(f.valid.shape == (1024,) and bool(f.valid.all()) for f in frames)
    assert scene.points.shape == (feature_replay.N_POINTS, 3)


def _e2e_cfg(mod):
    """``tests/test_tracking_e2e.py``'s configuration (default flags)."""
    return mod.SlamConfig().replace(caps=mod.Capacities(
        max_keypoints=512, max_keyframes=64, max_points=8192, max_planes=8, max_cuboids=4, local_ba_keyframes=8,
        local_ba_fixed_keyframes=8, local_ba_points=2048))


def test_process_frame_tracker_matches_reference_on_the_synthetic_room():
    scene = js.make_room_scene(n_points=800, n_frames=40, seed=0)
    cj, ct = _cams()
    jt = jtr.Tracker(cj, _e2e_cfg(jcfg))
    tt = ttr.Tracker(ct, _e2e_cfg(tcfg), device="cpu")
    assert tt.cfg.flags.enable_loop_closing
    for f in range(40):
        jt.process_frame(js.render_frame(scene, f, cj, n_features=512, pix_noise=0.3), f)
        tt.process_frame(ts.render_frame(scene, f, ct, n_features=512, pix_noise=0.3, device="cpu"), f)
    assert tt.state == jt.state == ttr.Tracker.OK
    assert [f for f, _ in tt.trajectory] == [f for f, _ in jt.trajectory] and len(tt.trajectory) >= 30
    assert tt._kf_fids == jt._kf_fids and len(tt._kf_fids) >= 2, (tt._kf_fids, jt._kf_fids)
    for (f, T_t), (_, T_j) in zip(tt.trajectory, jt.trajectory):
        np.testing.assert_allclose(T_t, T_j, rtol=0, atol=POSE_TOL, err_msg=f"frame {f}")
    n_j, n_t = jt.live_points(), tt.live_points()
    assert abs(n_t - n_j) <= 0.01 * n_j, (n_t, n_j)
