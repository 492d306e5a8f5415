"""The port's Tracker for the depth sensors against the JAX package's, on the
CPU, loop closing off, 512 features at 320x240 (fx = fy = 260, bf = 19.5):

* RGB-D over the first 7 golden frames rendered by the numpy oracle
  ``synth.render_frame``, the image truncated to uint8 and the depth stored
  and read back as the golden PNGs hold it, with planes segmented online on
  every frame (``detect_planes_online``) and associated with the map at
  each keyframe (the plane factors' BA, a JAX compile of its own, is held
  to the reference in ``test_torch_ba_semantic.py``);
* stereo (points only) over the first 7 golden pairs, the right view
  rendered at the camera moved 0.075 m along its own +x axis.

Both initialize on frame 0 from depth; ``max_frames_between_kf = 3`` (as in
``tests/test_rgbd.py``) makes keyframes at frames 3 and 6, so densification,
the local mapping step and a local BA with the stereo bundle run.

Tolerances: the tracked frame ids, the keyframe frame ids and the planes
made equal; every tracked pose within 5e-4 (rotation and translation
entries; the maps are metric, so there is no scale to drift, and the two
packages' poses differ by float32 rounding in the pose LM and BA: 3.8e-5
where this test was written); the live point counts within 1%.
"""

import dataclasses
import functools

import numpy as np
import torch

import _torch_scene as sc
from tpuslam.core import camera as jcam
from tpuslam.core import config as jcfg
from tpuslam.frontend import tracking as jtr
from tpuslam.io import synth as js
from tpuslam.semantic import detect as jdet
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.frontend import tracking as ttr
from tpuslam_torch.io import synth as ts
from tpuslam_torch.semantic import detect as tdet

N_FEAT = 512
C = sc.CSPEC
POSE_TOL = 5e-4


def _cfg(mod, sensor):
    flags = mod.FeatureFlags(enable_loop_closing=False)
    if sensor == "rgbd":
        flags = dataclasses.replace(flags, detect_plane=True)
    cfg = mod.SlamConfig().replace(
        sensor=sensor,
        caps=mod.Capacities(max_keypoints=N_FEAT, max_keyframes=16, max_points=4096, max_planes=16, max_cuboids=4,
                            local_ba_keyframes=4, local_ba_fixed_keyframes=4, local_ba_points=1024),
        orb=mod.OrbConfig(n_features=N_FEAT), flags=flags,
    )
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=3))


def _cams():
    args = (C.fx, C.fy, C.cx, C.cy)
    kw = dict(width=C.width, height=C.height, bf=C.fx * C.baseline)
    return jcam.Camera.make(*args, **kw), Camera.make(*args, "cpu", **kw)


@functools.lru_cache(maxsize=None)
def _render(n, right):
    spec = js.SceneSpec()
    poses = js.trajectory(560, spec, total_angle_deg=400.0)[:n]
    out = []
    for T in poses:
        gray, depth, _, _ = js.render_frame(T, C, spec)
        d = np.clip(depth * 5000, 0, 65535).astype(np.uint16).astype(np.float32) / 5000.0
        r = js.render_frame(ts.right_poses(T[None], C.baseline)[0], C, spec)[0].astype(np.uint8) if right else None
        out.append((gray.astype(np.uint8), d, r))
    return out


def _assert_same_run(jt, tt):
    assert [f for f, _ in tt.trajectory] == [f for f, _ in jt.trajectory]
    assert tt._kf_fids == jt._kf_fids and len(jt._kf_fids) >= 3, (tt._kf_fids, jt._kf_fids)
    for (f, Tg), (_, Tr) in zip(tt.trajectory, jt.trajectory):
        np.testing.assert_allclose(np.asarray(Tg), np.asarray(Tr), rtol=0, atol=POSE_TOL, err_msg=f"frame {f}")
    n_j, n_t = jt.live_points(), tt.live_points()
    assert abs(n_t - n_j) <= 0.01 * n_j, (n_t, n_j)


def test_rgbd_tracker_with_online_planes_matches_reference():
    jc, tc = _cams()
    jt = jtr.Tracker(jc, _cfg(jcfg, "rgbd"))
    tt = ttr.Tracker(tc, _cfg(tcfg, "rgbd"), device="cpu")
    cap = jt.cfg.caps.max_planes_per_frame
    for fid, (gray, depth, _) in enumerate(_render(7, False)):
        jt.process_image(gray, fid, depth=depth, plane_det=jdet.detect_planes_online(depth, jc, cap))
        d = torch.from_numpy(depth)
        tt.process_image(gray, fid, depth=d, plane_det=tdet.detect_planes_online(d, tc, cap))
    jt.flush()
    tt.flush()
    assert jt.trajectory[0][0] == tt.trajectory[0][0] == 0
    _assert_same_run(jt, tt)
    assert tt.n_plane == jt.n_plane >= 1
    assert int(tt.ba_factors["stereo"]) > 0


def test_stereo_tracker_matches_reference():
    jc, tc = _cams()
    jt = jtr.Tracker(jc, _cfg(jcfg, "stereo"))
    tt = ttr.Tracker(tc, _cfg(tcfg, "stereo"), device="cpu")
    for fid, (gray, _, right) in enumerate(_render(7, True)):
        jt.process_stereo_pair(gray, right, fid)
        tt.process_stereo_pair(gray, right, fid)
    assert jt.trajectory[0][0] == tt.trajectory[0][0] == 0
    _assert_same_run(jt, tt)
    assert min(int(n) for n in tt.stereo_matches) > 100
    assert int(tt.ba_factors["stereo"]) > 0
