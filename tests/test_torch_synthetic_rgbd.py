"""The port's RGB-D ``Tracker`` driven through ``process_frame`` by the
synthetic room of ``io/synthetic.py``, against the JAX package's, on the
CPU, with the plane and cuboid detections of ``render_plane_detections``
and ``render_cuboid_detections`` and the plane factors in BA.

The room of ``make_room_scene(800, seed=0, with_planes=True,
with_cuboids=True)`` with depth (``render_frame(with_depth=True)``, bf 40),
512 features, ``tests/test_semantic.py``'s capacities and semantic flags
(plane and cuboid detection, cuboids associated by class, the 3D plane
factors and the 2D cuboid factors in the local BA), loop closing off, and
a keyframe at least every 3 frames (as ``tests/test_rgbd.py``: this room
makes no other RGB-D keyframe), so that every local BA past the
initialization keyframe holds plane factors and the later ones hold cuboid
factors.

Tolerances: the tracked frame ids, the keyframe frame ids, the map planes
and cuboids made and the valid factors of each bundle summed over the local
BAs equal; every tracked pose within 5e-4 (the map is metric, so there is
no scale to drift: the depth-sensor parity tests' tolerance; 1.4e-5 when
written, with keyframes at frames 0, 3, ..., 15, 3 planes, 2 cuboids, 39
plane and 15 bbox factors).
"""

import dataclasses

import numpy as np

import _torch_scene  # noqa: F401  (caps torch's threads per worker)
from tpuslam.core import camera as jcam
from tpuslam.core import config as jcfg
from tpuslam.frontend import tracking as jtr
from tpuslam.graph import lm as jlm
from tpuslam.io import synthetic as js
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.frontend import tracking as ttr
from tpuslam_torch.io import synthetic as ts

N_FRAMES = 16
POSE_TOL = 5e-4
CAM_ARGS = (500.0, 500.0, 320.0, 240.0)


def _cfg(mod):
    cfg = mod.SlamConfig().replace(
        sensor="rgbd",
        caps=mod.Capacities(max_keypoints=512, max_keyframes=64, max_points=8192, max_planes=16, max_cuboids=8,
                            max_planes_per_frame=8, max_cuboids_per_frame=4, local_ba_keyframes=8,
                            local_ba_fixed_keyframes=8, local_ba_points=2048),
        flags=mod.FeatureFlags(detect_plane=True, detect_object=True, associate_cuboid_with_classname=True,
                               optimize_with_plane_3d=True, optimize_with_cuboid_2d=True,
                               enable_loop_closing=False, distributed_ba=False),
        semantic=dataclasses.replace(mod.SlamConfig().semantic, cuboid_min_own_points=8),
    )
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=3))


def test_rgbd_process_frame_with_plane_and_cuboid_bundles_matches_reference(monkeypatch):
    scene = js.make_room_scene(n_points=800, n_frames=N_FRAMES, seed=0, with_planes=True, with_cuboids=True)
    cj, ct = jcam.Camera.make(*CAM_ARGS, bf=40.0), Camera.make(*CAM_ARGS, "cpu", bf=40.0)
    jt = jtr.Tracker(cj, _cfg(jcfg))
    tt = ttr.Tracker(ct, _cfg(tcfg), device="cpu")
    caps = tt.cfg.caps
    jfac = {"plane_obs": 0, "cub_bbox": 0, "stereo": 0}
    local_ba = jlm.local_ba

    def counted(state, data, w, **kw):
        for k in jfac:
            jfac[k] += int(np.asarray(getattr(data, k).valid).sum())
        return local_ba(state, data, w, **kw)

    monkeypatch.setattr(jlm, "local_ba", counted)
    for f in range(N_FRAMES):
        jt.process_frame(js.render_frame(scene, f, cj, n_features=512, with_depth=True), f,
                         plane_det=js.render_plane_detections(scene, f, caps.max_planes_per_frame),
                         cuboid_det=js.render_cuboid_detections(scene, f, cj, caps.max_cuboids_per_frame))
        tt.process_frame(ts.render_frame(scene, f, ct, n_features=512, with_depth=True, device="cpu"), f,
                         plane_det=ts.render_plane_detections(scene, f, caps.max_planes_per_frame, device="cpu"),
                         cuboid_det=ts.render_cuboid_detections(scene, f, ct, caps.max_cuboids_per_frame,
                                                                device="cpu"))
    assert tt.state == jt.state == ttr.Tracker.OK
    assert [f for f, _ in tt.trajectory] == [f for f, _ in jt.trajectory] == list(range(N_FRAMES))
    assert tt._kf_fids == jt._kf_fids and len(tt._kf_fids) >= 4, (tt._kf_fids, jt._kf_fids)
    assert tt.n_plane == jt.n_plane >= 2 and tt.n_cub == jt.n_cub >= 1, (tt.n_plane, jt.n_plane, tt.n_cub, jt.n_cub)
    tfac = {k: int(tt.ba_factors.get(k, 0)) for k in jfac}
    assert tfac == jfac and jfac["plane_obs"] > 0 and jfac["cub_bbox"] > 0, (tfac, jfac)
    for (f, T_t), (_, T_j) in zip(tt.trajectory, jt.trajectory):
        np.testing.assert_allclose(T_t, T_j, rtol=0, atol=POSE_TOL, err_msg=f"frame {f}")
