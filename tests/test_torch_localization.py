"""Localization mode of the port's ``Tracker`` (``set_localization_mode``,
``_localization_fallback``, ``match_motion_model_vo``), on the CPU.

* ``match_motion_model_vo`` against the JAX package's on one synthetic pair
  (poses within 1e-4, inlier counts equal);
* RGB-D over the first golden frames at 320x240 (512 features, a keyframe
  every 3 frames, loop closing on so relocalization runs), checkpointed,
  resumed and replayed in localization mode: the first frame relocalizes,
  every frame is tracked within 3 cm of the truth (metric), no keyframe is
  made, every ``MapState`` tensor but the found/visible counters stays
  equal bit for bit, and the tracked frames commit those counters, as the
  reference does;
* the fallback's visual odometry places a frame that map tracking and
  relocalization lose (its motion from the last frame within 1 cm and 0.5
  degrees of the truth: 7 mm and 0.13 degrees where this test was written,
  the rotation about the vertical traded against the lateral shift);
* the reference's fault, mirrored: a pipelined frame placed by the fallback
  does not feed the device chain (ROADMAP section 3).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_loop_scene  # noqa: F401  (caps torch's threads)
from tpuslam.core import camera as jcam
from tpuslam.frontend import tracking as jtr
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.frontend import tracking as ttr
from tpuslam_torch.io import checkpoint as tck
from tpuslam_torch.io import synth as ts
from tpuslam_torch.map import mapstate as tms

CSPEC = ts.CameraSpec(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)
N_FEAT = 512
N_MAP, N_LOC = 10, 8


def _cam():
    return Camera.make(CSPEC.fx, CSPEC.fy, CSPEC.cx, CSPEC.cy, "cpu", width=CSPEC.width, height=CSPEC.height,
                       bf=CSPEC.fx * CSPEC.baseline)


def _cfg():
    cfg = tcfg.SlamConfig().replace(
        sensor="rgbd",
        caps=tcfg.Capacities(max_keypoints=N_FEAT, max_keyframes=16, max_points=4096, local_ba_keyframes=4,
                             local_ba_fixed_keyframes=4, local_ba_points=1024),
        orb=tcfg.OrbConfig(n_features=N_FEAT))
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=3))


@functools.lru_cache(maxsize=None)
def _frames():
    poses = ts.trajectory(560, ts.SceneSpec(), total_angle_deg=400.0)[:N_MAP + N_LOC]
    gray, depth = ts.render_uint8(ts.make_batch_renderer(CSPEC, ts.SceneSpec(), "cpu"), poses, depth=True)
    # world->camera truth in the map's frame, which is frame 0's camera (the
    # depth sensors initialize there, metric)
    Tcw = np.linalg.inv(poses.astype(np.float64))
    return gray, depth, Tcw @ np.linalg.inv(Tcw[0])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    gray, depth, _ = _frames()
    tr = ttr.Tracker(_cam(), _cfg(), device="cpu")
    for i in range(N_MAP):
        tr.process_image(gray[i], i, depth=depth[i])
    tr.flush()
    assert tr.state == tr.OK and tr.n_kf >= 3
    path = str(tmp_path_factory.mktemp("ck") / "map.npz")
    tck.save_tracker(path, tr)
    return path


def _resume(path):
    tr = tck.load_tracker(path, _cam(), _cfg(), device="cpu")
    tr.set_localization_mode(True)
    return tr


COUNTERS = ("pt_found", "pt_visible")  # committed by every tracked frame, localization mode too


def _maps_equal(a, b):
    return [k for k in tms.FIELDS if k not in COUNTERS and not torch.equal(getattr(a, k), getattr(b, k))]


def test_match_motion_model_vo_equals_reference():
    rng = np.random.RandomState(7)
    N = 160
    pts = rng.uniform([-2, -1.5, 3], [2, 1.5, 6], (N, 3)).astype(np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0.03, -0.01, 0.02]
    fx = cx = 200.0

    def proj(T):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        return np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fx * pc[:, 1] / pc[:, 2] + cx], -1).astype(np.float32), pc[:, 2]

    uv0, z0 = proj(np.eye(4, dtype=np.float32))
    uv1, _ = proj(T_true)
    uv1 += rng.randn(N, 2).astype(np.float32) * 0.3
    desc = rng.randint(0, 1 << 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    zeros_i, zeros_f = np.zeros(N, np.int32), np.zeros(N, np.float32)
    valid = rng.rand(N) > 0.1
    last = dict(uv=uv0, octave=zeros_i, angle=zeros_f, desc=desc, valid=valid, ur=uv0[:, 0] - 40.0 / z0,
                depth=np.where(rng.rand(N) > 0.2, z0, -1.0).astype(np.float32))
    cur = dict(uv=uv1, octave=zeros_i, angle=zeros_f, desc=desc, valid=np.ones(N, bool), ur=np.full(N, -1, np.float32),
               depth=np.full(N, -1, np.float32))
    T_pred = np.eye(4, dtype=np.float32)
    jc = jcam.Camera.make(fx, fx, cx, cx, bf=40.0)
    Tj, nj = jtr.match_motion_model_vo(jtr.Frame(**{k: jnp.asarray(v) for k, v in last.items()}), jnp.asarray(T_pred),
                                       jtr.Frame(**{k: jnp.asarray(v) for k, v in cur.items()}), jnp.asarray(T_pred),
                                       jc, 15.0)

    def tf(d):
        return ttr.Frame(**{k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v) for k, v in d.items()})

    Tt, nt = ttr.match_motion_model_vo(tf(last), torch.from_numpy(T_pred), tf(cur), torch.from_numpy(T_pred),
                                       Camera.make(fx, fx, cx, cx, "cpu", bf=40.0), 15.0)
    assert int(nt) == int(nj) >= 100
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-4)
    assert np.abs(Tt.numpy()[:3, 3] - T_true[:3, 3]).max() < 5e-3


def test_localization_mode_freezes_the_resumed_map(checkpoint):
    gray, depth, gt = _frames()
    tr = _resume(checkpoint)
    before = tms.map_from_numpy(tms.map_to_numpy(tr.map), "cpu")
    n_kf, kf_fids, n_restored = tr.n_kf, list(tr._kf_fids), len(tr.trajectory)
    for i in range(N_MAP, N_MAP + N_LOC):
        tr.process_image(gray[i], i, depth=depth[i])
    tr.flush()
    assert tr.state == tr.OK and tr.n_relocalized >= 1
    new = tr.trajectory[n_restored:]
    assert [f for f, _ in new] == list(range(N_MAP, N_MAP + N_LOC))  # the first frame relocalized
    for f, T in new:
        assert np.linalg.norm(T[:3, 3] - gt[f][:3, 3]) < 0.03, f
    assert tr.n_kf == n_kf and list(tr._kf_fids) == kf_fids and not tr.kf_decisions
    assert _maps_equal(tr.map, before) == []
    for k in COUNTERS:
        now, was = getattr(tr.map, k), getattr(before, k)
        assert bool((now >= was).all()) and int(now.sum()) > int(was.sum()), k


def test_vo_fallback_places_a_frame_map_tracking_loses(checkpoint, monkeypatch):
    """The synchronous path: the reference-keyframe match reported lost and
    relocalization failing, the frame is placed by last-frame VO."""
    gray, depth, gt = _frames()
    tr = _resume(checkpoint)
    before = tms.map_from_numpy(tms.map_to_numpy(tr.map), "cpu")
    tr.process_image(gray[N_MAP], N_MAP, depth=depth[N_MAP])  # relocalizes
    assert tr.state == tr.OK
    real = ttr.track_and_decide

    def lost(*a, **kw):
        out = real(*a, **kw)
        s = out.scalars.clone()
        s[1], s[2] = 0, 1  # n_rf = 0 with the reference-keyframe match used
        return out._replace(scalars=s)

    monkeypatch.setattr(ttr, "track_and_decide", lost)
    monkeypatch.setattr(ttr, "relocalize", lambda *a, **kw: None)
    f = N_MAP + 1
    feats = tr.extractor(gray[f].to(torch.float32))
    z, ur = ttr.sample_depth_at_keypoints(feats.uv, depth[f], tr.cam.bf)
    T_last = tr.T_cur.copy()
    T = tr.process_frame(ttr.frame_from_features(feats, tr.cam, ur=ur, depth=z), f)
    assert T is not None and tr.state == tr.OK and tr.n_vo == 1
    # VO measures the motion from the last frame (2 cm and 0.7 degrees here)
    rel, rel_gt = T @ np.linalg.inv(T_last), gt[f] @ np.linalg.inv(gt[N_MAP])
    dR = rel[:3, :3] @ rel_gt[:3, :3].T
    angle = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert np.linalg.norm(rel_gt[:3, 3]) > 0.01
    assert np.linalg.norm(rel[:3, 3] - rel_gt[:3, 3]) < 1e-2 and angle < 0.5
    assert bool((tr.last_kp_pt == -1).all())
    assert _maps_equal(tr.map, before) == []


def test_fallback_pose_does_not_reach_the_device_chain(checkpoint, monkeypatch):
    """The mirrored fault (tracking.py:636-648, 910-917 of the reference): on
    the pipelined hot path a frame is read back one call after the next one
    was dispatched from its device pose.  When that frame is lost and the
    fallback places it, the placed pose goes into the trajectory, but the
    next dispatches keep following the device outputs of the lost frame."""
    gray, depth, _ = _frames()
    tr = _resume(checkpoint)
    dispatched, lost_call = [], 3
    real = ttr.track_image_and_decide

    def recorded(m, g, d, T_cur, *a, **kw):
        out, frame = real(m, g, d, T_cur, *a, **kw)
        dispatched.append((T_cur.clone(), out.T.clone()))
        if len(dispatched) == lost_call:
            s = out.scalars.clone()
            s[3] = 0  # n_final: the local-map track failed
            out = out._replace(scalars=s)
        return out, frame

    X = np.eye(4, dtype=np.float32)
    X[:3, 3] = [9.0, 9.0, 9.0]  # where the fallback puts the lost frame

    def fallback(self, frame, T_pred):
        self.T_cur = X.copy()
        return True

    monkeypatch.setattr(ttr, "track_image_and_decide", recorded)
    monkeypatch.setattr(ttr.Tracker, "_localization_fallback", fallback)
    for i in range(N_MAP, N_MAP + 7):
        tr.process_image(gray[i], i, depth=depth[i])
    tr.flush()
    lost_fid = N_MAP + lost_call  # the first frame relocalizes, then the pipelined calls
    placed = dict(tr.trajectory[-7:])
    np.testing.assert_array_equal(placed[lost_fid], X)
    assert len(dispatched) >= lost_call + 2
    # the dispatch after the lost frame's read-back starts from the device
    # pose of the frame dispatched with it, never from X
    for T_in, _ in dispatched[lost_call:]:
        assert not np.allclose(T_in.numpy(), X)
    assert torch.equal(dispatched[lost_call + 1][0], dispatched[lost_call][1])
