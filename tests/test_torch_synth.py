"""Parity of the port's golden-sequence renderer (tpuslam_torch.io.synth),
trajectory tools (io/trajectory.py), profiler and the app's trajectory
reconstruction (apps/common.py) with the JAX package, on the CPU.

Tolerances: the uint8 frames and primitive ids equal the numpy oracle
``tpuslam.io.synth.render_frame`` on every pixel (the float depth within
2e-6 relative: its ray directions are summed elementwise, the oracle's by
BLAS); the trajectory, the Umeyama fit and the ATE equal the reference's
(to 1e-12, float64); the quaternion, in float32, within 2e-7 (XLA orders
its float32 sums its own way), so the TUM files hold the same stamps and
translations and quaternions within 2e-7; the reconstructed trajectory
equal to 1e-12.
"""

import numpy as np
import pytest
import torch

from tpuslam.apps.common import _corrected_trajectory
from tpuslam.core import geometry as jgeo
from tpuslam.io import synth as js
from tpuslam.io import trajectory as jtraj
from tpuslam.utils.profiler import Profiler as JProfiler
from tpuslam_torch.apps.common import corrected_trajectory
from tpuslam_torch.io import synth as ts
from tpuslam_torch.io import trajectory as ttraj
from tpuslam_torch.map import mapstate as tms
from tpuslam_torch.utils.profiler import Profiler

CAM = dict(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)


def test_scene_trajectory_and_planes_equal_reference():
    assert ts.SceneSpec().__dict__ == js.SceneSpec().__dict__
    assert ts.CameraSpec().__dict__ == js.CameraSpec().__dict__
    np.testing.assert_array_equal(ts.room_planes(ts.SceneSpec()), js.room_planes(js.SceneSpec()))
    for n, angle in ((560, 400.0), (150, 400.0 * 150 / 560)):
        np.testing.assert_array_equal(ts.trajectory(n, ts.SceneSpec(), total_angle_deg=angle),
                                      js.trajectory(n, js.SceneSpec(), total_angle_deg=angle))
    for a, b in zip(ts._box_frames(ts.SceneSpec()), js._box_frames(js.SceneSpec())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("frames", [(0, 97, 233), (301, 420, 559)])
def test_renderer_equals_numpy_oracle_on_every_pixel(frames):
    poses = js.trajectory(560, js.SceneSpec())[list(frames)]
    r = ts.make_batch_renderer(ts.CameraSpec(**CAM), ts.SceneSpec(), "cpu")
    gray, depth, pid = r(torch.from_numpy(poses))
    u8 = ts.render_uint8(r, poses, chunk=2)
    for j, T in enumerate(poses):
        g0, d0, id0, _ = js.render_frame(T, js.CameraSpec(**CAM), js.SceneSpec())
        np.testing.assert_array_equal(u8[j].numpy(), g0.astype(np.uint8))
        np.testing.assert_array_equal(gray[j].numpy(), g0)
        np.testing.assert_array_equal(pid[j].numpy(), id0)
        np.testing.assert_allclose(depth[j].numpy(), d0, rtol=2e-6)
    assert u8.dtype == torch.uint8 and len(np.unique(pid.numpy())) > 4


def _poses(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xi = rng.normal(0, [0.4, 0.4, 0.4, 1.0, 1.0, 1.0]).astype(np.float32)
        out.append(np.asarray(jgeo.se3_exp(xi)))
    return out


def test_ate_umeyama_quat_and_tum_equal_reference(tmp_path):
    est, gt = _poses(40, 0), _poses(40, 1)
    est[7] = np.full((4, 4), np.nan, np.float32)  # dropped by both
    for with_scale in (True, False):
        r_ref, e_ref = jtraj.ate_rmse(est, gt, with_scale=with_scale)
        r_got, e_got = ttraj.ate_rmse(est, gt, with_scale=with_scale)
        assert abs(r_got - r_ref) <= 1e-12 and np.allclose(e_got, e_ref, rtol=0, atol=1e-12)
    src = np.random.RandomState(2).normal(size=(30, 3))
    for a, b in zip(ttraj.umeyama_alignment(src, 2 * src + 1), jtraj.umeyama_alignment(src, 2 * src + 1)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for T in _poses(20, 3):
        np.testing.assert_allclose(ttraj.R_to_quat(T[:3, :3]), np.asarray(jgeo.R_to_quat(T[:3, :3])),
                                   rtol=0, atol=2e-7)
    poses = _poses(12, 4)
    jtraj.save_tum(tmp_path / "ref.txt", range(12), poses)
    ttraj.save_tum(tmp_path / "got.txt", range(12), poses)
    got, ref = np.loadtxt(tmp_path / "got.txt"), np.loadtxt(tmp_path / "ref.txt")
    np.testing.assert_array_equal(got[:, :4], ref[:, :4])
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=0, atol=2e-7)


def test_profiler_aggregates_like_reference():
    out = []
    for P in (Profiler, JProfiler):
        p = P()
        for name in ("a", "b", "a"):
            with p.section(name):
                pass
        out.append({k: v["count"] for k, v in p.aggregate().items()})
    assert out[0] == out[1] == {"a": 2, "b": 1}


class _StubTracker:
    """What the trajectory reconstruction reads of a tracker."""

    def __init__(self, m, trajectory, traj_rel):
        self.map, self.trajectory, self.traj_rel = m, trajectory, traj_rel


def test_corrected_trajectory_equals_reference():
    """Frames chained through live, culled and missing reference keyframes."""
    K = 6
    poses = np.stack(_poses(K, 5)).astype(np.float32)
    kf_valid = np.array([True, False, True, True, False, True])
    kf_fid = np.array([0, 4, 9, 15, 20, 26], np.int32)
    rng = np.random.RandomState(6)
    traj = [(f, _poses(1, 100 + f)[0]) for f in range(30) if f not in (2, 3)]
    ref_of = {f: max(i for i in range(K) if kf_fid[i] <= f and (kf_fid[i] < f or i == 0)) for f, _ in traj}
    traj_rel = {f: (ref_of[f], int(kf_fid[ref_of[f]]), rng.normal(size=(4, 4)).astype(np.float32))
                for f, _ in traj if f not in (11, 0)}

    class JMap:
        pass

    jm = JMap()
    jm.kf_valid, jm.kf_frame_id, jm.kf_pose = kf_valid, kf_fid, poses
    tm = tms.MapState(**{k: None for k in tms.FIELDS})
    tm = tm.replace(kf_valid=torch.from_numpy(kf_valid), kf_frame_id=torch.from_numpy(kf_fid),
                    kf_pose=torch.from_numpy(poses))
    ref = _corrected_trajectory(_StubTracker(jm, traj, traj_rel))
    got = corrected_trajectory(_StubTracker(tm, traj, traj_rel))
    assert [f for f, _ in got] == [f for f, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
