"""Parity of the port's global BA (tpuslam_torch.backend.local_ba:
``_ba_bucket``, ``pack_global_ba``, ``_reanchor_points``, ``run_global_ba``)
with the JAX package, on the CPU, on ``tests/test_global_ba.py``'s map: 128
keyframes of 64 observations over 1500 points, the poses and points
perturbed, a 16-keyframe and 256-point base budget so that both buckets grow.

Tolerances: bucket sizes, the packed ids and masks exact; the chi2 of
each trial within 1e-5 relative (float32 normal equations summed in another
order); after two LM iterations the poses within 2e-4 and the points within
1e-3 m.  After ten the chi2 sits on its floor (433.805 in both packages)
and the further accepted steps wander along directions the chi2 barely
sees (slot 0 alone is fixed, so the mono scale is free): poses within 2e-3
and points within 1e-2 m (6.3e-4 and 3.2e-3 where this test was written),
and the mean error of keyframes 1-127 against the truth within 2% of the
reference's.  Re-anchored points within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_loop_scene as ls
from test_global_ba import CAM, NKF, build
from tpuslam.backend import local_ba as jba
from tpuslam_torch.backend import local_ba as tba
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera

TCAM = Camera.make(CAM.fx, CAM.fy, CAM.cx, CAM.cy, "cpu", width=CAM.width, height=CAM.height)


def _tcfg(cfg_j):
    c = cfg_j.caps
    caps = tcfg.Capacities(**{k: getattr(c, k) for k in tcfg.Capacities.__dataclass_fields__})
    return tcfg.SlamConfig(caps=caps)


def _assert_poses(m_t, m_j, pose_tol, point_tol):
    np.testing.assert_allclose(m_t.kf_pose.numpy(), np.asarray(m_j.kf_pose), atol=pose_tol)
    np.testing.assert_allclose(m_t.pt_pos.numpy(), np.asarray(m_j.pt_pos), atol=point_tol)
    np.testing.assert_array_equal(m_t.pt_valid.numpy(), np.asarray(m_j.pt_valid))
    np.testing.assert_array_equal(m_t.kf_pt.numpy(), np.asarray(m_j.kf_pt))


@pytest.mark.parametrize("args", [(10, 16, 512), (65, 64, 512), (128, 64, 512), (129, 64, 512), (9999, 64, 512),
                                  (1500, 256, 2048), (0, 64, 512)])
def test_ba_bucket_matches_reference(args):
    assert tba._ba_bucket(*args) == jba._ba_bucket(*args)


def test_pack_global_ba_matches_reference():
    cfg, m, _, _ = build()
    pack_j = jba.pack_global_ba(m, CAM, n_kfs=128, n_pts=2048)
    pack_t = tba.pack_global_ba(ls.tmap(m), TCAM, n_kfs=128, n_pts=2048)
    for key in ("window_ids", "window_mask", "point_ids", "point_mask"):
        np.testing.assert_array_equal(getattr(pack_t, key).numpy(), np.asarray(getattr(pack_j, key)), err_msg=key)
    for key in ("kf", "pt", "valid"):
        np.testing.assert_array_equal(getattr(pack_t.data.mono, key).numpy(),
                                      np.asarray(getattr(pack_j.data.mono, key)), err_msg=key)
    np.testing.assert_array_equal(pack_t.data.pose_fixed.numpy(), np.asarray(pack_j.data.pose_fixed))


def test_global_ba_matches_reference_above_slot_64():
    cfg, m, gt, noisy = build()
    m_j, chi2_j = jba.run_global_ba(m, CAM, cfg, n_iters=10, n_kf=NKF)
    m_t, chi2_t = tba.run_global_ba(ls.tmap(m), TCAM, _tcfg(cfg), n_iters=10, n_kf=NKF)
    np.testing.assert_allclose(chi2_t.numpy(), np.asarray(chi2_j), rtol=1e-5)
    _assert_poses(m_t, m_j, 2e-3, 1e-2)

    def err(poses, lo=1):
        return np.linalg.norm(poses[lo:, :3, 3] - gt[lo:, :3, 3], axis=1).mean()

    assert abs(err(m_t.kf_pose.numpy()) - err(np.asarray(m_j.kf_pose))) <= 0.02 * err(np.asarray(m_j.kf_pose))
    assert err(m_t.kf_pose.numpy(), 64) < 0.55 * err(noisy, 64)


def test_reanchor_matches_reference():
    cfg, m, _, _ = build()
    shift = np.asarray(m.kf_pose).copy()
    shift[:, 0, 3] += 0.5
    shift[:, :3, :3] = np.asarray(m.kf_pose)[:, :3, :3] @ np.asarray(
        __import__("tpuslam.core.geometry", fromlist=["x"]).so3_exp(jnp.array([0.0, 0.01, 0.0])))
    skip = np.zeros(m.pt_pos.shape[0], bool)
    skip[:100] = True
    m_j = jba._reanchor_points(m._replace(kf_pose=jnp.asarray(shift)), m.kf_pose, jnp.asarray(skip))
    m_t = tba._reanchor_points(ls.tmap(m).replace(kf_pose=ls.t(shift)), ls.t(np.asarray(m.kf_pose)), ls.t(skip))
    np.testing.assert_allclose(m_t.pt_pos.numpy(), np.asarray(m_j.pt_pos), atol=1e-5)
    np.testing.assert_array_equal(m_t.pt_pos.numpy()[:100], np.asarray(m.pt_pos)[:100])


def test_global_ba_abort_between_chunks_matches_reference():
    cfg, m, _, _ = build()
    polls_j, polls_t = [], []
    m_j, chi2_j = jba.run_global_ba(m, CAM, cfg, n_iters=10, n_kf=NKF, chunk=2,
                                    should_abort=lambda: polls_j.append(1) or True)
    m_t, chi2_t = tba.run_global_ba(ls.tmap(m), TCAM, _tcfg(cfg), n_iters=10, n_kf=NKF, chunk=2,
                                    should_abort=lambda: polls_t.append(1) or True)
    assert len(polls_t) == len(polls_j) == 1
    assert chi2_t.shape[0] == np.asarray(chi2_j).shape[0] == 2
    np.testing.assert_allclose(chi2_t.numpy(), np.asarray(chi2_j), rtol=1e-5)
    _assert_poses(m_t, m_j, 2e-4, 1e-3)
    # never aborted: every chunk runs and the hook is polled between them
    polls = []
    _, chi2_all = tba.run_global_ba(ls.tmap(m), TCAM, _tcfg(cfg), n_iters=10, n_kf=NKF, chunk=2,
                                    should_abort=lambda: polls.append(1) and False)
    assert chi2_all.shape[0] == 10 and len(polls) == 4
