"""Parity of the port's loop closer (tpuslam_torch.place.loop) with the JAX
package's, on the CPU, on ``tests/test_loop_e2e.py``'s drifted revisit: 12
keyframes, the last one revisiting keyframe 0's view in a Sim3-drifted
world through duplicate points.  Each of that file's four cases runs
through both ``LoopCloser.on_keyframe`` with the same map and the same
prior groups; the port's Sim3 RANSAC gets the reference's draw.

Each case holds: the same decision; every keyframe pose and live point
within 1e-4 (the essential graph and the Sim3 refinement are float32 solves
summed in another order; 1.9e-6 and 3.1e-6 where this test was written);
the BoW rows within 1e-6; the same live points after the merge, the same
bindings and the same consistency groups and streaks.  Also:
``chip_smoke.revisit_map`` (phase 11, numpy and the port) makes the
fixture's map within 1e-6, and ``_correct_semantics_for_sim3`` on a map
with planes and cuboids agrees within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_loop_scene as ls
import chip_smoke
import test_loop_e2e as e2e
from tpuslam.place import loop as jloop
from tpuslam.place import vocab as jvb
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.map import mapstate as tms
from tpuslam_torch.place import loop as tloop
from tpuslam_torch.place import vocab as tvb


def _port_closer(cam_j, cfg_j, vocab_j, monkeypatch):
    monkeypatch.setattr(tloop.LoopCloser, "_sim3_samples",
                        lambda self, valid, kf: ls.torch_draw(valid, kf, self.cfg.loop.sim3_ransac_max_iters, 3))
    cam = Camera.make(float(cam_j.fx), float(cam_j.fy), float(cam_j.cx), float(cam_j.cy), "cpu",
                      width=cam_j.width, height=cam_j.height)
    caps = tcfg.Capacities(**{k: getattr(cfg_j.caps, k) for k in tcfg.Capacities.__dataclass_fields__})
    vocab = tvb.Vocabulary(centers_pm1=ls.t(vocab_j.centers_pm1))
    return tloop.LoopCloser(vocab, cam, tcfg.SlamConfig(caps=caps))


def _scramble(m, vocab):
    """test_guided_match_gate_rejects_borderline_candidate's map: 25 shared
    descriptors between the loop side and the revisit."""
    rng = np.random.RandomState(17)
    n_shared, NPT = 25, e2e.NPT
    scramble = rng.randint(0, 1 << 32, (NPT - n_shared, 8), dtype=np.uint64).astype(np.uint32)
    pt_desc = np.array(m.pt_desc)
    pt_desc[100 + n_shared:100 + NPT] = scramble
    kd = np.array(m.kf_desc)
    kd[11, n_shared:NPT] = scramble
    m = m._replace(pt_desc=jnp.asarray(pt_desc), kf_desc=jnp.asarray(kd))
    return m._replace(kf_bow=m.kf_bow.at[11].set(jvb.bow_vector(vocab, m.kf_desc[11], m.kf_kp_valid[11])))


def _groups(case, K):
    g = np.zeros(K, bool)
    if case in ("closes", "gate_40"):
        g[:11] = True  # keyframe 0's group, seen twice before
    elif case == "covisible_prior":
        g[5] = True  # keyframe 5 alone, covisible with keyframe 0
    elif case == "invalid_prior":
        g[14] = True  # an empty slot: intersects nothing
    else:
        return []
    return [(g, 2)]


CASES = {  # case: (closes, what the reference test checks)
    "closes": True,  # test_loop_closes_drifted_revisit
    "gate_40": False,  # test_guided_match_gate_rejects_borderline_candidate
    "covisible_prior": True,  # test_group_consistency_accepts_covisible_prior_group
    "first_sighting": False,  # test_group_consistency_hard_negative_single_sighting
    "invalid_prior": False,  # its second half
}


@pytest.mark.parametrize("case", list(CASES))
def test_loop_closer_matches_reference(case, monkeypatch):
    cam_j, cfg_j, m_j, vocab_j, T0, _, _ = e2e.build()
    if case == "gate_40":
        m_j = _scramble(m_j, vocab_j)
    K = m_j.kf_valid.shape[0]
    lc_j = jloop.LoopCloser(vocab_j, cam_j, cfg_j)
    lc_j.prev_groups = _groups(case, K)
    lc_t = _port_closer(cam_j, cfg_j, vocab_j, monkeypatch)
    lc_t.prev_groups = [(g.copy(), s) for g, s in _groups(case, K)]
    m_t = ls.tmap(m_j)
    pts_before = int(np.asarray(m_j.pt_valid).sum())
    out_j, closed_j = lc_j.on_keyframe(m_j, 11, 12)
    out_t, closed_t = lc_t.on_keyframe(m_t, 11, 12)
    assert closed_t == closed_j == CASES[case]
    np.testing.assert_allclose(out_t.kf_bow.numpy(), np.asarray(out_j.kf_bow), atol=1e-6)
    np.testing.assert_allclose(out_t.kf_pose.numpy(), np.asarray(out_j.kf_pose), atol=1e-4)
    live = np.asarray(out_j.pt_valid)
    np.testing.assert_array_equal(out_t.pt_valid.numpy(), live)
    np.testing.assert_allclose(out_t.pt_pos.numpy()[live], np.asarray(out_j.pt_pos)[live], atol=1e-4)
    np.testing.assert_array_equal(out_t.kf_pt.numpy(), np.asarray(out_j.kf_pt))
    assert [s for _, s in lc_t.prev_groups] == [s for _, s in lc_j.prev_groups]
    for (g_t, _), (g_j, _) in zip(lc_t.prev_groups, lc_j.prev_groups):
        np.testing.assert_array_equal(g_t, g_j)
    assert lc_t.kf_seen == lc_j.kf_seen and lc_t.n_loops_closed == lc_j.n_loops_closed
    if closed_t:
        assert set(lc_t.stage_ms) == set(lc_j.stage_ms) == {"bow", "stats", "gates", "sim3", "correct"}
        drift_before = float(np.linalg.norm((np.asarray(m_j.kf_pose[11]) - T0)[:3, 3]))
        drift_after = float(np.linalg.norm((out_t.kf_pose[11].numpy() - T0)[:3, 3]))
        assert drift_after < 0.5 * drift_before
        if case == "closes":
            assert int(out_t.pt_valid.sum()) <= pts_before - 30
            kf11_pt = out_t.kf_pt[11].numpy()[:e2e.NPT]
            assert (kf11_pt[kf11_pt >= 0] < e2e.NPT).sum() >= 30
    else:
        np.testing.assert_array_equal(out_t.kf_pose[11].numpy(), np.asarray(m_j.kf_pose[11]))


def test_chip_smoke_revisit_map_matches_the_fixture():
    _, _, m_j, vocab_j, T0_j, T11_j, _ = e2e.build()
    _, _, m_t, vocab_t, T0, T11 = chip_smoke.revisit_map("cpu")
    np.testing.assert_array_equal(vocab_t.centers_pm1.numpy(), np.asarray(vocab_j.centers_pm1))
    got, want = tms.map_to_numpy(m_t), {k: np.asarray(getattr(m_j, k)) for k in m_j._fields}
    for k in tms.FIELDS:
        if want[k].dtype.kind in "iub":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(T11, T11_j, atol=1e-6)


def test_correct_semantics_for_sim3_matches_reference():
    """Planes and cuboids follow their latest observer keyframe through a
    Sim3 correction, on the revisit map given 3 planes and 2 cuboids seen by
    several keyframes (one plane seen by none, one cuboid invalid)."""
    _, _, m_j, _, _, _, _ = e2e.build()
    K, L = m_j.kf_plane_map.shape
    O = m_j.kf_cub_map.shape[1]
    rng = np.random.RandomState(8)
    pm = -np.ones((K, L), np.int32)
    pv = np.zeros((K, L), bool)
    for k, q in ((2, 0), (7, 0), (4, 1), (11, 1), (3, 2)):
        pm[k, q % L] = q
        pv[k, q % L] = True
    pv[3, 2] = False  # plane 2: its only sighting is invalid
    cm = -np.ones((K, O), np.int32)
    cv = np.zeros((K, O), bool)
    cm[5, 0], cv[5, 0] = 0, True
    cm[9, 1], cv[9, 1] = 1, True
    n = rng.normal(size=(4, 3)).astype(np.float32)
    coef = np.concatenate([n / np.linalg.norm(n, axis=1, keepdims=True), rng.uniform(0.5, 3, (4, 1))], 1)
    cub_pose = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    cub_pose[:, :3, 3] = rng.normal(size=(2, 3))
    m_j = m_j._replace(
        kf_plane_map=jnp.asarray(pm), kf_plane_valid=jnp.asarray(pv), plane_coef=jnp.asarray(coef.astype(np.float32)),
        plane_valid=jnp.asarray(np.array([True, True, True, False])), kf_cub_map=jnp.asarray(cm),
        kf_cub_valid=jnp.asarray(cv), cub_pose=jnp.asarray(cub_pose),
        cub_scale=jnp.asarray(rng.uniform(0.2, 1, (2, 3)).astype(np.float32)), cub_valid=jnp.asarray([True, False]))
    from tpuslam.core import geometry as jgeo

    xi = rng.normal(0, 0.1, (K, 7)).astype(np.float32)
    S_old = np.asarray(m_j.kf_pose)
    S_new = np.asarray(jgeo.sim3_exp(jnp.asarray(xi)) @ jnp.asarray(S_old))
    out_j = jloop._correct_semantics_for_sim3(m_j, jnp.asarray(S_old), jnp.asarray(S_new))
    out_t = tloop._correct_semantics_for_sim3(ls.tmap(m_j), ls.t(S_old), ls.t(S_new))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert not np.allclose(out_t[0].numpy()[:2], coef[:2])  # observed planes moved
    np.testing.assert_array_equal(out_t[0].numpy()[2:], coef[2:].astype(np.float32))  # unobserved ones stay
