"""The port's Tracker with loop closing on (its default), on the CPU, on the
first golden frames at 320x240 (fx = fy = 260, 512 features; the port's
renderer, equal to the numpy oracle): the BoW rows of the initialization
keyframes, relocalization of a LOST frame against the keyframe database,
and the frame in flight when a loop closes (a reference fault, mirrored).
Port-only: ``test_torch_loop.py`` and ``test_torch_reloc.py`` hold the loop
closer and relocalization to the JAX package.
"""

import functools

import numpy as np
import pytest
import torch

import _torch_loop_scene  # noqa: F401  (caps torch's threads)
from tpuslam_torch.apps import golden
from tpuslam_torch.core import geometry as geo
from tpuslam_torch.frontend import tracking as ttr
from tpuslam_torch.io.trajectory import umeyama_alignment
from tpuslam_torch.place import vocab as tvb


@functools.lru_cache(maxsize=None)
def _rendered(n):
    return golden.render_golden(n, golden.golden_setup(small=True)[0], "cpu")


def _tracker():
    cspec, cfg = golden.golden_setup(small=True, loops=True)
    cam = ttr.Camera.make(cspec.fx, cspec.fy, cspec.cx, cspec.cy, "cpu", width=cspec.width, height=cspec.height)
    return ttr.Tracker(cam, cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _replay(n):
    tr = _tracker()
    for fid in range(n):
        tr.process_image(_rendered(n + 1).frames[fid], fid)
    tr.flush()
    return tr


def test_loops_on_tracker_writes_bow_rows_for_its_initialization_keyframes():
    tr = _replay(12)
    assert tr.state == tr.OK and len(tr._kf_fids) >= 3
    m, vocab = tr.map, tr.loop_closer.vocab
    for slot in range(len(tr._kf_fids)):  # slots 0, 1 from initialization; the rest from the loop closer
        want = tvb.bow_vector(vocab, m.kf_desc[slot], m.kf_kp_valid[slot])
        assert torch.equal(m.kf_bow[slot], want), slot
        assert float(want.sum()) > 0
    assert float(m.kf_bow[len(tr._kf_fids):].abs().sum()) == 0
    assert tr.loop_closer.kf_seen == len(tr._kf_fids) - 2  # the loop closer saw every later keyframe


def test_lost_tracker_relocalizes_against_the_keyframe_database():
    n = 32
    tr = _replay(n)
    assert tr.n_kf > 5, tr._kf_fids  # past the tiny-map reset
    rendered = _rendered(n + 1)
    tr.state = tr.LOST
    T = tr.process_image(rendered.frames[n], n)
    assert tr.state == tr.OK and T is not None
    # the relocalized camera centre, on the ground truth after the Sim3 that
    # aligns the tracked centres (the mono map's scale is its own)
    fids = [f for f, _ in tr.trajectory]
    est = np.stack([-P[:3, :3].T @ P[:3, 3] for _, P in tr.trajectory]).astype(np.float64)
    gt = np.stack([-G[:3, :3].T @ G[:3, 3] for G in rendered.gt[fids]])
    s, R, t = umeyama_alignment(est[:-1], gt[:-1])
    res = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    assert fids[-1] == n and res[-1] < 0.05 and res[-1] <= 2 * res[:-1].max(), res


def test_loop_closure_drops_the_frame_in_flight_and_keeps_its_stale_pose_mirrored_reference_fault(monkeypatch):
    """tracking.py:633-648 of the reference: when the commit of frame n
    makes a keyframe that closes a loop, the frame n + 1 already dispatched
    from the old map is dropped, but ``_dev_T`` and ``_dev_vel`` keep frame
    n's pre-correction outputs, so frame n + 2 starts from the stale pose
    instead of the corrected ``T_cur``.  The port mirrors it.  The closure
    is simulated: the loop closer moves the new keyframe's pose, the global
    BA changes nothing."""
    tr = _tracker()
    frames = _rendered(12).frames
    for fid in range(9):
        tr.process_image(frames[fid], fid)
    assert tr.state == tr.OK and tr._pending is not None
    stale_T, stale_vel = tr._dev_T, tr._dev_vel
    pending_fid = tr._pending[0]
    shift = torch.tensor([0.05, 0.0, 0.0])

    def fake_on_keyframe(self, m, slot, n_kf, frame_id=-1, fetch=None):
        m = tvb.update_kf_bow(self.vocab, m, slot)[0]
        pose = m.kf_pose.clone()
        pose[slot, :3, 3] += shift
        return m.replace(kf_pose=pose), True

    monkeypatch.setattr(ttr.LoopCloser, "on_keyframe", fake_on_keyframe)
    monkeypatch.setattr(ttr, "run_global_ba", lambda m, cam, cfg, **kw: (m, None))
    monkeypatch.setattr(ttr.Tracker, "_need_new_keyframe", lambda self, *a: True)
    n_kf = len(tr._kf_fids)
    tr.process_image(frames[9], 9)
    assert tr.n_loops == 1 and len(tr._kf_fids) == n_kf + 1 and tr._kf_fids[-1] == pending_fid
    slot = tr.ref_kf
    assert tr._pending is None  # frame 9, dispatched on the old map, is dropped
    assert [f for f, _ in tr.trajectory][-1] == pending_fid
    np.testing.assert_array_equal(tr.T_cur, tr.map.kf_pose[slot].numpy())  # the corrected pose
    np.testing.assert_array_equal(tr.velocity, np.eye(4, dtype=np.float32))
    # the fault: the next dispatch reads the stale device pose and velocity
    assert tr._dev_T is stale_T and tr._dev_vel is stale_vel
    assert not np.allclose(tr._dev_T.numpy(), tr.T_cur, atol=1e-3)
    d = np.linalg.norm(geo.se3_inv(torch.from_numpy(tr.T_cur)).numpy()[:3, 3]
                       - geo.se3_inv(stale_T).numpy()[:3, 3])
    assert d > 0.01
