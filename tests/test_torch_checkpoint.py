"""Checkpoints across the packages (``tpuslam_torch/io/checkpoint.py``
against ``tpuslam/io/checkpoint.py``), on the CPU: a tracker checkpoint
written by the JAX package loads in the port, and one written by the port
loads in the JAX package, with every ``MapState`` field equal (the packed
descriptors, uint32 in the JAX package and int32 words in the port, by bit
view, high bits set) and the tracker's host state equal; then a port
tracker resumed from its own checkpoint relocalizes and tracks on, where the
tiny-map rule would have reset it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import camera as jcam
from tpuslam.core import config as jcfg
from tpuslam.frontend.tracking import Tracker as JTracker
from tpuslam.io import checkpoint as jck
from tpuslam.map import mapstate as jms
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.frontend.tracking import Tracker
from tpuslam_torch.io import checkpoint as tck
from tpuslam_torch.map import mapstate as tms

CAPS = dict(max_keypoints=32, max_keyframes=6, max_points=64, max_planes=4, max_cuboids=3, vocab_words=16,
            max_planes_per_frame=3, max_cuboids_per_frame=2)


def _random_fields(empty: dict, seed: int) -> dict:
    """Every field of ``empty`` (numpy, the reference's dtypes) filled at
    random: floats, ints, bools, and uint32 words across the whole range."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, a in empty.items():
        if a.dtype == np.bool_:
            out[k] = rng.random(a.shape) > 0.5
        elif a.dtype == np.uint32:
            out[k] = rng.integers(0, 1 << 32, a.shape, dtype=np.uint64).astype(np.uint32)
        elif np.issubdtype(a.dtype, np.integer):
            out[k] = rng.integers(-5, 1000, a.shape).astype(a.dtype)
        else:
            out[k] = rng.normal(size=a.shape).astype(a.dtype)
    return out


def _host_state(tr):
    return dict(state=tr.state, n_kf=tr.n_kf, n_pt=tr.n_pt, n_plane=tr.n_plane, n_cub=tr.n_cub, ref_kf=tr.ref_kf,
                frames_since_kf=tr.frames_since_kf, kf_fids=list(tr._kf_fids))


def _set_host_state(tr):
    tr.state, tr.n_kf, tr.n_pt, tr.n_plane, tr.n_cub = 1, 5, 40, 2, 1
    tr.ref_kf, tr.frames_since_kf, tr._kf_fids = 3, 2, [0, 4, 9, 13, 20]
    tr.T_cur = np.arange(16, dtype=np.float32).reshape(4, 4) / 7
    tr.velocity = np.eye(4, dtype=np.float32) * 1.5
    tr.trajectory = [(0, np.eye(4, dtype=np.float32)), (4, tr.T_cur)]


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jcfg_ = jcfg.SlamConfig(caps=jcfg.Capacities(**CAPS))
    jt = JTracker(jcam.Camera.make(300.0, 300.0, 160.0, 120.0), jcfg_)
    fields = _random_fields({k: np.asarray(v) for k, v in zip(jms.MapState._fields, jt.map)}, 0)
    jt.map = jms.MapState(*(jnp.asarray(fields[k]) for k in jms.MapState._fields))
    _set_host_state(jt)
    path = str(tmp_path / "jax.npz")
    jck.save_tracker(path, jt)

    cfg = tcfg.SlamConfig(caps=tcfg.Capacities(**CAPS))
    tt = tck.load_tracker(path, Camera.make(300.0, 300.0, 160.0, 120.0, "cpu"), cfg, device="cpu")
    got = tms.map_to_numpy(tt.map)
    assert list(got) == list(jms.MapState._fields)
    for k in jms.MapState._fields:
        assert got[k].dtype == fields[k].dtype, k
        np.testing.assert_array_equal(got[k], fields[k], err_msg=k)
    assert tt.map.kf_desc.dtype == torch.int32 and bool((tt.map.kf_desc < 0).any())  # high bits kept
    assert tt.map.kf_valid.dtype == torch.bool
    assert _host_state(tt) == dict(_host_state(jt), state=Tracker.LOST)
    np.testing.assert_array_equal(tt.T_cur, jt.T_cur)
    np.testing.assert_array_equal(tt.velocity, jt.velocity)
    assert [f for f, _ in tt.trajectory] == [0, 4] and tt._resumed
    assert tt._kf_slot_fid == {int(s): int(fields["kf_frame_id"][s]) for s in np.flatnonzero(fields["kf_valid"])}


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = tcfg.SlamConfig(caps=tcfg.Capacities(**CAPS))
    tt = Tracker(Camera.make(300.0, 300.0, 160.0, 120.0, "cpu"), cfg, device="cpu")
    fields = _random_fields(tms.map_to_numpy(tt.map), 1)
    tt.map = tms.map_from_numpy(fields, "cpu")
    _set_host_state(tt)
    path = str(tmp_path / "port.npz")
    tck.save_tracker(path, tt)

    m, extra = jck.load_map(path)
    for k, v in zip(jms.MapState._fields, m):
        v = np.asarray(v)
        assert v.dtype == fields[k].dtype, k
        np.testing.assert_array_equal(v, fields[k], err_msg=k)
    jt = jck.load_tracker(path, jcam.Camera.make(300.0, 300.0, 160.0, 120.0), jcfg.SlamConfig(
        caps=jcfg.Capacities(**CAPS)))
    assert _host_state(jt) == dict(_host_state(tt), state=JTracker.LOST)
    assert extra["kf_fids"] == [0, 4, 9, 13, 20]
    # and the port reads its own file back
    m2, extra2 = tck.load_map(path, "cpu")
    assert extra2 == extra
    for k in tms.FIELDS:
        assert torch.equal(getattr(m2, k), getattr(tt.map, k)), k


def test_map_roundtrip_and_missing_field(tmp_path):
    caps = tcfg.Capacities(**CAPS)
    m = tms.empty_map(caps, "cpu")
    p = str(tmp_path / "map.npz")
    tck.save_map(p, m, extra={"note": "empty"})
    m2, extra = tck.load_map(p, "cpu")
    assert extra == {"note": "empty"}
    for k in tms.FIELDS:
        assert torch.equal(getattr(m, k), getattr(m2, k)), k
    arrays = dict(np.load(p))
    del arrays["pt_cub"]
    np.savez(str(tmp_path / "bad.npz"), **arrays)
    with pytest.raises(ValueError, match="pt_cub"):
        tck.load_map(str(tmp_path / "bad.npz"), "cpu")


def test_resumed_tiny_map_relocalizes_instead_of_resetting(tmp_path):
    """A checkpoint of a map of <= 5 keyframes: a fresh tracker would reset
    it when lost (Tracking.cc:620-628); a resumed one relocalizes."""
    import _torch_loop_scene  # noqa: F401  (caps torch's threads as the other port tests)
    from chip_smoke import reloc_scene

    cam, cfg, m, vocab, frame, T_true = reloc_scene("cpu")
    tr = Tracker(cam, cfg, device="cpu", vocab=vocab)
    tr.map, tr.n_kf, tr.n_pt, tr.state = m, 1, 130, Tracker.OK
    tr._kf_fids, tr.trajectory = [0], [(0, np.eye(4, dtype=np.float32))]
    path = str(tmp_path / "tiny.npz")
    tck.save_tracker(path, tr)
    resumed = tck.load_tracker(path, cam, cfg, device="cpu", vocab=vocab)
    assert resumed.state == Tracker.LOST and resumed._resumed
    T = resumed.process_frame(frame, 1)
    assert resumed.state == Tracker.OK and T is not None and resumed.n_relocalized == 1
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.02
    assert resumed.n_kf == 1 and torch.equal(resumed.map.kf_pose, m.kf_pose)
    fresh = tck.load_tracker(path, cam, cfg, device="cpu", vocab=vocab)
    fresh._resumed = False
    fresh.process_frame(frame, 1)
    assert fresh.state != Tracker.OK and fresh.n_kf == 0  # reset, initialization started again
