"""The port's diagnostics against the JAX package's, on the CPU: the
Tracker's ``TPUSLAM_TRACE`` file, the loop detector's ``TPUSLAM_LOOP_DEBUG``
log, and ``utils/profiler.device_trace``.

The trace test replays the first 14 golden frames (320x240, 512 features,
loops off; ``test_torch_tracker.py``'s configuration) through both
Trackers, each writing its own file.  Both files must hold the same line
kinds (``fid`` / ``LOST`` / ``KF``) in the same order for the same frame
ids, the ``KF`` lines equal letter for letter, and on each ``fid`` line
``used_rf``, ``n_valid_kf`` and ``since_kf`` equal (host state) and the
match counts ``n_mm``, ``n_rf``, ``n_final``, ``n_ref2`` and ``n_ref3``
within ``COUNT_TOL`` of the reference's: the poses they are counted at
agree within 5e-3 (``test_torch_tracker.py``), and a keypoint on a search
window's edge or a ratio test's threshold falls either way.  The
synchronous path's lines and the pipelined LOST line are held letter for
letter on scalars given to both commits.

The loop log test runs ``tests/test_loop_e2e.py``'s revisit cases (as
``test_torch_loop.py`` does, the reference's RANSAC draw in the port) with
``_DEBUG_PATH`` patched in both packages: the logs equal line for line,
and the Sim3 inputs saved beside them within 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_loop_scene as ls
import _torch_scene as sc
import test_loop_e2e as e2e
import test_torch_loop as tl
import test_torch_tracker as tt_
from tpuslam.core import camera as jcam
from tpuslam.core import config as jcfg
from tpuslam.frontend import tracking as jtr
from tpuslam.place import loop as jloop
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.frontend import tracking as ttr
from tpuslam_torch.place import loop as tloop
from tpuslam_torch.utils.profiler import device_trace

COUNT_TOL = 0.05  # relative, with at least 3 counts: match counts on the fid lines
COUNTS = ("n_mm", "n_rf", "n_final", "n_ref2", "n_ref3")


def _trackers(monkeypatch, tmp_path):
    c = sc.CSPEC
    paths = []
    trackers = []
    for name, make in (
        ("jax", lambda: jtr.Tracker(jcam.Camera.make(c.fx, c.fy, c.cx, c.cy, width=c.width, height=c.height,
                                                     bf=c.fx * c.baseline), tt_._cfg(jcfg))),
        ("port", lambda: ttr.Tracker(Camera.make(c.fx, c.fy, c.cx, c.cy, "cpu", width=c.width, height=c.height,
                                                 bf=c.fx * c.baseline), tt_._cfg(tcfg), device="cpu")),
    ):
        paths.append(tmp_path / f"{name}_trace.txt")
        monkeypatch.setenv("TPUSLAM_TRACE", str(paths[-1]))
        trackers.append(make())
    monkeypatch.delenv("TPUSLAM_TRACE")
    return trackers, paths


def _parse(line: str):
    kind = "fid" if line.startswith("fid=") else line.split()[0]
    fields = dict(kv.split("=", 1) for kv in line.replace("(", " ").replace(")", " ").split() if "=" in kv)
    return kind, fields


def test_trace_file_matches_reference(monkeypatch, tmp_path):
    (jt, tt), (jp, tp) = _trackers(monkeypatch, tmp_path)
    frames, _ = tt_._frames()
    tt_._run(jt, frames)
    tt_._run(tt, frames)
    ref, got = jp.read_text().splitlines(), tp.read_text().splitlines()
    kinds = [_parse(x)[0] for x in ref]
    assert kinds.count("KF") >= 2 and kinds.count("fid") >= 8, ref
    assert [_parse(x)[0] for x in got] == kinds
    worst = 0.0
    for r, g in zip(ref, got):
        (kind, fr), (_, fg) = _parse(r), _parse(g)
        assert fg["fid"] == fr["fid"]
        exact, counts = (("c1a", "c2"), ("n_ref",)) if kind == "KF" else \
            (("used_rf", "n_valid_kf", "since_kf"), COUNTS) if kind == "fid" else ((), ())
        assert {k: fg[k] for k in exact} == {k: fr[k] for k in exact}, (g, r)
        for k in counts:
            a, b = int(fg[k]), int(fr[k])
            assert abs(a - b) <= max(3, COUNT_TOL * b), (k, g, r)
            worst = max(worst, abs(a - b) / max(b, 1))
    print(f"largest relative count difference {worst:.4f}")


class _Step:
    """What the commits read of a tracking program's outputs."""

    def __init__(self, scalars, m, n_kp, to):
        self.scalars = to(np.asarray(scalars, np.int32))
        self.T = self.T_ref = to(np.eye(4, dtype=np.float32))
        self.m = m
        self.kp_pt = to(np.full(n_kp, -1, np.int32))
        self.velocity = self.T


# (scalars [n_mm, n_rf, used_rf, n_final, n_ref2, n_ref3, n_valid_kf, close tracked, close free],
#  the lines both write): tracked, the reference keyframe's match lost, the local map's lost
SYNC_CASES = [
    ([50, 40, 0, 100, 0, 0, 2, 0, 0], ["fid=7 n_mm=50 n_rf=40 used_rf=0 n_final=100 n_ref2=0 n_ref3=0 "
                                       "n_valid_kf=2 since_kf=0"]),
    ([5, 6, 1, 100, 0, 0, 2, 0, 0], ["fid=7 n_mm=5 n_rf=6 used_rf=1 n_final=100 n_ref2=0 n_ref3=0 "
                                     "n_valid_kf=2 since_kf=0", "  LOST fid=7 (motion+ref: n_rf=6)"]),
    ([50, 40, 0, 20, 0, 0, 2, 0, 0], ["fid=7 n_mm=50 n_rf=40 used_rf=0 n_final=20 n_ref2=0 n_ref3=0 "
                                      "n_valid_kf=2 since_kf=0", "  LOST fid=7 (localmap: n_final=20)"]),
]


@pytest.mark.parametrize("case", range(len(SYNC_CASES)))
@pytest.mark.parametrize("pipelined", [False, True])
def test_trace_lines_of_each_commit_match_reference(monkeypatch, tmp_path, case, pipelined):
    """The same scalars through the reference's synchronous ``_track`` (its
    ``_prestep``) or pipelined ``_finish_pending`` and through the port's
    ``_commit``: the same lines.  The pipelined commit writes one LOST line
    for either failure."""
    (jt, tt), (jp, tp) = _trackers(monkeypatch, tmp_path)
    scalars, want = SYNC_CASES[case]
    if pipelined and len(want) > 1:
        s = scalars
        want = [want[0], f"  LOST fid=7 (n_rf={s[1]} n_final={s[3]})"]
    for tr in (jt, tt):
        tr.state = tr.OK
    n = tt.cfg.caps.max_keypoints
    out_j = _Step(scalars, jt.map, n, jnp.asarray)
    if pipelined:
        jt._pending = (7, out_j, None, None, None, 0)
        jt._finish_pending()
    else:
        jt._track(None, 7, _prestep=out_j)
    out_t = _Step(scalars, tt.map, n, torch.from_numpy)
    tt._commit(7, out_t, None, 0, out_t.scalars.numpy(), out_t.T.numpy(), out_t.T_ref.numpy(), pipelined)
    assert jp.read_text().splitlines() == want
    assert tp.read_text().splitlines() == want
    assert tt.state == jt.state


@pytest.mark.parametrize("case", ["closes", "gate_40", "first_sighting"])
def test_loop_log_matches_reference(case, monkeypatch, tmp_path):
    cam_j, cfg_j, m_j, vocab_j, _, _, _ = e2e.build()
    if case == "gate_40":
        m_j = tl._scramble(m_j, vocab_j)
    K = m_j.kf_valid.shape[0]
    jpath, tpath = tmp_path / "jax" / "loop.txt", tmp_path / "port" / "loop.txt"
    jpath.parent.mkdir()
    tpath.parent.mkdir()
    monkeypatch.setattr(jloop, "_DEBUG_PATH", str(jpath))
    monkeypatch.setattr(tloop, "_DEBUG_PATH", str(tpath))
    lc_j = jloop.LoopCloser(vocab_j, cam_j, cfg_j)
    lc_j.prev_groups = tl._groups(case, K)
    lc_t = tl._port_closer(cam_j, cfg_j, vocab_j, monkeypatch)
    lc_t.prev_groups = [(g.copy(), s) for g, s in tl._groups(case, K)]
    _, closed_j = lc_j.on_keyframe(m_j, 11, 12)
    _, closed_t = lc_t.on_keyframe(ls.tmap(m_j), 11, 12)
    assert closed_t == closed_j
    ref, got = jpath.read_text().splitlines(), tpath.read_text().splitlines()
    assert got == ref
    assert ref[0].startswith("fid=")
    assert any(x.startswith("    sim3: guided total=") for x in ref) == (case == "closes")
    assert lc_t.gates["covisible"] == sum(x.startswith("fid=") for x in got) == 1
    saved = sorted(os.listdir(jpath.parent))
    assert sorted(os.listdir(tpath.parent)) == saved
    for name in saved:
        if name.endswith(".npz"):
            a, b = np.load(jpath.parent / name), np.load(tpath.parent / name)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_allclose(b[k], a[k], atol=1e-4, err_msg=k)


def test_unset_variables_write_nothing_and_fetch_nothing_extra(monkeypatch, tmp_path):
    """With both variables unset a replay and a loop closure write no file,
    and the detector reads what it reads without its log: one fetch less
    than with it, and one more per Sim3 attempt (the saved inputs)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TPUSLAM_TRACE", raising=False)
    c = sc.CSPEC
    tr = ttr.Tracker(Camera.make(c.fx, c.fy, c.cx, c.cy, "cpu", width=c.width, height=c.height),
                     tt_._cfg(tcfg), device="cpu")
    assert tr._trace_path == ""
    frames, _ = tt_._frames()
    tt_._run(tr, frames[:6])
    cam_j, cfg_j, m_j, vocab_j, _, _, _ = e2e.build()
    K = m_j.kf_valid.shape[0]
    counts = {}
    for path in ("", str(tmp_path / "on" / "loop.txt")):
        monkeypatch.setattr(tloop, "_DEBUG_PATH", path)
        if path:
            assert os.listdir(tmp_path) == []
            os.makedirs(os.path.dirname(path))
        n = [0]

        def fetch(tensors):
            n[0] += 1
            return [t.cpu().numpy() for t in tensors]

        lc = tl._port_closer(cam_j, cfg_j, vocab_j, monkeypatch)
        lc.prev_groups = tl._groups("closes", K)
        assert lc.on_keyframe(ls.tmap(m_j), 11, 12, fetch=fetch)[1]
        counts[bool(path)] = n[0]
    assert counts[True] == counts[False] + 2  # the frame ids, and the one Sim3 attempt's inputs


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import json

    with device_trace(str(tmp_path / "tr")):
        x = torch.randn(64, 64)
        (x @ x).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
