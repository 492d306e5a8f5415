"""The port's stdin stream node (``tpuslam_torch/apps/stream.py``) against
the JAX package's (``tpuslam/apps/stream.py``), on the CPU
(``--device cpu``): the same stdin lines, mono, RGB-D and stereo, over the
first frames of the golden sequence at 320x240 (fx = fy = 260) written by
the port's ``synth.write_sequence`` (the stereo right views rendered with
the numpy oracle at the camera moved by the baseline and written with the
port's PNG encoder), with a line of the wrong width and one with a bad
frame id among them.  Held: the same frame ids, states and error lines;
the poses of the frames both call OK within ``test_torch_apps.py``'s band
(the ATE of the port's OK poses against the truth <= 1.5 x the
reference's + 0.01 m, Sim3-aligned for mono, without scale for the depth
sensors); the final reports' tracked frames and keyframes within one; and
the same output files.
"""

import io
import json
import os
import sys

import numpy as np
import pytest

import _torch_scene as sc
from tpuslam.io import synth as jsynth
from tpuslam_torch.io import png, synth
from tpuslam_torch.io.trajectory import ate_rmse

N_FRAMES = 8
BAD_LINES = {"mono": "5 a b", "rgbd": "5 a", "stereo": "5"}


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream") / "seq")
    angle = 400.0 * sc.N_SEQ / 560.0
    synth.write_sequence(root, n_frames=sc.N_SEQ, cam=sc.CSPEC, total_angle_deg=angle, device="cpu",
                         n_write=N_FRAMES)
    os.makedirs(os.path.join(root, "right"), exist_ok=True)
    poses = sc.poses_wc()[:N_FRAMES]
    for i, T in enumerate(synth.right_poses(poses, sc.CSPEC.baseline)):
        gray, _, _, _ = jsynth.render_frame(T, sc.CSPEC, jsynth.SceneSpec())
        png.imwrite(os.path.join(root, "right", f"{i:04d}.png"), gray.astype(np.uint8))
    return root, [np.linalg.inv(np.asarray(T, np.float64)) for T in poses]


def _lines(root, sensor):
    out = []
    for i in range(N_FRAMES):
        second = {"mono": "", "rgbd": f" {root}/depth/{i:04d}.png", "stereo": f" {root}/right/{i:04d}.png"}[sensor]
        out.append(f"{i} {root}/rgb/{i:04d}.png{second}")
        if i == 2:
            out += [BAD_LINES[sensor], f"x{i} {root}/rgb/{i:04d}.png{second}"]
    return "\n".join(out) + "\n"


def _run(main, lines, args, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    capsys.readouterr()
    main(args)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return [r for r in rows if "frame_id" in r], [r for r in rows if "error" in r], rows[-1]


def _ate(frames, gt, scale):
    ok = [r for r in frames if r["pose"] is not None]
    return ate_rmse([np.asarray(r["pose"]).reshape(4, 4) for r in ok], [gt[r["frame_id"]] for r in ok],
                    with_scale=scale)[0]


@pytest.mark.parametrize("sensor", ["mono", "rgbd", "stereo"])
def test_stream_node_matches_the_jax_node(seq, tmp_path, monkeypatch, capsys, sensor):
    from tpuslam.apps import stream as jstream
    from tpuslam_torch.apps import stream as tstream

    root, gt = seq
    c = sc.CSPEC
    args = ["--sensor", sensor, "--fx", str(c.fx), "--fy", str(c.fy), "--cx", str(c.cx), "--cy", str(c.cy),
            "--bf", str(c.fx * c.baseline), "--features", "512", "--vocab", "lsh", "--save-kitti"]
    lines = _lines(root, sensor)
    ref, ref_err, ref_rep = _run(jstream.main, lines, args + ["--out", str(tmp_path / "jax")], monkeypatch, capsys)
    got, got_err, got_rep = _run(tstream.main, lines, args + ["--out", str(tmp_path / "port"), "--device", "cpu"],
                                 monkeypatch, capsys)
    assert [r["frame_id"] for r in got] == [r["frame_id"] for r in ref] == list(range(N_FRAMES))
    assert got_err == ref_err and len(got_err) == 2
    assert [r["state"] for r in got] == [r["state"] for r in ref]
    assert sum(r["state"] == "OK" for r in got) >= (N_FRAMES - 6 if sensor == "mono" else N_FRAMES - 2)
    for r in got:
        assert set(r) == {"frame_id", "state", "pose", "n_inliers", "n_kf", "n_pt"}
    scale = sensor == "mono"
    assert _ate(got, gt, scale) <= 1.5 * _ate(ref, gt, scale) + 0.01
    assert abs(got_rep["tracked"] - ref_rep["tracked"]) <= 1
    assert abs(got_rep["keyframes_created"] - ref_rep["keyframes_created"]) <= 1
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))


def test_stream_node_raises_for_a_missing_image(tmp_path, monkeypatch, capsys):
    from tpuslam_torch.apps import stream as tstream

    monkeypatch.setattr(sys, "stdin", io.StringIO(f"0 {tmp_path}/none.png\n"))
    with pytest.raises(FileNotFoundError):
        tstream.main(["--device", "cpu", "--out", str(tmp_path)])
