"""The port's dataset CLIs (``tpuslam_torch/apps/*.py``) from files on disk,
on the CPU (``--device cpu``):

* ``mono_icl`` and ``rgbd_icl`` (``--planes online``) against the JAX
  package's CLIs on ``tests/test_apps.py``'s 10-frame 240x320 folder, 512
  features, the seeded codebook: frames tracked and keyframes within one,
  live points within 10%, planes equal, raw and corrected ATE within the
  replay tests' band (1.5 x the JAX run's + 0.01 m), and the same output
  files;
* ``rgbd_icl`` with ``--checkpoint``, then ``--resume`` with
  ``--localization-only``: every frame relocalizes or tracks, no keyframe
  is made and the map written at the end equals the one resumed from but
  for the found/visible counters, which the tracked frames commit, as in
  the reference;
* each of the other six CLIs (``mono_tum`` with ``--vocab train``,
  ``rgbd_tum``, ``mono_kitti``, ``stereo_kitti``, ``mono_euroc``,
  ``stereo_euroc``) runs on a tiny folder of its layout and tracks;
* every CLI takes the reference's flags and runs with them, ``--viz-every``
  included.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import _torch_datasets as tds
import _torch_loop_scene  # noqa: F401  (caps torch's threads)
from tpuslam_torch.io import checkpoint as tck
from tpuslam_torch.map import mapstate as tms

APPS = ("mono_icl", "mono_tum", "mono_kitti", "mono_euroc", "rgbd_icl", "rgbd_tum", "stereo_kitti", "stereo_euroc")


@pytest.fixture(scope="module")
def icl(tmp_path_factory):
    return tds.write_tum(str(tmp_path_factory.mktemp("icl") / "seq"), n_frames=10)


def _close(port, ref, metric_keys=("ate_rmse_raw_m", "ate_rmse_m")):
    assert abs(port["tracked"] - ref["tracked"]) <= 1, (port["tracked"], ref["tracked"])
    assert abs(port["keyframes_created"] - ref["keyframes_created"]) <= 1
    assert abs(port["points"] - ref["points"]) <= 0.1 * ref["points"]
    assert port["planes"] == ref["planes"] and port["cuboids"] == ref["cuboids"]
    for k in metric_keys:
        assert port[k] <= 1.5 * ref[k] + 0.01, (k, port[k], ref[k])


@pytest.mark.parametrize("app,extra", [("mono_icl", []), ("rgbd_icl", ["--planes", "online"])])
def test_icl_cli_matches_the_jax_cli(icl, tmp_path, app, extra):
    args = [icl, "--features", "512", "--vocab", "lsh", "--save-kitti"] + extra
    ref = importlib.import_module(f"tpuslam.apps.{app}").main(args + ["--out", str(tmp_path / "jax")])
    port = importlib.import_module(f"tpuslam_torch.apps.{app}").main(
        args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    _close(port, ref)
    assert port["tracked"] >= 8 and set(ref) <= set(port)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    for name in ("KeyFrameTrajectory.txt", "CameraTrajectory_kitti.txt"):
        a, b = np.loadtxt(tmp_path / "jax" / name, ndmin=2), np.loadtxt(tmp_path / "port" / name, ndmin=2)
        assert abs(len(a) - len(b)) <= 1
    assert port["decode_ms_per_image"]["gray"] > 0
    if app == "rgbd_icl":
        assert port["decode_ms_per_image"]["depth"] > 0


def test_checkpoint_then_resume_in_localization_mode(icl, tmp_path):
    from tpuslam_torch.apps import rgbd_icl

    ck, ck2 = str(tmp_path / "map.npz"), str(tmp_path / "after.npz")
    base = [icl, "--features", "512", "--vocab", "lsh", "--device", "cpu"]
    r1 = rgbd_icl.main(base + ["--out", str(tmp_path / "o1"), "--checkpoint", ck])
    assert os.path.exists(ck) and r1["tracked"] == 10
    r2 = rgbd_icl.main(base + ["--out", str(tmp_path / "o2"), "--resume", ck, "--localization-only",
                               "--checkpoint", ck2])
    assert r2["tracked"] == r1["tracked"] + 10 and r2["relocalized"] >= 1
    assert r2["keyframes_created"] == r1["keyframes_created"] and r2["keyframes"] == r1["keyframes"]
    m1, e1 = tck.load_map(ck, "cpu")
    m2, e2 = tck.load_map(ck2, "cpu")
    counters = ("pt_found", "pt_visible")
    assert [k for k in tms.FIELDS if k not in counters and not torch.equal(getattr(m1, k), getattr(m2, k))] == []
    assert all(bool((getattr(m2, k) >= getattr(m1, k)).all()) for k in counters)
    assert e2["kf_fids"] == e1["kf_fids"]
    # the resumed run's first frame was placed by relocalization
    raw = np.loadtxt(tmp_path / "o2" / "TrajectoryRaw.txt", ndmin=2)
    assert raw[len(e1["trajectory"]), 0] == 0


@pytest.mark.parametrize("app", ["mono_tum", "rgbd_tum", "mono_kitti", "stereo_kitti", "mono_euroc", "stereo_euroc"])
def test_other_clis_run_from_disk(tmp_path, app):
    writer, settings = {"mono_tum": (tds.write_icl, "ICL.yaml"), "rgbd_tum": (tds.write_tum, "ICL.yaml"),
                        "mono_kitti": (tds.write_kitti, "KITTI.yaml"), "stereo_kitti": (tds.write_kitti, "KITTI.yaml"),
                        "mono_euroc": (tds.write_euroc, "EuRoC.yaml"),
                        "stereo_euroc": (tds.write_euroc, "EuRoC.yaml")}[app]
    root = writer(str(tmp_path / "seq"), n_frames=6)
    vocab = "train" if app == "mono_tum" else "lsh"
    rep = importlib.import_module(f"tpuslam_torch.apps.{app}").main(
        [root, "--settings", settings, "--features", "256", "--vocab", vocab, "--out", str(tmp_path / "out"),
         "--device", "cpu"])
    assert rep["frames"] == 6 and rep["tracked"] >= (5 if app.startswith(("rgbd", "stereo")) else 1), rep
    assert os.path.exists(tmp_path / "out" / "KeyFrameTrajectory.txt")
    if "kitti" in app:
        assert os.path.exists(tmp_path / "out" / "CameraTrajectory_kitti.txt")
    if app.startswith("stereo"):
        assert rep["ate_rmse_raw_m"] < 0.05 and rep["decode_ms_per_image"]["right"] > 0


WRITERS = {"mono_icl": tds.write_icl, "rgbd_icl": tds.write_tum, "mono_tum": tds.write_icl, "rgbd_tum": tds.write_tum,
           "mono_kitti": tds.write_kitti, "stereo_kitti": tds.write_kitti, "mono_euroc": tds.write_euroc,
           "stereo_euroc": tds.write_euroc}


@pytest.mark.parametrize("app", APPS)
def test_flags_and_viz_every(tmp_path, app):
    """Every CLI takes the reference's flags and runs with them, ``--viz-every``
    included (it dumps into ``<out>/viz``)."""
    mod = importlib.import_module(f"tpuslam_torch.apps.{app}")
    root = WRITERS[app](str(tmp_path / "seq"), n_frames=2)
    out, ck = tmp_path / "out", tmp_path / "c.npz"
    flags = ["--settings", "x.yaml", "--max-frames", "2", "--out", str(out), "--save-kitti", "--checkpoint",
             str(ck), "--features", "64", "--max-kf-gap", "3", "--vocab", "lsh", "--device", "cpu", "--viz-every", "5"]
    rep = mod.main([root] + flags)
    assert rep["frames"] == 2 and os.path.isdir(out / "viz") and os.path.exists(ck)
    assert os.path.exists(out / "CameraTrajectory_kitti.txt")
    with pytest.raises(SystemExit):
        mod.main(["--help"])


def test_run_loop_wall_time_spans_the_reads():
    """``run_loop``'s per-frame span covers the tracker's call only; the
    loop's wall time (the report's ``wall_s`` and ``frames_per_s``) also
    covers drawing each item, where a dataset reader decodes its files."""
    import time
    import types

    from tpuslam_torch.apps import common
    from tpuslam_torch.utils.profiler import Profiler

    class Tracker:
        OK = state = 1
        device = torch.device("cpu")
        cfg = types.SimpleNamespace(sensor="mono")
        _kf_fids, waits = [], {}

        def process_image(self, gray, fid, **kw):
            pass

        def flush(self):
            pass

    def items(n, read_s):
        for i in range(n):
            time.sleep(read_s)  # the read and decode of the next file
            yield i, np.zeros((4, 4), np.uint8)

    times = common.run_loop(Tracker(), items(5, 0.02), Profiler())
    assert len(times.frame_s) == 5 and sum(times.frame_s) < 0.05
    assert times.wall_s >= 5 * 0.02
