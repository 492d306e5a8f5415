"""``bench_torch.py``, the port's counterpart of bench.py, on the CPU: its
line at the CPU cut (one timed pass of ``workload.SMALL``, one solve of a
4-keyframe bench window, no golden replay), a failed measurement reported
in ``errors`` with a non-zero exit, bench.py's 90% honesty gate on a stub
report, the BA window's numpy part equal to bench.py's draws, and the
imports of the new code (nothing of ``tpuslam``, nothing of JAX).
"""

import ast
import json
import pathlib

import numpy as np
import pytest

import _torch_scene  # noqa: F401  (caps torch's threads for the workers)
import bench_torch
from tpuslam_torch import workload

ROOT = pathlib.Path(__file__).resolve().parents[1]
# bench.py's keys of the measurements the port runs (bench.py:203-206, 355-357, 428-431)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_assumption", "device_kind", "local_ba_iters_s",
              "local_ba_solve_ms")


def _cheap(monkeypatch):
    monkeypatch.setenv("TPUSLAM_BENCH_GOLDEN_FRAMES", "0")
    monkeypatch.setattr(bench_torch, "TRACKING_REPS", 1)
    monkeypatch.setattr(bench_torch, "BA_REPS", 1)
    monkeypatch.setattr(bench_torch, "CPU_BA_SIZES", dict(K=4, N=64, P=256, Q=8, C=2))


def test_main_at_the_cpu_cut_prints_one_line_with_bench_keys(monkeypatch, capsys):
    _cheap(monkeypatch)
    assert bench_torch.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    for k in BENCH_KEYS:
        assert k in line, k
    assert line["metric"] == "tracking_fps" and line["unit"] == "frames/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 30.0)
    assert line["device_kind"] == "cpu" and line["card"] is None and line["cut"].startswith("cpu")
    assert "errors" not in line and "mfu" not in line and "tracking_mfu" not in line
    assert line["tracking_median_inliers"] > 150
    assert line["local_ba_chi2"][1] < line["local_ba_chi2"][0]
    assert line["local_ba_iters_s"] == pytest.approx(workload.BA_ITERS / (line["local_ba_solve_ms"] / 1e3))
    assert not any(k.startswith("golden") for k in line)


def test_a_failed_measurement_goes_into_errors_and_the_exit_code(monkeypatch, capsys):
    _cheap(monkeypatch)

    def broken(out, device):
        raise AssertionError("BA bench did not reduce chi2")

    monkeypatch.setattr(bench_torch, "bench_local_ba", broken)
    assert bench_torch.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["errors"] == {"local_ba": "AssertionError: BA bench did not reduce chi2"}
    assert line["value"] > 0


@pytest.mark.parametrize("tracked,withheld", [(503, True), (504, False)])
def test_the_90_percent_gate_withholds_the_ate(tracked, withheld):
    report = {"tracked": tracked, "keyframes_live": 16, "keyframes_created": 111, "planes": 7, "cuboids": 6,
              "loops": 1, "median_frame_s": 0.25, "kf_stage_ms": {"map_ba": 100.0}, "ate_rmse_m": 0.418,
              "ate_rmse_raw_m": 0.530, "kf_ate_rmse_m": 0.435}
    flag = bench_torch.golden_keys(report, 560, 280.0, "")
    pts = bench_torch.golden_keys(report, 560, 280.0, "ptsonly")
    assert flag["golden_e2e_fps"] == 2.0 and flag["golden_tracked_frac"] == round(tracked / 560, 3)
    if withheld:
        assert flag["ate_rmse_m"] is None and "golden_ate_raw_m" not in flag
        assert flag["golden_failed"] == f"tracked {tracked}/560 < 90%; ATE withheld"
        assert pts["golden_ptsonly_ate_rmse_m"] is None and "golden_ptsonly_failed" in pts
    else:
        assert flag["ate_rmse_m"] == 0.418 and flag["golden_ate_raw_m"] == 0.530 and flag["golden_kf_ate_m"] == 0.435
        assert pts["golden_ptsonly_ate_rmse_m"] == 0.418 and pts["golden_ptsonly_ate_raw_m"] == 0.530
        assert "golden_failed" not in flag


def test_ba_window_arrays_hold_bench_py_numpy_draws():
    """The numpy part of bench.py's window (bench.py:224-323) for the same
    seed, drawn in its order; the geometry is the port's."""
    state, data = workload.ba_window_arrays(0, K=4, N=64, P=256, Q=8, C=2)
    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(-3, 3, 256), rng.uniform(-2, 2, 256), rng.uniform(4, 10, 256)], -1)
    pt_idx = np.stack([rng.choice(256, 64, replace=False) for _ in range(4)]).reshape(-1)
    rng.normal(0, 0.5, (256, 2))  # the pixel noise
    octave = rng.randint(0, 8, 256)
    np.testing.assert_array_equal(data["mono"]["pt"], pt_idx)
    np.testing.assert_array_equal(data["mono"]["kf"], np.repeat(np.arange(4), 64))
    np.testing.assert_allclose(data["mono"]["inv_sigma2"], 1.0 / 1.2 ** (2.0 * octave), rtol=1e-6)
    np.testing.assert_array_equal(data["plane_obs"]["kind"], np.tile([0, 0, 0, 0, 0, 0, 1, 2], 4))
    np.testing.assert_array_equal(data["pose_fixed"], [True, False, True, True])
    assert np.abs(state["points"] - pts).max() < 0.2  # perturbed by 0.03 sigma
    assert data["mono"]["valid"].all() and data["plane_obs"]["valid"].any() and data["cub_bbox"]["valid"].any()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", ["bench_torch.py", "tpuslam_torch/workload.py", "tpuslam_torch/graph/lm.py",
                                 "tpuslam_torch/backend/local_ba.py", "chip_smoke.py"])
def test_new_code_imports_nothing_of_the_jax_package(rel):
    mods = list(_imports(ROOT / rel))
    assert mods
    bad = [m for m in mods if m.split(".")[0] in ("tpuslam", "jax", "jaxlib")]
    assert not bad, bad
