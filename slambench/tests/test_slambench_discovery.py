"""Discovery by name: the cells, configurations, mixes, limits and metric
readers of ``BENCHMARK.json``, and a new one added as files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from slambench import cells

ROOT = cells.ROOT


def test_every_entry_has_its_files():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cell = cells.find_cell(bench, w["name"])
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "pose_ms_p90", "setup_s"}
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("slambench/")


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.find_cell(cells.load_benchmark(), "no_such.cell")


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a cell's limits, a
    metric reader and their entries (no existing file of ``slambench/``
    edited), then find and read them in a fresh interpreter."""
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "slambench").rglob("*") if p.is_file()}
    bench = cells.load_benchmark()
    cfg = json.loads((ROOT / "slambench/configs/icl_mono_points.json").read_text())
    cfg["name"] = "icl_mono_points_b"
    (tmp_path / "slambench/configs/icl_mono_points_b.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "slambench/traffic/walk.json").read_text())
    mix.update(name="pan_fast", loop_deg=776.5)
    (tmp_path / "slambench/traffic/pan_fast.json").write_text(json.dumps(mix))
    (tmp_path / "slambench/limits/icl_mono_points_b.pan_fast.json").write_text(
        json.dumps({"ate_m": {"limit": 0.5}}))
    (tmp_path / "slambench/metrics/sessions_per_window.py").write_text(
        "def read(run):\n    return float(len(run['window'].sessions))\n")
    bench["configs"].append({"name": "icl_mono_points_b", "source": "https://example.org", "file":
                             "slambench/configs/icl_mono_points_b.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "icl_mono_points_b.pan_fast", "config": "icl_mono_points_b",
                               "traffic": "pan_fast", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "sessions_per_window", "unit": "sessions", "better": "higher",
                               "source": "program_counter", "layer": "harness", "moves": "frames_per_s",
                               "workloads": ["icl_mono_points_b.pan_fast"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from slambench import cells\n"
            "c = cells.find_cell(cells.load_benchmark(), 'icl_mono_points_b.pan_fast')\n"
            "assert c.traffic['loop_deg'] == 776.5 and c.limits == {'ate_m': 0.5}\n"
            "assert [m['name'] for m in c.per_layer][-1] == 'sessions_per_window'\n"
            "class W: sessions = [1, 2]\n"
            "print(cells.metric_reader('sessions_per_window')({'window': W}))\n"
            "old = cells.find_cell(cells.load_benchmark(), 'icl_mono_points.walk')\n"
            "assert 'sessions_per_window' not in [m['name'] for m in old.per_layer]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "2.0"
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "slambench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_a_traffic_kind_added_as_a_file_is_found(tmp_path):
    """A mix of a new kind brings its generator, ``traffic/<kind>.py``; the
    clip is made by it without an edit to any existing file."""
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "slambench/traffic/blank_gaps.py").write_text(
        "def make_clip(config, traffic, seed, device, detections=None, n_frames=0):\n"
        "    return ('blank_gaps', traffic['gap_frames'], seed)\n")
    (tmp_path / "slambench/traffic/reloc.json").write_text(json.dumps({"name": "reloc", "kind": "blank_gaps",
                                                                       "gap_frames": 5}))
    code = ("from slambench import cells, clip\n"
            "t = cells.load_traffic('reloc')\n"
            "print(clip.make_clip({}, t, 3, 'cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "('blank_gaps', 5, 3)"


def test_the_walk_generator_is_found_by_its_kind():
    from slambench import clip
    from slambench.traffic import walk

    assert cells.load_traffic("walk")["kind"] == "walk"
    assert clip.generator("walk") is walk.make_clip
