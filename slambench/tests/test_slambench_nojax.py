"""The no-JAX check compares whole top-level names, the measuring process
loads no JAX module, and a checkout without the program gives no result."""

import os
import shutil
import subprocess
import sys

from slambench import cells, run

ROOT = cells.ROOT


def test_whole_top_level_names():
    assert run.forbidden_modules(["tpuslam_torch", "tpuslam_torch.frontend.tracking", "jaxtyping", "flaxen",
                                  "numpy"]) == []
    assert run.forbidden_modules(["tpuslam.io.synth", "tpuslam_torch"]) == ["tpuslam"]
    assert run.forbidden_modules(["jax._src.core", "jaxlib", "flax.linen", "tpuslam"]) == ["flax", "jax", "jaxlib",
                                                                                           "tpuslam"]


def test_the_measuring_modules_load_no_jax():
    code = ("import sys; sys.argv = ['x']\n"
            "sys.path.insert(0, 'slambench')\n"
            "import run\n"
            "from slambench import cells, clip, harness, program, roofline, scene, tracing\n"
            "from slambench.reference import checks, geometry, hamming, keypoints\n"
            "program.import_program()\n"
            "for w in cells.load_benchmark()['workloads']:\n"
            "    clip.generator(cells.find_cell(cells.load_benchmark(), w['name']).traffic['kind'])\n"
            "bench = cells.load_benchmark()\n"
            "for w in bench['workloads']:\n"
            "    c = cells.find_cell(bench, w['name'])\n"
            "    [cells.metric_reader(m['name']) for m in c.per_layer]\n"
            "print(run.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_references_import_nothing_of_the_program():
    for path in (list((ROOT / "slambench/reference").glob("*.py")) + list((ROOT / "slambench/traffic").glob("*.py"))
                 + [ROOT / "slambench/scene.py"]):
        lines = path.read_text().splitlines()
        assert not [x for x in lines if x.lstrip().startswith(("import tpuslam", "from tpuslam"))], path


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "icl_mono_points.walk", "--seed",
                          "3000000001", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
