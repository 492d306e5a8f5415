"""The port keeps its own copy of the config dataclasses and imports nothing
of the JAX package, nor JAX itself.

Defaults are compared with ``dataclasses.asdict`` (exact equality); the
import check runs in a fresh interpreter, so that this test process's own
imports of both packages cannot hide an import made by the port.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import pytest

from tpuslam.core import config as jcfg
from tpuslam_torch.core import config as tcfg

REPO = pathlib.Path(__file__).resolve().parents[1]
CLASSES = ["OrbConfig", "MatcherConfig", "TrackingConfig", "BAConfig", "SemanticConfig",
           "LoopConfig", "FeatureFlags", "Capacities", "SlamConfig"]
PORT_SOURCES = sorted(str(p.relative_to(REPO)) for p in (REPO / "tpuslam_torch").rglob("*.py"))
PORT_SOURCES += ["chip_smoke.py", "kernel_ab.py"]


@pytest.mark.parametrize("name", CLASSES)
def test_config_defaults_equal_reference(name):
    ref, got = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert type(got).__dataclass_params__.frozen == type(ref).__dataclass_params__.frozen


def test_slam_config_replace_matches_reference():
    ref = jcfg.SlamConfig().replace(sensor="rgbd", caps=jcfg.Capacities(max_keypoints=256))
    got = tcfg.SlamConfig().replace(sensor="rgbd", caps=tcfg.Capacities(max_keypoints=256))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_port_and_chip_smoke_import_no_jax_and_no_reference_package():
    code = "\n".join([
        "import importlib, importlib.util, pkgutil, sys",
        "import tpuslam_torch, tpuslam_torch.workload",
        "for m in pkgutil.walk_packages(tpuslam_torch.__path__, 'tpuslam_torch.'):",
        "    importlib.import_module(m.name)",
        "for name in ('chip_smoke', 'kernel_ab'):",
        "    spec = importlib.util.spec_from_file_location(name, name + '.py')",
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'tpuslam'))",
        "print(bad)",
        "sys.exit(1 if bad else 0)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_port_source_names_no_jax_and_imports_no_reference_package(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+tpuslam(\.|\s|$)", text, re.M), "imports tpuslam"
    assert not re.search(r"\bjax\b", text), "mentions jax"
