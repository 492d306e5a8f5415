"""``tpuslam_torch/workload.py`` on the CPU: the BA window's numpy part
equal to bench.py's draws, and the imports of the port's workload, its
solvers and ``chip_smoke.py`` (nothing of ``tpuslam``, nothing of JAX).
"""

import ast
import pathlib

import numpy as np
import pytest

import _torch_scene  # noqa: F401  (caps torch's threads for the workers)
from tpuslam_torch import workload

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


@pytest.mark.parametrize("rel", ["tpuslam_torch/workload.py", "tpuslam_torch/graph/lm.py",
                                 "tpuslam_torch/backend/local_ba.py", "chip_smoke.py"])
def test_new_code_imports_nothing_of_the_jax_package(rel):
    mods = list(_imports(ROOT / rel))
    assert mods
    bad = [m for m in mods if m.split(".")[0] in ("tpuslam", "jax", "jaxlib")]
    assert not bad, bad
