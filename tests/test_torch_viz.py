"""The port's viz package (``tpuslam_torch/viz``: ``draw_frame_overlay``,
``draw_map``, ``save_map_png``) and the CLIs' ``--viz-every`` against the
JAX package's, on the CPU: the overlay equal pixel for pixel on the same
inputs (the port's given tensors), the map PNG decoded equal to the
reference's, the same file names in ``<out>/viz`` from ``rgbd_icl``, and a
host without cv2 or matplotlib refused at startup with an ImportError that
names the package.
"""

import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_datasets as tds
import _torch_scene  # noqa: F401  (caps torch's threads)
from tpuslam.core.config import Capacities
from tpuslam.map import mapstate as jms
from tpuslam.viz import draw_frame_overlay as j_overlay
from tpuslam.viz import save_map_png as j_save_map
from tpuslam_torch.map import mapstate as tms
from tpuslam_torch.viz import draw_frame_overlay, save_map_png


def _overlay_inputs(seed):
    rng = np.random.default_rng(seed)
    gray = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    n = 40
    uv = np.concatenate([rng.uniform(-10, 170, (n, 2)), [[500.0, 500.0]]]).astype(np.float32)
    valid = rng.random(n + 1) > 0.1
    bound = rng.random(n + 1) > 0.5
    bboxes = np.array([[80.0, 60.0, 40.0, 30.0], [10.0, 10.0, -1.0, 5.0]])
    corners = np.stack([np.array([20, 20, 40, 20, 40, 40, 20, 40] * 2, np.float32),
                        np.zeros(16, np.float32)])
    return gray, uv, valid, bound, bboxes, corners


@pytest.mark.parametrize("seed, state", [(0, 1), (1, 0), (2, 2)])
def test_frame_overlay_equals_the_reference(seed, state):
    gray, uv, valid, bound, bboxes, corners = _overlay_inputs(seed)
    ref = j_overlay(gray, uv, valid, bound, state=state, n_kf=3, n_pt=42, bboxes=bboxes, corners2d=corners)
    got = draw_frame_overlay(torch.from_numpy(gray), torch.from_numpy(uv), torch.from_numpy(valid),
                             torch.from_numpy(bound), state=state, n_kf=3, n_pt=42, bboxes=torch.from_numpy(bboxes),
                             corners2d=torch.from_numpy(corners))
    assert got.dtype == np.uint8 and got.shape == (142, 160, 3)
    np.testing.assert_array_equal(got, ref)


def _maps():
    rng = np.random.RandomState(3)
    caps = Capacities(max_keyframes=8, max_keypoints=64, max_points=256)
    m = jms.empty_map(caps)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 8)
    poses[:3, 0, 3] = [0.0, 0.3, 0.6]
    kf_pt = np.full((8, 64), -1, np.int32)
    kf_pt[:3, :10] = np.arange(10)
    m = m._replace(
        pt_pos=m.pt_pos.at[:10].set(jnp.asarray(rng.randn(10, 3), jnp.float32)),
        pt_valid=m.pt_valid.at[:10].set(True),
        kf_valid=m.kf_valid.at[:3].set(True), kf_pose=jnp.asarray(poses), kf_pt=jnp.asarray(kf_pt),
        kf_kp_valid=m.kf_kp_valid.at[:3, :10].set(True),
        plane_coef=m.plane_coef.at[0].set(jnp.array([0, 0, 1.0, 2.0])),
        plane_valid=m.plane_valid.at[0].set(True),
        cub_valid=m.cub_valid.at[0].set(True),
        cub_scale=m.cub_scale.at[0].set(jnp.array([0.3, 0.2, 0.1])),
    )
    return m, tms.map_from_numpy({k: np.asarray(getattr(m, k)) for k in m._fields}, "cpu")


@pytest.mark.parametrize("kw", [{"n_kf": 3, "show_covisibility": True}, {"n_kf": 0, "show_planes": False}])
def test_map_png_decodes_equal_to_the_reference(tmp_path, kw):
    m_j, m_t = _maps()
    j_save_map(str(tmp_path / "ref.png"), m_j, **kw)
    save_map_png(str(tmp_path / "got.png"), m_t, **kw)
    ref, got = (cv2.imread(str(tmp_path / f"{n}.png"), cv2.IMREAD_UNCHANGED) for n in ("ref", "got"))
    assert got.shape == ref.shape and os.path.getsize(tmp_path / "got.png") > 5000
    np.testing.assert_array_equal(got, ref)


def test_viz_every_writes_the_reference_file_names(tmp_path):
    from tpuslam.apps import rgbd_icl as jrgbd
    from tpuslam_torch.apps import rgbd_icl as trgbd

    root = tds.write_tum(str(tmp_path / "seq"), n_frames=10)
    args = [root, "--features", "512", "--vocab", "lsh", "--max-frames", "5", "--viz-every", "2"]
    jrgbd.main(args + ["--out", str(tmp_path / "jax")])
    trgbd.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    ref, got = (sorted(os.listdir(tmp_path / d / "viz")) for d in ("jax", "port"))
    assert got == ref and "frame_00004.png" in got and "map_00004.png" in got
    img = cv2.imread(str(tmp_path / "port" / "viz" / "frame_00004.png"))
    assert img.shape == (240 + 22, 320, 3)


@pytest.mark.parametrize("missing", ["cv2", "matplotlib"])
def test_viz_every_without_the_package_raises_at_startup(tmp_path, monkeypatch, missing):
    from tpuslam_torch.apps import common, mono_icl

    def no_loop(*a, **kw):
        raise AssertionError("a frame was processed")

    monkeypatch.setitem(sys.modules, missing, None)  # the import now raises ImportError
    monkeypatch.setattr(common, "run_loop", no_loop)
    root = tds.write_icl(str(tmp_path / "seq"), n_frames=2)
    with pytest.raises(ImportError, match=missing):
        mono_icl.main([root, "--vocab", "lsh", "--device", "cpu", "--viz-every", "1", "--out", str(tmp_path)])
