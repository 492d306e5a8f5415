"""The port's dataset readers, trajectory writer and golden-folder writer
against the JAX package's, on the CPU:

* each reader (ICL, TUM RGB-D, KITTI, EuRoC; mono, depth and stereo
  frames) yields the same items as the JAX package's on the same tiny
  folders written by ``cv2.imwrite``: frame ids, stamps, paths, images and
  depth equal, with the plain and the compiled PNG unfilter; ground truth,
  the settings YAML and ``save_kitti``'s rows equal;
* ``write_sequence`` of each package at 160x120: the gray PNGs decode to
  the same pixels and the depth PNGs within one 0.2 mm step (on at most
  0.1% of pixels: the two renderers' float depths agree within 2e-6
  relative, not bit for bit); ``rgb.txt``, ``depth.txt``, ``odom.txt``,
  ``ICL.yaml``, the marker and the cuboid rows are the same text, and the
  plane rows parse to the same values (the centroid columns within the
  error bound of the reference's float32 mean, which adds a face's points
  one by one; the port sums them in float64).
"""

import os

import numpy as np
import pytest

import _torch_datasets as tds
from tpuslam.io import datasets as jds
from tpuslam.io import synth as jsynth
from tpuslam.io import trajectory as jtraj
from tpuslam_torch.io import datasets as pds
from tpuslam_torch.io import synth as psynth
from tpuslam_torch.io import trajectory as ptraj

cv2 = pytest.importorskip("cv2")


def _same_items(j_items, p_items):
    j_items, p_items = list(j_items), list(p_items)
    assert len(j_items) == len(p_items) > 0
    for a, b in zip(j_items, p_items):
        assert (a.frame_id, a.timestamp, a.rgb_path) == (b.frame_id, b.timestamp, b.rgb_path)
        assert b.gray.dtype == np.uint8
        np.testing.assert_array_equal(a.gray, b.gray)
        for name in ("depth", "right"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
def test_icl_and_tum_readers(tmp_path, native):
    root = tds.write_tum(str(tmp_path / "icl"), n_frames=6)
    for kw in ({}, {"with_depth": True}):
        _same_items(jds.IclDataset(root, max_frames=5).frames(**kw),
                    pds.IclDataset(root, max_frames=5, native=native).frames(**kw))
    np.testing.assert_array_equal(jds.IclDataset(root).gt_poses(), pds.IclDataset(root).gt_poses())
    for kw in ({}, {"with_depth": False}):
        _same_items(jds.TumRgbdDataset(root).frames(**kw), pds.TumRgbdDataset(root, native=native).frames(**kw))
    ds = pds.IclDataset(root, native=native)
    list(ds.frames(with_depth=True))
    assert len(ds.decode_ms["gray"]) == len(ds.decode_ms["depth"]) == 6


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
def test_kitti_and_euroc_readers(tmp_path, native):
    kitti = tds.write_kitti(str(tmp_path / "kitti"))
    euroc = tds.write_euroc(str(tmp_path / "euroc"))
    for stereo in (False, True):
        _same_items(jds.KittiOdometryDataset(kitti, max_frames=4).frames(stereo=stereo),
                    pds.KittiOdometryDataset(kitti, max_frames=4, native=native).frames(stereo=stereo))
        _same_items(jds.EurocDataset(euroc).frames(stereo=stereo),
                    pds.EurocDataset(euroc, native=native).frames(stereo=stereo))
    np.testing.assert_array_equal(jds.KittiOdometryDataset(kitti).gt_poses(),
                                  pds.KittiOdometryDataset(kitti).gt_poses())
    np.testing.assert_array_equal(jds.EurocDataset(euroc).gt_poses(), pds.EurocDataset(euroc).gt_poses())
    assert pds.KittiOdometryDataset(str(tmp_path)).gt_poses() is None


def test_settings_yaml_and_tum_rows(tmp_path):
    path = str(tmp_path / "s.yaml")
    with open(path, "w") as f:
        f.write("%YAML:1.0\n# comment\nCamera.fx: 517.3\nCamera.fy: 516.5\nCamera.cx: 318.6\nCamera.cy: 255.3\n"
                "Camera.k1: 0.2624\nCamera.k2: -0.9531\nCamera.p1: -0.0054\nCamera.p2: 0.0026\n"
                "Camera.k3: 1.1633\nCamera.width: 640\nCamera.height: 480\nCamera.bf: 40.0\n"
                "Camera.fps: 30\nname: \"icl\"\noptimize_with_cuboid_3d: 1\n")
    jc, jv = jds.load_settings_yaml(path)
    pc, pv = pds.load_settings_yaml(path, "cpu")
    assert jv == pv
    for k in ("fx", "fy", "cx", "cy", "bf"):
        assert float(np.float32(getattr(jc, k))) == getattr(pc, k), k
    assert (int(jc.width), int(jc.height)) == (pc.width, pc.height)
    np.testing.assert_array_equal(np.asarray(jc.dist), pc.dist.numpy())
    rows = np.random.default_rng(3).normal(size=(7, 8))
    np.testing.assert_array_equal(jds._tum_rows_to_Tcw(rows), pds._tum_rows_to_Tcw(rows))


def test_save_kitti_rows(tmp_path):
    rng = np.random.default_rng(4)
    poses = []
    for _ in range(5):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = q * np.sign(np.linalg.det(q))
        T[:3, 3] = rng.normal(size=3)
        poses.append(T)
    jtraj.save_kitti(str(tmp_path / "j.txt"), poses)
    ptraj.save_kitti(str(tmp_path / "p.txt"), poses)
    a, b = np.loadtxt(tmp_path / "j.txt"), np.loadtxt(tmp_path / "p.txt")
    assert a.shape == b.shape == (5, 12)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_write_sequence_matches_reference(tmp_path):
    cam = jsynth.CameraSpec(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    pcam = psynth.CameraSpec(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    n = 6
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsynth.write_sequence(jdir, n_frames=n, cam=cam, min_plane_pix=300, min_cuboid_pix=40)
    psynth.write_sequence(pdir, n_frames=n, cam=pcam, min_plane_pix=300, min_cuboid_pix=40, device="cpu")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir))
    assert any(nm.startswith("SYNTH_6_160x120_") and nm.endswith(".done") for nm in names)
    for nm in ("rgb.txt", "depth.txt", "odom.txt", "ICL.yaml"):
        assert open(os.path.join(jdir, nm)).read() == open(os.path.join(pdir, nm)).read(), nm
    n_planes = n_cuboids = 0
    for f in range(n):
        for sub in ("rgb", "depth"):
            a = cv2.imread(os.path.join(jdir, sub, f"{f:04d}.png"), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(pdir, sub, f"{f:04d}.png"), cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype
            if sub == "rgb":
                np.testing.assert_array_equal(a, b, err_msg=f"{sub} {f}")
            else:
                # the renderers' float depths agree within 2e-6 relative
                # (test_torch_synth.py), so a depth next to a 0.2 mm step of
                # the uint16 PNG may land one step apart
                d = np.abs(a.astype(np.int64) - b.astype(np.int64))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (f, d.max(), (d > 0).mean())
        cub = f"pred_3d_obj_matched_txt/{f:04d}_3d_cuboids.txt"
        text = open(os.path.join(pdir, cub)).read()
        assert open(os.path.join(jdir, cub)).read() == text
        n_cuboids += len(text.splitlines())
        pl = f"plane_seg/{f}_offline_plane_multiplane.txt"
        a = np.loadtxt(os.path.join(jdir, pl), ndmin=2)
        b = np.loadtxt(os.path.join(pdir, pl), ndmin=2)
        assert a.shape == b.shape
        n_planes += len(a)
        if len(a):
            np.testing.assert_array_equal(a[:, [0, 1, 2, 3, 4, 8]], b[:, [0, 1, 2, 3, 4, 8]])
            # the reference's float32 mean over axis 0 adds the face's points
            # one after another: its error is at most num * 2^-24 * max |p|,
            # |p| below the room's 6 m; the port's float64 sum is exact to 1e-12
            bound = b[:, 8:9] * 2.0 ** -24 * 6.0
            assert (np.abs(b[:, 5:8] - a[:, 5:8]) <= bound).all()
    assert n_planes >= n and n_cuboids >= 1
    # the port's reader gives the renderer's frames and quantized depth back
    items = list(pds.IclDataset(pdir).frames(with_depth=True))
    import torch

    renderer = psynth.make_batch_renderer(pcam, psynth.SceneSpec(), "cpu")
    poses = psynth.trajectory(n, psynth.SceneSpec())
    gray, depth = psynth.render_uint8(renderer, poses, depth=True)
    np.testing.assert_array_equal(np.stack([it.gray for it in items]), gray.numpy())
    assert torch.equal(torch.from_numpy(np.stack([it.depth for it in items])), depth)
    # a written folder is kept
    mtime = os.path.getmtime(os.path.join(pdir, "rgb", "0000.png"))
    psynth.write_sequence(pdir, n_frames=n, cam=pcam, device="cpu")
    assert os.path.getmtime(os.path.join(pdir, "rgb", "0000.png")) == mtime
