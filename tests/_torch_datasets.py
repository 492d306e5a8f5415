"""Tiny dataset folders on disk for the port's reader and CLI tests: the
ICL layout of ``tests/test_apps.py`` (its own writer, 10 frames of a
textured wall at 240x320 with a lateral camera), a TUM RGB-D layout
(``associations.txt``), a KITTI odometry layout (``image_0``/``image_1``,
``times.txt``, ``poses.txt``) and a EuRoC layout (``mav0/cam{0,1}/data``,
``state_groundtruth_estimate0/data.csv``), all cut from one wall texture.
The images are written by ``cv2.imwrite``; the stereo right view is the
wall ``STEREO_SHIFT`` pixels further along (uR = uL - bf / Z), so its
disparity is exact."""

import os

import cv2
import numpy as np

from test_apps import BF, FX, H, W, Z_WALL, _write_icl_dataset

STEREO_SHIFT = int(round(BF / Z_WALL))  # disparity bf / Z in pixels


def wall(n_frames: int, px_step: int = 4, seed: int = 0):
    """(n_frames, H, W) uint8 views of a smoothed random wall, the camera
    moving ``px_step`` px per frame, and the right views."""
    rng = np.random.default_rng(seed)
    margin = px_step * n_frames + 16 + STEREO_SHIFT
    base = rng.uniform(0, 255, (H, W + margin)).astype(np.float32)
    k = np.ones((3, 3), np.float32) / 9.0
    for _ in range(2):
        p = np.pad(base, 1, mode="edge")
        base = sum(k[i, j] * p[i:i + H, j:j + W + margin] for i in range(3) for j in range(3))
    s = STEREO_SHIFT
    left = np.stack([base[:, i * px_step:i * px_step + W] for i in range(n_frames)]).astype(np.uint8)
    right = np.stack([base[:, s + i * px_step:s + i * px_step + W] for i in range(n_frames)]).astype(np.uint8)
    return left, right


def _twc_rows(n, px_step=4):
    dx = px_step * Z_WALL / FX
    return [np.array([[1, 0, 0, i * dx], [0, 1, 0, 0], [0, 0, 1, 0]], np.float64) for i in range(n)]


def _settings(path, bf=BF):
    with open(path, "w") as f:
        f.write("%YAML:1.0\n"
                f"Camera.fx: {FX}\nCamera.fy: {FX}\nCamera.cx: {W / 2.0}\nCamera.cy: {H / 2.0}\n"
                f"Camera.width: {W}\nCamera.height: {H}\nCamera.bf: {bf}\n")
    return path


def write_icl(root, n_frames=10):
    os.makedirs(root, exist_ok=True)
    _write_icl_dataset(root, n_frames=n_frames)
    return root


def write_tum(root, n_frames=6):
    """ICL's files plus an ``associations.txt`` (rgb and depth rows paired)."""
    write_icl(root, n_frames)
    with open(os.path.join(root, "associations.txt"), "w") as f:
        f.write("# timestamp rgb timestamp depth\n")
        for i in range(n_frames):
            f.write(f"{float(i):.4f} rgb/{i:04d}.png {float(i):.4f} depth/{i:04d}.png\n")
    return root


def write_kitti(root, n_frames=6):
    left, right = wall(n_frames)
    for d in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n_frames):
        cv2.imwrite(os.path.join(root, "image_0", f"{i:06d}.png"), left[i])
        cv2.imwrite(os.path.join(root, "image_1", f"{i:06d}.png"), right[i])
    np.savetxt(os.path.join(root, "times.txt"), np.arange(n_frames) * 0.1)
    np.savetxt(os.path.join(root, "poses.txt"), np.stack([r.reshape(-1) for r in _twc_rows(n_frames)]))
    _settings(os.path.join(root, "KITTI.yaml"))
    return root


def write_euroc(root, n_frames=6):
    left, right = wall(n_frames)
    cam0 = os.path.join(root, "mav0", "cam0", "data")
    cam1 = os.path.join(root, "mav0", "cam1", "data")
    gtd = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    for d in (cam0, cam1, gtd):
        os.makedirs(d, exist_ok=True)
    stamps = [1403636579763555584 + 50000000 * i for i in range(n_frames)]
    for i, ns in enumerate(stamps):
        cv2.imwrite(os.path.join(cam0, f"{ns}.png"), left[i])
        cv2.imwrite(os.path.join(cam1, f"{ns}.png"), right[i])
    with open(os.path.join(gtd, "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for ns, T in zip(stamps, _twc_rows(n_frames)):
            f.write(f"{ns},{T[0, 3]:.6f},{T[1, 3]:.6f},{T[2, 3]:.6f},1,0,0,0\n")
    _settings(os.path.join(root, "EuRoC.yaml"))
    return root
