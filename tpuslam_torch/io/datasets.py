"""Dataset readers: ICL-NUIM / TUM RGB-D / KITTI odometry / EuRoC (port of
``tpuslam/io/datasets.py``), with the reference's YAML settings parser.

Images are decoded by :mod:`.png` (``cv2.imread`` there): frames stay uint8
on the host, and the ``Tracker`` casts them on its device, so a frame's
upload is a quarter of a float32 one.  Each reader takes ``native``: undo
the PNG row filters in the compiled helper (the CLIs pass it on the card),
and records the host ms of each decode in ``decode_ms`` by image
kind (``gray``, ``depth``, ``right``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.camera import Camera
from . import png


@dataclass
class SequenceItem:
    frame_id: int
    timestamp: float
    gray: np.ndarray  # (H, W) uint8
    depth: Optional[np.ndarray] = None  # (H, W) float32 metres, None if mono
    rgb_path: str = ""
    right: Optional[np.ndarray] = None  # (H, W) uint8 right image (stereo)


def _timed(log: dict, kind: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
    return out


def _imread_gray(path, native: bool = False):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return png.imread_gray(path, native)


def _imread_depth(path, factor, native: bool = False):
    """Depth in metres (``IMREAD_UNCHANGED`` / ``factor`` in float32), None
    for a missing file as the reference's ``cv2.imread`` gives."""
    if not os.path.exists(path):
        return None
    return png.imread_unchanged(path, native).astype(np.float32) / np.float32(factor)


@dataclass
class IclDataset:
    """ICL-NUIM in TUM format: ``rgb.txt`` (+ optional ``depth.txt``), GT
    odometry in ``odom.txt`` as rows ``[t x y z qx qy qz qw]``
    (Tracking.cc:191-229, mono_icl_test.cc:155-182)."""

    folder: str
    rgb_list: str = "rgb.txt"
    depth_list: str = "depth.txt"
    truth_file: str = "odom.txt"
    depth_factor: float = 5000.0
    max_frames: int = 0
    native: bool = False
    decode_ms: dict = field(default_factory=dict)

    def frames(self, with_depth: bool = False) -> Iterator[SequenceItem]:
        rgb_rows = _read_list(os.path.join(self.folder, self.rgb_list))
        depth_path = os.path.join(self.folder, self.depth_list)
        depth_rows = _read_list(depth_path) if with_depth and os.path.exists(depth_path) else []
        n = len(rgb_rows) if self.max_frames <= 0 else min(self.max_frames, len(rgb_rows))
        for i in range(n):
            stamp, rel = rgb_rows[i]
            gray = _timed(self.decode_ms, "gray", _imread_gray, os.path.join(self.folder, rel), self.native)
            depth = None
            if i < len(depth_rows):
                depth = _timed(self.decode_ms, "depth", _imread_depth, os.path.join(self.folder, depth_rows[i][1]),
                               self.depth_factor, self.native)
            yield SequenceItem(i, stamp, gray, depth, rel)

    def gt_poses(self) -> np.ndarray:
        """(F, 4, 4) world->camera GT from [t x y z qx qy qz qw] rows."""
        rows = np.loadtxt(os.path.join(self.folder, self.truth_file), ndmin=2)
        return _tum_rows_to_Tcw(rows)


@dataclass
class TumRgbdDataset:
    """TUM RGB-D with an associations file (rgbd_tum.cc LoadImages)."""

    folder: str
    associations: str = "associations.txt"
    depth_factor: float = 5000.0
    max_frames: int = 0
    native: bool = False
    decode_ms: dict = field(default_factory=dict)

    def frames(self, with_depth: bool = True) -> Iterator[SequenceItem]:
        rows = []
        with open(os.path.join(self.folder, self.associations)) as f:
            for line in f:
                p = line.split()
                if len(p) >= 4 and not line.startswith("#"):
                    rows.append((float(p[0]), p[1], p[3]))
        n = len(rows) if self.max_frames <= 0 else min(self.max_frames, len(rows))
        for i in range(n):
            stamp, rgb_rel, depth_rel = rows[i]
            gray = _timed(self.decode_ms, "gray", _imread_gray, os.path.join(self.folder, rgb_rel), self.native)
            depth = (_timed(self.decode_ms, "depth", _imread_depth, os.path.join(self.folder, depth_rel),
                            self.depth_factor, self.native) if with_depth else None)
            yield SequenceItem(i, stamp, gray, depth, rgb_rel)


@dataclass
class KittiOdometryDataset:
    """KITTI odometry grayscale sequence (stereo_kitti.cc LoadImages)."""

    folder: str  # e.g. sequences/00
    max_frames: int = 0
    native: bool = False
    decode_ms: dict = field(default_factory=dict)

    def frames(self, stereo: bool = False) -> Iterator[SequenceItem]:
        left_dir = os.path.join(self.folder, "image_0")
        right_dir = os.path.join(self.folder, "image_1")
        names = sorted(os.listdir(left_dir))
        n = len(names) if self.max_frames <= 0 else min(self.max_frames, len(names))
        times_path = os.path.join(self.folder, "times.txt")
        times = np.loadtxt(times_path) if os.path.exists(times_path) else np.arange(n) * 0.1
        for i in range(n):
            gray = _timed(self.decode_ms, "gray", _imread_gray, os.path.join(left_dir, names[i]), self.native)
            right = None
            if stereo and os.path.exists(os.path.join(right_dir, names[i])):
                right = _timed(self.decode_ms, "right", _imread_gray, os.path.join(right_dir, names[i]),
                               self.native)
            yield SequenceItem(i, float(times[i]), gray, None, names[i], right=right)

    def gt_poses(self) -> Optional[np.ndarray]:
        """(F, 4, 4) world->camera from a KITTI ``poses/NN.txt``-style file
        (12 numbers per row, Twc) placed at ``<folder>/poses.txt``."""
        path = os.path.join(self.folder, "poses.txt")
        if not os.path.exists(path):
            return None
        rows = np.loadtxt(path, ndmin=2)
        out = []
        for r in rows:
            T_wc = np.eye(4, dtype=np.float32)
            T_wc[:3, :4] = r.reshape(3, 4)
            out.append(np.linalg.inv(T_wc))
        return np.stack(out)


@dataclass
class EurocDataset:
    """EuRoC MAV (mono_euroc.cc / stereo_euroc.cc LoadImages):
    ``mav0/cam0/data/<ns>.png`` named by nanosecond timestamps, stereo pairs
    from ``mav0/cam1/data``; images assumed pre-rectified."""

    folder: str  # the mav0 parent (sequence root)
    max_frames: int = 0
    native: bool = False
    decode_ms: dict = field(default_factory=dict)

    def frames(self, stereo: bool = False) -> Iterator[SequenceItem]:
        cam0 = os.path.join(self.folder, "mav0", "cam0", "data")
        cam1 = os.path.join(self.folder, "mav0", "cam1", "data")
        names = sorted(os.listdir(cam0))
        n = len(names) if self.max_frames <= 0 else min(self.max_frames, len(names))
        for i in range(n):
            stamp = float(os.path.splitext(names[i])[0]) * 1e-9
            gray = _timed(self.decode_ms, "gray", _imread_gray, os.path.join(cam0, names[i]), self.native)
            right = None
            if stereo and os.path.exists(os.path.join(cam1, names[i])):
                right = _timed(self.decode_ms, "right", _imread_gray, os.path.join(cam1, names[i]), self.native)
            yield SequenceItem(i, stamp, gray, None, names[i], right=right)

    def gt_poses(self) -> Optional[np.ndarray]:
        """GT from ``mav0/state_groundtruth_estimate0/data.csv`` (ns, p_xyz,
        q_wxyz, ...) -> (F, 4, 4) Tcw."""
        path = os.path.join(self.folder, "mav0", "state_groundtruth_estimate0", "data.csv")
        if not os.path.exists(path):
            return None
        rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
        # q is w,x,y,z in EuRoC; reorder to x,y,z,w
        tum = np.concatenate([rows[:, 0:1] * 1e-9, rows[:, 1:4], rows[:, 5:8], rows[:, 4:5]], axis=1)
        return _tum_rows_to_Tcw(tum)


def _read_list(path) -> List[Tuple[float, str]]:
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.split()
            if len(p) >= 2:
                rows.append((float(p[0]), p[1]))
    return rows


def _tum_rows_to_Tcw(rows: np.ndarray) -> np.ndarray:
    """[.. tx ty tz qx qy qz qw] camera-to-world rows -> (F, 4, 4) float32
    world->camera poses, in float64 until the last cast."""
    t = rows[:, -7:-4].astype(np.float64)
    q = rows[:, -4:].astype(np.float64)  # (x, y, z, w)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(rows), 3, 3), np.float64)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    out = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
    Rt = R.transpose(0, 2, 1)  # Tcw = [R^T | -R^T t]
    out[:, :3, :3] = Rt
    out[:, :3, 3] = -np.einsum("nij,nj->ni", Rt, t)
    return out


def load_settings_yaml(path: str, device="cuda:0"):
    """The reference's OpenCV-YAML settings (``%YAML:1.0`` header, flat
    ``Key.Sub: value`` keys; mono_icl_test.cc:184-234, Tracking.cc:61-146)
    -> (Camera on ``device``, dict of every value)."""
    vals = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or line.startswith("%") or ":" not in line:
                continue
            k, v = line.split(":", 1)
            v = v.strip().strip('"')
            try:
                vals[k.strip()] = float(v) if "." in v or "e" in v.lower() else int(v)
            except ValueError:
                vals[k.strip()] = v
    cam = Camera.make(
        fx=vals.get("Camera.fx", 500.0), fy=vals.get("Camera.fy", 500.0),
        cx=vals.get("Camera.cx", 320.0), cy=vals.get("Camera.cy", 240.0), device=device,
        dist=np.array([vals.get(k, 0.0) for k in ("Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2", "Camera.k3")],
                      np.float32),
        width=int(vals.get("Camera.width", 640)), height=int(vals.get("Camera.height", 480)),
        bf=vals.get("Camera.bf", 0.0),
    )
    return cam, vals
