"""Semantic detections: offline planes and cuboids, and the RGB-D online
plane segmentation (port of ``tpuslam/semantic/detect.py``).

The reference consumes per-frame detection text files: plane rows
``[id nx ny nz d cx cy cz num]`` (Tracking.cc:2354-2377) and cuboid rows
``classname x y z roll pitch yaw sx sy sz`` (Tracking.cc:1991-1997).  Cuboid
measurements are taken from the global frame into the camera frame with the
frame's ground-truth pose, and the 2D bbox and corners come from projecting
the global cuboid with that pose (Tracking.cc:2004-2060).

The offline readers are host numpy, as in the reference: per-frame detector
I/O is a handful of 4x4 products, and the consumers move it to the device at
keyframe time.  :func:`detect_planes_online` runs on the depth image's
device and returns tensors there.  Each reader is split into a row-parsing core
(:func:`planes_from_rows`, :func:`cuboids_from_lines`) and the file reader,
so that detections made in memory go through the same parsing.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..kernels.planes import segment_planes


class PlaneDetections(NamedTuple):
    """Per-frame plane measurements in the CAMERA frame, padded to L: host
    numpy (offline rows) or tensors (online segmentation)."""

    coef: np.ndarray  # (L, 4) Hessian form, d >= 0
    centroid: np.ndarray  # (L, 3)
    valid: np.ndarray  # (L,) bool

    @staticmethod
    def empty(l):
        return PlaneDetections(
            coef=np.tile(np.array([[0.0, 0.0, 1.0, 1.0]], np.float32), (l, 1)),
            centroid=np.zeros((l, 3), np.float32),
            valid=np.zeros(l, bool),
        )


class CuboidDetections(NamedTuple):
    """Per-frame cuboid measurements, padded to O."""

    local_pose: np.ndarray  # (O, 4, 4) object->camera
    local_scale: np.ndarray  # (O, 3)
    global_pose: np.ndarray  # (O, 4, 4) object->world (through the GT pose)
    global_scale: np.ndarray  # (O, 3)
    bbox: np.ndarray  # (O, 4) [cx, cy, w, h]
    corners: np.ndarray  # (O, 16) projected corner pixels
    classid: np.ndarray  # (O,) int32
    quality: np.ndarray  # (O,) meas_quality (0.7 by default)
    valid: np.ndarray  # (O,) bool

    @staticmethod
    def empty(o):
        eye = np.broadcast_to(np.eye(4, dtype=np.float32), (o, 4, 4)).copy()
        return CuboidDetections(
            local_pose=eye,
            local_scale=np.ones((o, 3), np.float32),
            global_pose=eye.copy(),
            global_scale=np.ones((o, 3), np.float32),
            bbox=np.zeros((o, 4), np.float32),
            corners=np.zeros((o, 16), np.float32),
            classid=np.full(o, -1, np.int32),
            quality=np.full(o, 0.7, np.float32),
            valid=np.zeros(o, bool),
        )


def detect_planes_online(depth, cam, cap: int, stride: int = 3) -> PlaneDetections:
    """Online plane segmentation of a (H, W) float32 depth tensor: the PCL
    OrganizedMultiPlaneSegmentation path of DetectPlane (Tracking.cc:2404-2513,
    detect.py:77-90 of the reference) through ``kernels/planes.py``.  The
    detections stay on the depth's device."""
    coef, centroid, _, valid = segment_planes(depth, float(cam.fx), float(cam.fy), float(cam.cx),
                                              float(cam.cy), stride=stride, max_planes=cap)
    return PlaneDetections(coef=coef, centroid=centroid, valid=valid)


def planes_from_rows(rows, cap: int) -> PlaneDetections:
    """Detections from parsed plane rows ``[id nx ny nz d cx cy cz num]``
    (float64, as ``np.loadtxt`` gives them); the coefficients are cast to
    float32 and sign-normalized to d >= 0."""
    rows = np.asarray(rows, np.float64).reshape(-1, 9)
    if rows.size == 0:
        return PlaneDetections.empty(cap)
    coef = np.zeros((cap, 4), np.float32)
    cent = np.zeros((cap, 3), np.float32)
    valid = np.zeros(cap, bool)
    for i in range(min(len(rows), cap)):
        c = rows[i, 1:5].astype(np.float32)
        if c[3] < 0:
            c = -c
        coef[i] = c
        cent[i] = rows[i, 5:8]
        valid[i] = True
    return PlaneDetections(coef=coef, centroid=cent, valid=valid)


def read_offline_planes(path: str, cap: int) -> PlaneDetections:
    """Read a ``*_offline_plane_multiplane.txt`` file (Tracking.cc:2354-2377)."""
    if not os.path.exists(path):
        return PlaneDetections.empty(cap)
    return planes_from_rows(np.loadtxt(path, ndmin=2, dtype=np.float64), cap)


_CLASSNAME_IDS: dict = {}


def classname_to_id(name: str) -> int:
    """Integer ids for detection class names, given in the order the names
    are first seen in this process (association by classname compares the
    strings, Tracking.cc:2168-2217)."""
    if name not in _CLASSNAME_IDS:
        _CLASSNAME_IDS[name] = len(_CLASSNAME_IDS)
    return _CLASSNAME_IDS[name]


def parse_obj_lines(lines):
    """``classname v1 v2 ...`` rows (matrix_utils read_obj_detection_txt) ->
    (names, (n, k) float64 values); blank lines are skipped."""
    names, vals = [], []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        names.append(parts[0])
        vals.append([float(x) for x in parts[1:]])
    return names, np.asarray(vals, np.float64)


def read_obj_detection_txt(path: str):
    with open(path) as f:
        return parse_obj_lines(f)


def _np_euler_zyx_to_R(roll, pitch, yaw):
    """Rz(yaw) Ry(pitch) Rx(roll) in numpy float32 (geometry.euler_zyx_to_R)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ],
        np.float32,
    )


def _np_project_corners(pose_g, scale_g, Tcw, K):
    """(8, 2) pixel corners of a cuboid (geometry.cuboid_project_corners in
    numpy), in the corner order of g2o_cuboid.h:200-204."""
    sx, sy, sz = scale_g
    signs = np.array(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32)
    corners_o = signs * np.array([sx, sy, sz], np.float32)
    cw = corners_o @ pose_g[:3, :3].T + pose_g[:3, 3]
    cc = cw @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = np.maximum(cc[:, 2], 1e-6)
    return np.stack(
        [K[0, 0] * cc[:, 0] / z + K[0, 2], K[1, 1] * cc[:, 1] / z + K[1, 2]],
        axis=-1,
    ).astype(np.float32)


def cuboids_from_lines(names, rows, truth_Twc, K, cap: int) -> CuboidDetections:
    """Camera-frame measurements from parsed global cuboid rows and the
    frame's (4, 4) camera-to-world GT pose ``truth_Twc`` (Tracking.cc:2004-2060)."""
    det = CuboidDetections.empty(cap)
    rows = np.asarray(rows, np.float64)
    if rows.size == 0:
        return det
    Twc = np.asarray(truth_Twc, np.float32)
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, :3] = Twc[:3, :3].T
    Tcw[:3, 3] = -Twc[:3, :3].T @ Twc[:3, 3]
    Kn = np.asarray(K, np.float32)
    for i in range(min(len(rows), cap)):
        v9 = rows[i, -9:].astype(np.float32)
        pose_g = np.eye(4, dtype=np.float32)
        pose_g[:3, :3] = _np_euler_zyx_to_R(v9[3], v9[4], v9[5])
        pose_g[:3, 3] = v9[:3]
        scale_g = v9[6:9]
        corners = _np_project_corners(pose_g, scale_g, Tcw, Kn)
        lo, hi = corners.min(axis=0), corners.max(axis=0)
        det.local_pose[i], det.local_scale[i] = Tcw @ pose_g, scale_g  # transform_to(Twc)
        det.global_pose[i], det.global_scale[i] = pose_g, scale_g
        det.bbox[i] = np.array([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[0] - lo[0], hi[1] - lo[1]],
                               np.float32)
        det.corners[i] = corners.reshape(16)
        det.classid[i] = classname_to_id(names[i])
        det.valid[i] = True
    return det


def read_offline_cuboids(path: str, truth_Twc, K, cap: int) -> CuboidDetections:
    """Read a per-frame global cuboid file and convert it to camera-frame
    measurements with the frame's GT pose."""
    if not os.path.exists(path):
        return CuboidDetections.empty(cap)
    names, rows = read_obj_detection_txt(path)
    return cuboids_from_lines(names, rows, truth_Twc, K, cap)
