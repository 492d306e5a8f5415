"""Synthetic feature-level sequences for closed-loop testing (port of
``tpuslam/io/synthetic.py``).

The feature measurements are synthesized directly from a known scene and
trajectory, so that tracking, mapping and BA run end to end against exact
ground truth with no image in the loop: :func:`render_frame` gives the
``Frame`` that :meth:`Tracker.process_frame` takes, and the detection
renderers give the offline plane and cuboid detections a keyframe consumes.

The scene is numpy, drawn from ``np.random.RandomState(seed)`` in the
reference's order, so that either package's scene feeds either package's
renderers; the renderers keep the reference's seeds and numpy draws, and
run the port's geometry on ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import geometry as geo
from ..core.camera import Camera, camera_matrix
from ..frontend.tracking import Frame
from ..semantic.detect import CuboidDetections, PlaneDetections


class SyntheticScene(NamedTuple):
    points: np.ndarray  # (M, 3) world points
    desc: np.ndarray  # (M, 8) uint32 descriptors
    poses: np.ndarray  # (F, 4, 4) GT world->camera
    planes: np.ndarray  # (R, 4) GT world planes (may be empty)
    cuboids: np.ndarray  # (O, 9) GT cuboid minimal vectors (may be empty)


def make_room_scene(
    n_points: int = 800,
    n_frames: int = 60,
    seed: int = 0,
    with_planes: bool = False,
    with_cuboids: bool = False,
):
    """An indoor-ish box of points (three walls and clutter) with a smooth
    forward and arc trajectory."""
    rng = np.random.RandomState(seed)
    n_wall = n_points // 2
    walls = []
    m = n_wall // 3
    walls.append(np.stack([rng.uniform(-4, 4, m), rng.uniform(-2, 2, m), np.full(m, 8.0)], 1))
    walls.append(np.stack([np.full(m, -4.0), rng.uniform(-2, 2, m), rng.uniform(2, 8, m)], 1))
    walls.append(np.stack([rng.uniform(-4, 4, m), np.full(m, 2.0), rng.uniform(2, 8, m)], 1))
    clutter = np.stack(
        [rng.uniform(-3.5, 3.5, n_points - 3 * m), rng.uniform(-1.8, 1.8, n_points - 3 * m),
         rng.uniform(2.5, 7.5, n_points - 3 * m)], 1)
    points = np.concatenate(walls + [clutter], 0).astype(np.float32)
    desc = rng.randint(0, 1 << 32, (points.shape[0], 8), dtype=np.uint64).astype(np.uint32)

    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        t_wc = np.array([2.0 * s, 0.2 * np.sin(2 * np.pi * s), 1.0 * s], np.float32)
        roll, pitch, yaw = (torch.tensor(x, dtype=torch.float32) for x in (0.0, 0.05 * np.sin(2 * np.pi * s), 0.25 * s))
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = geo.euler_zyx_to_R(roll, pitch, yaw).numpy()
        T_wc[:3, 3] = t_wc
        poses.append(np.linalg.inv(T_wc))  # world->camera
    poses = np.stack(poses)

    planes = np.zeros((0, 4), np.float32)
    if with_planes:
        planes = np.array(
            [
                [0.0, 0.0, -1.0, 8.0],  # z = 8 wall
                [1.0, 0.0, 0.0, 4.0],  # x = -4 wall
                [0.0, -1.0, 0.0, 2.0],  # y = 2 wall
            ],
            np.float32,
        )
    cuboids = np.zeros((0, 9), np.float32)
    if with_cuboids:
        cuboids = np.array(
            [
                [1.2, 0.8, 5.5, 0.0, 0.0, 0.3, 0.9, 0.7, 0.9],
                [-0.5, 0.9, 7.3, 0.0, 0.0, -0.5, 0.8, 0.6, 0.8],
            ],
            np.float32,
        )
    return SyntheticScene(points=points, desc=desc, poses=poses, planes=planes, cuboids=cuboids)


def render_plane_detections(scene: SyntheticScene, frame_idx: int, cap: int, noise: float = 0.01, seed: int = 2,
                            device="cuda:0") -> PlaneDetections:
    """Camera-frame plane measurements from the ground-truth planes (a
    stand-in for the offline plane rows), host numpy as the offline reader
    gives them; the transform runs on ``device``."""
    if scene.planes.shape[0] == 0:
        return PlaneDetections.empty(cap)
    rng = np.random.RandomState(seed * 7919 + frame_idx)
    T = torch.from_numpy(scene.poses[frame_idx]).to(device)
    world = torch.from_numpy(scene.planes).to(device)
    local = geo.plane_transform(T, geo.plane_normalize(world)).cpu().numpy()
    coef = np.zeros((cap, 4), np.float32)
    cent = np.zeros((cap, 3), np.float32)
    valid = np.zeros(cap, bool)
    n = min(len(local), cap)
    for i in range(n):
        c = local[i] + rng.randn(4).astype(np.float32) * noise
        c = c / np.linalg.norm(c[:3])
        if c[3] < 0:
            c = -c
        # only "see" planes within range
        if abs(c[3]) > 12.0:
            continue
        coef[i] = c
        valid[i] = True
    return PlaneDetections(coef=coef, centroid=cent, valid=valid)


def render_cuboid_detections(scene: SyntheticScene, frame_idx: int, cam: Camera, cap: int, noise: float = 0.02,
                             seed: int = 3, device="cuda:0") -> CuboidDetections:
    """Global-frame cuboid measurements taken into the camera with the
    ground-truth pose, as the reference's offline pipeline does
    (Tracking.cc:2004-2060); a cuboid whose projected box leaves the image
    is not detected.  Host numpy; the geometry runs on ``device``."""
    det = CuboidDetections.empty(cap)
    if scene.cuboids.shape[0] == 0:
        return det
    rng = np.random.RandomState(seed * 104729 + frame_idx)
    Tcw = torch.from_numpy(scene.poses[frame_idx]).to(device)
    K = camera_matrix(cam).to(device)
    lp, ls, gp, gs = (x.copy() for x in (det.local_pose, det.local_scale, det.global_pose, det.global_scale))
    bb, cc, ci, vv = (x.copy() for x in (det.bbox, det.corners, det.classid, det.valid))
    n = min(len(scene.cuboids), cap)
    for i in range(n):
        v9 = scene.cuboids[i].copy()
        v9[:3] += rng.randn(3) * noise
        v9[5] += rng.randn() * noise  # yaw only
        v9[6:] += rng.randn(3) * noise * 0.5
        pose_g, scale_g = geo.cuboid_from_minimal(torch.from_numpy(v9).to(device))
        b = geo.cuboid_project_bbox(pose_g, scale_g, Tcw, K).cpu().numpy()
        # visibility: the box wholly inside the frame
        if not (
            b[0] - b[2] / 2 > 5 and b[1] - b[3] / 2 > 5
            and b[0] + b[2] / 2 < cam.width - 5 and b[1] + b[3] / 2 < cam.height - 5
        ):
            continue
        lp[i] = (Tcw @ pose_g).cpu().numpy()
        ls[i] = gs[i] = scale_g.cpu().numpy()
        gp[i] = pose_g.cpu().numpy()
        bb[i] = b
        cc[i] = geo.cuboid_project_corners(pose_g, scale_g, Tcw, K).reshape(16).cpu().numpy()
        ci[i] = i  # class id == ground-truth object index
        vv[i] = True
    return CuboidDetections(local_pose=lp, local_scale=ls, global_pose=gp, global_scale=gs, bbox=bb, corners=cc,
                            classid=ci, quality=det.quality, valid=vv)


def render_frame(
    scene: SyntheticScene,
    frame_idx: int,
    cam: Camera,
    n_features: int = 512,
    pix_noise: float = 0.3,
    desc_flips: int = 4,
    seed: int = 1,
    with_depth: bool = False,
    depth_noise: float = 0.01,
    device="cuda:0",
) -> Frame:
    """Project the scene into view ``frame_idx`` and emit a ``Frame`` padded
    to ``n_features`` on ``device``: the visible points in a seeded random
    order, their pixels with noise, their descriptors with ``desc_flips``
    random bits flipped, and with ``with_depth`` their noisy depth and
    right-view u.  The draws are the reference's, in its order (numpy)."""
    rng = np.random.RandomState(seed * 10007 + frame_idx)
    T = scene.poses[frame_idx]
    pc = (T[:3, :3] @ scene.points.T).T + T[:3, 3]
    z = pc[:, 2]
    u = float(cam.fx) * pc[:, 0] / np.maximum(z, 1e-6) + float(cam.cx)
    v = float(cam.fy) * pc[:, 1] / np.maximum(z, 1e-6) + float(cam.cy)
    vis = (z > 0.3) & (u >= 8) & (u < cam.width - 8) & (v >= 8) & (v < cam.height - 8)
    ids = np.where(vis)[0]
    rng.shuffle(ids)
    ids = ids[:n_features]
    n = len(ids)
    uv = np.zeros((n_features, 2), np.float32)
    uv[:n, 0] = u[ids] + rng.randn(n) * pix_noise
    uv[:n, 1] = v[ids] + rng.randn(n) * pix_noise
    desc = np.zeros((n_features, 8), np.uint32)
    desc[:n] = scene.desc[ids]
    # flip a few random bits per observation (descriptor noise)
    for _ in range(desc_flips):
        word = rng.randint(0, 8, n)
        bit = rng.randint(0, 32, n).astype(np.uint32)
        desc[np.arange(n), word] ^= (np.uint32(1) << bit)
    valid = np.zeros(n_features, bool)
    valid[:n] = True
    depth = np.full(n_features, -1.0, np.float32)
    ur = np.full(n_features, -1.0, np.float32)
    if with_depth:
        depth[:n] = z[ids] * (1.0 + rng.randn(n) * depth_noise)
        bf = float(cam.bf) if float(cam.bf) > 0 else 40.0
        ur[:n] = uv[:n, 0] - bf / np.maximum(depth[:n], 1e-6)

    def up(a):
        return torch.from_numpy(a).to(device)

    return Frame(
        uv=up(uv),
        octave=torch.zeros(n_features, dtype=torch.int32, device=device),
        angle=torch.zeros(n_features, dtype=torch.float32, device=device),
        desc=up(desc.view(np.int32)),  # the uint32 words' bits as int32 (frontend/tracking.py:62)
        valid=up(valid),
        ur=up(ur),
        depth=up(depth),
    )
