"""The tracking slice's workload and frame loop (counterpart of
``bench.py:build_workload``, bench.py:114-134).

A textured wall at ``Z_WALL`` seen by a camera that translates sideways:
each frame is a crop of one wide smoothed-noise texture, shifted
``PX_STEP`` pixels from the last, so descriptors really re-detect across
frames.  Keyframe 0 holds frame 0's features, with each valid keypoint
backprojected to a map point at the wall depth.  :func:`run_slice` then runs
``track_image_and_decide`` on every frame, chaining each frame's device
outputs into the next as ``Tracker.process_image`` does.

Everything is made from ``seed`` with numpy, so the JAX package can be run on
the same frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .core.camera import Camera
from .core.config import Capacities, SlamConfig
from .frontend.tracking import Frame, frame_from_features, track_image_and_decide
from .kernels.orb import OrbExtractor
from .map import mapstate as ms

HEIGHT, WIDTH = 480, 640
N_FRAMES = 64
FX = FY = 500.0
Z_WALL = 5.0
PX_STEP = 3  # lateral image shift per frame

# a cut of the workload for CPU runs and card-vs-CPU checks: 4 frames of
# 240x320, 4 levels, 256 features, 8 keyframes, 1024 points, 512 local points
SMALL = dict(
    n_frames=4, height=240, width=320, n_levels=4,
    caps=Capacities(max_keyframes=8, max_keypoints=256, max_points=1024, local_ba_points=512),
)


def make_frames(n_frames: int = N_FRAMES, height: int = HEIGHT, width: int = WIDTH, seed: int = 0):
    """(n_frames, height, width) float32 numpy frames, as bench.py makes them."""
    rng = np.random.RandomState(seed)
    margin = PX_STEP * n_frames + 8
    base = rng.uniform(0, 255, (height, width + margin)).astype(np.float32)
    k = np.ones((3, 3), np.float32) / 9.0
    for _ in range(2):
        p = np.pad(base, 1, mode="edge")
        base = sum(
            k[i, j] * p[i : i + height, j : j + width + margin] for i in range(3) for j in range(3)
        )
    return np.stack([base[:, i * PX_STEP : i * PX_STEP + width] for i in range(n_frames)])


def expected_final_x(n_frames: int) -> float:
    """Camera x after the last frame: the wall shifts PX_STEP px per frame."""
    return (n_frames - 1) * PX_STEP * Z_WALL / FX


class Workload(NamedTuple):
    frames: torch.Tensor  # (F, H, W) float32 on the device
    cam: Camera
    extractor: OrbExtractor
    map: ms.MapState  # keyframe 0 and its points
    kf0: Frame  # frame 0's features (keyframe 0)
    kf0_pt: torch.Tensor  # (N,) int32 keyframe 0's keypoint -> point ids
    caps: Capacities


def build_map(feats_frame: Frame, cam: Camera, caps: Capacities, device):
    """Map with keyframe 0 = ``feats_frame`` at the identity pose; its valid
    keypoints become points at depth Z_WALL.  Returns (map, kf0 point ids)."""
    N = caps.max_keypoints
    u, v = feats_frame.uv[:, 0], feats_frame.uv[:, 1]
    pts = torch.stack(
        [(u - cam.cx) * Z_WALL / cam.fx, (v - cam.cy) * Z_WALL / cam.fy, torch.full_like(u, Z_WALL)],
        dim=-1,
    )
    slots = torch.arange(N, device=device)
    m = ms.empty_map(caps, device)
    m = ms.add_points(
        m, slots, pts, feats_frame.desc, torch.zeros((N, 3), device=device),
        torch.zeros(N, device=device), torch.full((N,), 1e9, device=device),
        torch.zeros(N, dtype=torch.int32, device=device), feats_frame.valid,
    )
    pt_ids = torch.where(feats_frame.valid, slots, -1).to(torch.int32)
    m = ms.add_keyframe(
        m, 0, torch.eye(4, device=device), 0, feats_frame.uv, feats_frame.octave,
        feats_frame.angle, feats_frame.desc, feats_frame.valid, pt_ids,
        feats_frame.ur, feats_frame.depth,
    )
    return m, pt_ids


def build_workload(device, n_frames: int = N_FRAMES, height: int = HEIGHT, width: int = WIDTH,
                   caps: Capacities = Capacities(), n_levels: int = 8) -> Workload:
    frames = torch.as_tensor(make_frames(n_frames, height, width), device=device)
    cam = Camera.make(FX, FY, width / 2.0, height / 2.0, device, width=width, height=height)
    extractor = OrbExtractor(height, width, device, n_features=caps.max_keypoints, n_levels=n_levels)
    kf0 = frame_from_features(extractor(frames[0]), cam)
    m, kf0_pt = build_map(kf0, cam, caps, device)
    return Workload(frames, cam, extractor, m, kf0, kf0_pt, caps)


def run_slice(wl: Workload):
    """Track every frame of the workload, mono, at the default tracking
    settings, as Tracker.process_image calls the program.  Returns
    (trajectory (F, 4, 4), scalars (F, 9) int32), still on the device:
    nothing here waits for it."""
    dev = wl.frames.device
    cfg = SlamConfig()
    tc = cfg.tracking
    T = torch.eye(4, device=dev)
    vel = torch.eye(4, device=dev)
    last_kp, last_angle, last_oct = wl.kf0_pt, wl.kf0.angle, wl.kf0.octave
    th_depth = cfg.depth_threshold * wl.cam.bf / max(wl.cam.fx, 1e-6)
    m = wl.map
    traj, scalars = [], []
    for gray in wl.frames:
        step, frame = track_image_and_decide(
            m, gray, None, T, vel, last_kp, last_angle, last_oct, 0, wl.cam,
            tc.search_radius_motion, tc.search_radius_localmap, tc.min_track_motion,
            th_depth, wl.extractor,
            n_local=wl.caps.local_ba_points, n_local_kfs=tc.max_local_keyframes,
        )
        T, vel, last_kp, m = step.T, step.velocity, step.kp_pt, step.m
        last_angle, last_oct = frame.angle, frame.octave
        traj.append(T)
        scalars.append(step.scalars)
    return torch.stack(traj), torch.stack(scalars)
