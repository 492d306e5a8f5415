"""The tracking slice's workload and frame loop (counterpart of
``bench.py:build_workload``, bench.py:114-134), and the local-BA window of
``bench.py:build_ba_window`` (bench.py:212-323; :func:`ba_window_arrays`).

A textured wall at ``Z_WALL`` seen by a camera that translates sideways:
each frame is a crop of one wide smoothed-noise texture, shifted
``PX_STEP`` pixels from the last, so descriptors really re-detect across
frames.  Keyframe 0 holds frame 0's features, with each valid keypoint
backprojected to a map point at the wall depth.  :func:`run_slice` then runs
``track_image_and_decide`` on every frame, chaining each frame's device
outputs into the next as ``Tracker.process_image`` does.

Everything is made from ``seed`` with numpy, so the JAX package can be run on
the same frames and the same BA window.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .core import geometry as geo
from .core.camera import Camera
from .core.config import Capacities, SlamConfig
from .frontend.tracking import Frame, frame_from_features, track_image_and_decide
from .graph import lm
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


# bench.py's local-BA window (bench.py:219-220): 16 optimized + 16 fixed
# keyframes of 1024 lanes, 4096 points, 8 planes, 8 cuboids; 30 LM iterations
BA_K, BA_N, BA_P, BA_Q, BA_C = 32, 1024, 4096, 8, 8
BA_ITERS = 30
BA_CX, BA_CY = 320.0, 240.0
PT_PER_CUB = 64


def ba_window_arrays(seed: int = 0, K: int = BA_K, N: int = BA_N, P: int = BA_P, Q: int = BA_Q, C: int = BA_C):
    """bench.py's heterogeneous LocalBACameraPlaneCuboids window as numpy
    arrays, keyed by the fields of the reference's ``BAState`` and ``BAData``
    (the factor bundles as dicts of their fields): (state, data).  Either
    package builds its solver's inputs from them (:func:`build_ba_window`).

    The layout of bench.py:219-323: ``K * N`` kf-major mono lanes, each
    keyframe observing ``N`` distinct random points with 0.5 px of noise
    and octaves 0-7; ``K * Q`` plane lanes (kinds: direct, then vertical
    for plane ``Q - 2`` and parallel for ``Q - 1``, which is bench.py's
    ``q < 6``, ``== 6``, else for Q = 8) valid at 0.6; ``K * C`` bbox and
    corner lanes valid at 0.5, weight 0.7; one point-cuboid factor of 64
    random points per cuboid; one cuboid-plane factor per cuboid (plane
    ``c % min(6, Q)``, a random face).  Keyframe 0 and the second half are
    fixed; every plane and cuboid is active.  The numpy draws are
    bench.py's, in its order, so the data equal its numpy part for the same
    seed; the geometry (projections, plane transforms) is the port's, in
    float32.  Departure: bench.py perturbs the free poses (0.01 per tangent
    dimension) and the points (0.03) with its framework's keyed random
    draws; here they are numpy normal draws of the same shapes and scales,
    after the rest."""
    rng = np.random.RandomState(seed)
    t = torch.as_tensor
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 10, P)], axis=-1).astype(np.float32)
    i = torch.arange(K, dtype=torch.float32)[:, None]
    w = i * torch.tensor([0.01, 0.02, 0.005])
    tr = i * torch.tensor([0.15, 0.03, 0.05])
    poses = geo.se3_inv(geo.se3_from_Rt(geo.so3_exp(w), tr))  # (K, 4, 4) world -> camera

    kf_idx = np.repeat(np.arange(K, dtype=np.int32), N)
    pt_idx = np.stack([rng.choice(P, N, replace=False) for _ in range(K)]).reshape(-1).astype(np.int32)
    pc = geo.se3_apply(poses[t(kf_idx).long()], t(pts)[t(pt_idx).long()])
    uv = torch.stack([FX * pc[:, 0] / pc[:, 2] + BA_CX, FY * pc[:, 1] / pc[:, 2] + BA_CY], dim=-1)
    uv = uv + t(rng.normal(0, 0.5, (K * N, 2)).astype(np.float32))
    octave = rng.randint(0, 8, K * N)
    mono = {"kf": kf_idx, "pt": pt_idx, "uv": uv.numpy(),
            "inv_sigma2": (1.0 / (1.2 ** (2.0 * octave))).astype(np.float32), "valid": (pc[:, 2] > 0.5).numpy()}

    n_raw = rng.normal(size=(Q, 3)).astype(np.float32)
    n_raw /= np.linalg.norm(n_raw, axis=-1, keepdims=True)
    planes = np.concatenate([n_raw, rng.uniform(1, 4, (Q, 1)).astype(np.float32)], -1)
    kf_q = np.repeat(np.arange(K, dtype=np.int32), Q)
    q_idx = np.tile(np.arange(Q, dtype=np.int32), K)
    plane_obs = {"kf": kf_q, "plane": q_idx,
                 "meas": geo.plane_transform(poses[t(kf_q).long()], t(planes)[t(q_idx).long()]).numpy(),
                 "kind": np.where(q_idx < Q - 2, 0, np.where(q_idx == Q - 2, 1, 2)).astype(np.int32),
                 "valid": rng.uniform(size=K * Q) < 0.6}

    c = torch.arange(C, dtype=torch.float32)
    cub_pose = geo.se3_from_Rt(geo.so3_exp(torch.stack([0 * c, 0 * c, 0.4 * c], -1)),
                               torch.stack([0.5 * c - 2.0, 0.3 * c - 1.0, torch.full_like(c, 6.0)], -1))
    cub_scale = rng.uniform(0.2, 0.6, (C, 3)).astype(np.float32)
    kf_c = np.repeat(np.arange(K, dtype=np.int32), C)
    c_idx = np.tile(np.arange(C, dtype=np.int32), K)
    Kmat = torch.tensor([[FX, 0, BA_CX], [0, FY, BA_CY], [0, 0, 1]])
    args = (cub_pose[t(c_idx).long()], t(cub_scale)[t(c_idx).long()], poses[t(kf_c).long()], Kmat)
    cub_valid = rng.uniform(size=K * C) < 0.5
    weight = np.full(K * C, 0.7, np.float32)
    cub_bbox = {"kf": kf_c, "cub": c_idx, "bbox": geo.cuboid_project_bbox(*args).numpy(), "weight": weight,
                "valid": cub_valid}
    cub_corner = {"kf": kf_c, "cub": c_idx, "corners": geo.cuboid_project_corners(*args).reshape(-1, 16).numpy(),
                  "weight": weight, "valid": cub_valid}
    pt_cub = {"cub": np.arange(C, dtype=np.int32), "pts": rng.randint(0, P, (C, PT_PER_CUB)).astype(np.int32),
              "pts_mask": np.ones((C, PT_PER_CUB), np.float32), "weight": np.ones(C, np.float32),
              "valid": np.ones(C, bool)}
    cub_plane = {"cub": np.arange(C, dtype=np.int32), "plane": (np.arange(C) % min(6, Q)).astype(np.int32),
                 "face": rng.randint(0, 6, C).astype(np.int32), "valid": np.ones(C, bool)}

    dpose = (rng.normal(size=(K, 6)) * 0.01).astype(np.float32)
    dpose[K // 2:] = 0.0
    dpose[0] = 0.0
    state = {"poses": (geo.se3_exp(t(dpose)) @ poses).numpy(),
             "points": pts + (rng.normal(size=(P, 3)) * 0.03).astype(np.float32),
             "planes": planes, "cuboid_pose": cub_pose.numpy(), "cuboid_scale": cub_scale}
    ar = np.arange(K)
    data = {"pose_fixed": (ar >= K // 2) | (ar == 0), "point_active": np.ones(P, bool),
            "plane_active": np.ones(Q, bool), "cuboid_active": np.ones(C, bool), "mono": mono,
            "plane_obs": plane_obs, "cub_bbox": cub_bbox, "cub_corner": cub_corner, "pt_cub": pt_cub,
            "cub_plane": cub_plane, "fx": FX, "fy": FY, "cx": BA_CX, "cy": BA_CY, "bf": 0.0,
            "cuboid_fix_scale": 0.0}
    return state, data


def build_ba_window(seed: int = 0, device="cuda:0", **sizes):
    """The port's (BAState, BAData) of :func:`ba_window_arrays` on
    ``device``; its mono lanes are kf-major with ``N`` lanes per keyframe,
    so ``lm.lm_iterations(..., reproj_n=N)`` assembles them blocked.  Solve
    with ``lm.BAWeights()``, as bench.py does."""
    state, data = ba_window_arrays(seed, **sizes)
    return lm.ba_state_from_numpy(state, device), lm.ba_data_from_numpy(data, device)
