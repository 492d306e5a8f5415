"""The benchmark's frozen traffic generator: the synthetic ICL-style room,
its camera, the walk's poses, the batch renderer and the offline plane and
cuboid rows.

A frozen copy of the port's ``tpuslam_torch/io/synth.py`` (scene, camera,
the body of ``trajectory``, ``BatchRenderer``, ``render_uint8``,
``plane_rows_for_frame``, ``cuboid_lines_for_frame``), held equal to it by
``slambench/tests/test_slambench_frozen.py``.  It imports nothing of the
program, so a change to the program cannot change the frames, the ground
truth or the detections the benchmark hands it.  :func:`walk_poses`
generalises ``trajectory`` to a clip that starts anywhere on the golden
circle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

# (classname, cx, cy, yaw, sx, sy, sz): half-extents; cz = sz (on the floor)
DEFAULT_CUBOIDS: List[Tuple[str, float, float, float, float, float, float]] = [
    ("chair", 2.2, 0.4, 0.5, 0.25, 0.25, 0.45),
    ("table", 0.5, 2.3, -0.3, 0.45, 0.30, 0.35),
    ("sofa", -2.2, 1.2, 1.1, 0.40, 0.28, 0.30),
    ("shelf", -1.8, -1.9, 0.2, 0.30, 0.22, 0.60),
    ("monitor", 0.8, -2.3, -0.8, 0.22, 0.18, 0.28),
    ("bed", 2.1, -1.5, 0.9, 0.35, 0.45, 0.25),
]


@dataclass
class SceneSpec:
    room_half_x: float = 3.0
    room_half_y: float = 3.0
    room_height: float = 3.0
    cuboids: List[Tuple[str, float, float, float, float, float, float]] = field(
        default_factory=lambda: list(DEFAULT_CUBOIDS))
    cell: float = 0.22  # coarse texture cell (m)
    cell_fine: float = 0.055  # fine texture cell (m)
    seed: int = 7


@dataclass
class CameraSpec:
    width: int = 640
    height: int = 480
    fx: float = 520.0
    fy: float = 520.0
    cx: float = 319.5
    cy: float = 239.5
    baseline: float = 0.075


# lattice offset keeping scene surfaces off exact texture-cell boundaries
_LATTICE_OFF = 0.1234


def room_planes(spec: SceneSpec):
    """(6, 4) world plane coefficients [n, d] with n.X + d = 0, inward n."""
    hx, hy, hz = spec.room_half_x, spec.room_half_y, spec.room_height
    return np.array(
        [
            [0.0, 0.0, 1.0, 0.0],  # floor z=0
            [0.0, 0.0, -1.0, hz],  # ceiling z=hz
            [-1.0, 0.0, 0.0, hx],  # wall x=+hx
            [1.0, 0.0, 0.0, hx],  # wall x=-hx
            [0.0, -1.0, 0.0, hy],  # wall y=+hy
            [0.0, 1.0, 0.0, hy],  # wall y=-hy
        ],
        np.float32,
    )


def poses_at(th, radius: float, height: float, pitch_down_deg: float, bob: float):
    """(F, 4, 4) float32 camera-to-world poses at angles ``th`` (radians) on
    a circle around the room centre, looking along the tangent, pitched
    down (the body of the source's ``trajectory``)."""
    th = np.asarray(th, np.float64)
    pos = np.stack([radius * np.cos(th), radius * np.sin(th), height + bob * np.sin(3.0 * th)], axis=-1)
    fwd = np.stack([-np.sin(th), np.cos(th), np.zeros_like(th)], axis=-1)
    down = np.array([0.0, 0.0, -1.0], np.float32)
    a = np.deg2rad(pitch_down_deg)
    out = []
    for i in range(len(th)):
        z = np.cos(a) * fwd[i] + np.sin(a) * down
        z /= np.linalg.norm(z)
        x = np.cross(down, fwd[i])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, pos[i]
        out.append(T)
    return np.stack(out)


def walk_poses(n_frames: int, start_deg: float, loop_deg: float, loop_frames: int, radius: float, height: float,
               pitch_down_deg: float, bob: float):
    """A clip of ``n_frames`` poses of the golden loop's circle, starting at
    ``start_deg`` and stepping as the loop of ``loop_frames`` frames over
    ``loop_deg`` does; at ``start_deg`` 0 it is the loop's first frames."""
    step = np.deg2rad(loop_deg) / (loop_frames - 1)
    th = np.deg2rad(start_deg) + np.arange(n_frames) * step
    return poses_at(th, radius, height, pitch_down_deg, bob)


def box_frames(spec: SceneSpec):
    """(centres (M, 3), half-extents (M, 3), yaws (M,)) of the boxes."""
    centers, halfs, yaws = [], [], []
    for (_, cx, cy, yaw, sx, sy, sz) in spec.cuboids:
        centers.append([cx, cy, sz])
        halfs.append([sx, sy, sz])
        yaws.append(yaw)
    return np.array(centers, np.float32), np.array(halfs, np.float32), np.array(yaws, np.float32)


def _hash_cells(ix, iy, iz, salt, denom):
    """Integer hash of 3D grid cells to [0, 1), in int64."""
    h = (ix * 374761393 + iy * 668265263 + iz * 1274126177 + salt * 97531) & 0x7FFFFFFF
    h = ((h ^ (h >> 13)) * 1103515245) & 0x7FFFFFFF
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) / denom


def _dot3(a, b):
    """sum_k a[..., k] * b[..., k], left to right, elementwise."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


class BatchRenderer(torch.nn.Module):
    """Ray caster over a batch of camera-to-world poses:
    (B, 4, 4) -> (gray (B, H, W) float32 in [20, 235], depth (B, H, W),
    prim_id (B, H, W) int64: 0-5 room planes, 6+i cuboid i).  Divisors are
    (1,) tensors: on a card a division by a Python number becomes a product
    with its reciprocal, which rounds otherwise."""

    def __init__(self, cam: CameraSpec, spec: SceneSpec, device="cuda:0"):
        super().__init__()
        self.cam, self.spec = cam, spec
        H, W = cam.height, cam.width
        u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        d_cam = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1)
        centers, halfs, yaws = box_frames(spec)
        rz = []
        for yw in yaws:
            c, s = np.cos(yw), np.sin(yw)
            rz.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32))

        def buf(name, a):
            self.register_buffer(name, torch.as_tensor(np.asarray(a), device=device))

        buf("d_cam", d_cam.reshape(-1, 3))
        buf("planes", room_planes(spec))
        buf("centers", centers)
        buf("halfs", halfs)
        buf("rz", np.stack(rz))
        buf("cell", np.array([spec.cell], np.float32))
        buf("cell_fine", np.array([spec.cell_fine], np.float32))
        buf("hash_denom", np.array([65535.0], np.float32))

    def forward(self, poses_wc, stats: bool = False):
        """(gray, depth, prim_id); with ``stats`` also (counts (B, 6 + M)
        int64 pixels per primitive, face_sums (B, 6, 3) float64 sums of the
        camera-frame points over each room face)."""
        spec = self.spec
        B = poses_wc.shape[0]
        H, W = self.cam.height, self.cam.width
        R = poses_wc[:, None, :3, :3]
        t = poses_wc[:, None, :3, 3]
        d = self.d_cam[None]
        d_w = torch.stack([_dot3(d, R[:, :, j, :]) for j in range(3)], dim=-1)
        n_ray = d_w.shape[1]
        best_t = torch.full((B, n_ray), float("inf"), device=d_w.device)
        best_id = torch.full((B, n_ray), -1, dtype=torch.int64, device=d_w.device)
        hx, hy, hz = spec.room_half_x, spec.room_half_y, spec.room_height
        for i in range(self.planes.shape[0]):
            n, dd = self.planes[i, :3], self.planes[i, 3]
            denom = _dot3(d_w, n)
            ti = -(dd + _dot3(t, n)) / denom
            hit = (denom < -1e-9) & (ti > 1e-3)
            p = t + ti[..., None] * d_w
            hit &= (torch.abs(p[..., 0]) <= hx + 1e-3) & (torch.abs(p[..., 1]) <= hy + 1e-3)
            hit &= (p[..., 2] >= -1e-3) & (p[..., 2] <= hz + 1e-3)
            closer = hit & (ti < best_t)
            best_t = torch.where(closer, ti, best_t)
            best_id = torch.where(closer, i, best_id)
        for i in range(self.rz.shape[0]):
            c, s, Rz = self.centers[i], self.halfs[i], self.rz[i]
            o = t - c
            o_b = torch.stack([_dot3(o, Rz[:, j]) for j in range(3)], dim=-1)
            d_b = torch.stack([_dot3(d_w, Rz[:, j]) for j in range(3)], dim=-1)
            inv = 1.0 / d_b
            t1 = (-s - o_b) * inv
            t2 = (s - o_b) * inv
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            tmin = torch.where(torch.isnan(lo), -float("inf"), lo).max(dim=-1).values
            tmax = torch.where(torch.isnan(hi), float("inf"), hi).min(dim=-1).values
            hit = (tmax > tmin) & (tmin > 1e-3)
            closer = hit & (tmin < best_t)
            best_t = torch.where(closer, tmin, best_t)
            best_id = torch.where(closer, 6 + i, best_id)
        best_t = torch.where(best_id < 0, 10.0, best_t)
        p_w = t + best_t[..., None] * d_w
        c1 = torch.floor((p_w + _LATTICE_OFF) / self.cell).to(torch.int64)
        c2 = torch.floor((p_w + _LATTICE_OFF) / self.cell_fine).to(torch.int64)
        den = self.hash_denom
        gray = 0.62 * _hash_cells(c1[..., 0], c1[..., 1], c1[..., 2], spec.seed + best_id, den)
        gray += 0.38 * _hash_cells(c2[..., 0], c2[..., 1], c2[..., 2], spec.seed + 101 + best_id, den)
        zero = torch.zeros_like(best_id)
        albedo = 0.75 + 0.25 * _hash_cells(best_id, zero, zero, spec.seed + 999 + zero, den)
        gray = 20.0 + 215.0 * torch.clamp(gray * albedo, 0.0, 1.0)
        out = gray.reshape(B, H, W), best_t.reshape(B, H, W), best_id.reshape(B, H, W)
        if not stats:
            return out
        n_prim = 6 + self.rz.shape[0]
        bins = torch.where(best_id >= 0, best_id, n_prim) + (n_prim + 1) * torch.arange(B, device=d_w.device)[:, None]
        counts = torch.zeros(B * (n_prim + 1), dtype=torch.int64, device=d_w.device).index_add_(
            0, bins.reshape(-1), torch.ones(bins.numel(), dtype=torch.int64, device=d_w.device))
        p_cam = (best_t[..., None] * self.d_cam[None]).to(torch.float64)
        face = torch.where(best_id < 6, best_id, 6) + 7 * torch.arange(B, device=d_w.device)[:, None]
        sums = torch.zeros((B * 7, 3), dtype=torch.float64, device=d_w.device).index_add_(
            0, face.reshape(-1), p_cam.reshape(-1, 3))
        return (*out, counts.reshape(B, n_prim + 1)[:, :n_prim], sums.reshape(B, 7, 3)[:, :6])


def render_uint8(renderer: BatchRenderer, poses_wc, chunk: int = 8, stats: bool = False):
    """(F, H, W) uint8 frames of ``poses_wc`` (F, 4, 4) numpy, truncated as
    the dataset's PNGs hold them; with ``stats`` also the renderer's counts
    and face sums as host numpy."""
    dev = renderer.d_cam.device
    out, counts, sums = [], [], []
    for i in range(0, len(poses_wc), chunk):
        r = renderer(torch.as_tensor(np.asarray(poses_wc[i:i + chunk], np.float32), device=dev), stats=stats)
        out.append(r[0].to(torch.uint8))
        if stats:
            counts.append(r[3])
            sums.append(r[4])
    if stats:
        return torch.cat(out), torch.cat(counts).cpu().numpy(), torch.cat(sums).cpu().numpy()
    return torch.cat(out)


def plane_rows_for_frame(T_wc, counts, face_sums, spec: SceneSpec, min_pix: int = 1500):
    """Offline plane rows [id n_cam d_cam centroid_cam num] of the room faces
    with at least ``min_pix`` pixels in this frame."""
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    R_cw = R.T
    t_cw = -R_cw @ t
    rows = []
    for i, pl in enumerate(room_planes(spec)):
        num = int(counts[i])
        if num < min_pix:
            continue
        n_c = R_cw @ pl[:3]
        d_c = float(pl[3] - t_cw @ n_c)
        if d_c < 0:
            n_c, d_c = -n_c, -d_c
        cen = face_sums[i] / num
        rows.append([float(len(rows)), *n_c.tolist(), d_c, *cen.tolist(), float(num)])
    return rows


def cuboid_lines_for_frame(T_wc, counts, spec: SceneSpec, min_pix: int = 400):
    """Global-frame cuboid rows of the objects with at least ``min_pix``
    pixels whose centre is at least 1 m from the camera."""
    lines = []
    for i, (name, cx, cy, yaw, sx, sy, sz) in enumerate(spec.cuboids):
        dist = np.linalg.norm(np.array([cx, cy, sz]) - T_wc[:3, 3])
        if counts[6 + i] < min_pix or dist < 1.0:
            continue
        lines.append(f"{name} {cx:.6f} {cy:.6f} {sz:.6f} 0 0 {yaw:.6f} {sx:.6f} {sy:.6f} {sz:.6f}")
    return lines


def detection_rows(T_wc, counts, face_sums, spec: SceneSpec):
    """(plane rows, cuboid lines) of one frame as the dataset's files hold
    them and ``mono_icl`` reads them back: plane rows through ``%.9f``,
    cuboid rows as written (``%.6f``)."""
    rows = [[float(f"{x:.9f}") for x in r] for r in plane_rows_for_frame(T_wc, counts, face_sums, spec)]
    return rows, cuboid_lines_for_frame(T_wc, counts, spec)
