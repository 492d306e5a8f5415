"""Synthetic ICL-style golden sequence, rendered on the device (port of
``tpuslam/io/synth.py``: the scene, the camera, the trajectory and the batch
renderer).

A textured box room with yaw-rotated cuboids on the floor, seen from a camera
that circles the room looking along the tangent.  The texture is a
view-invariant hash of the world hit point, so ORB re-detects the same
corners across frames.

The renderer repeats the numpy oracle ``tpuslam/io/synth.py:render_frame``
operation by operation in float32: primitives are tested in the oracle's
order with its strict ``<`` (the earlier primitive keeps a tie), the 3-term
products are written out elementwise, and the texture hash, which the oracle
computes in int64, is int64 here too with the same masks.  TF32 stays off.
:func:`write_sequence` writes the golden dataset folder in the reference's
layout, its PNGs through :mod:`.png` (the card host has no ``cv2``).  The
offline detections come from the renderer: it counts each frame's pixels per
primitive and sums the camera-frame points of each room face in the pass
that makes the frame, and :func:`plane_rows_for_frame` /
:func:`cuboid_lines_for_frame` turn those small arrays into the rows
``write_sequence`` writes (:func:`frame_detections` takes them through the
same text rounding and parsing in memory).  For the depth sensors, :func:`render_uint8`
also returns each frame's depth as ``write_sequence`` stores it in its
uint16 PNGs and ``IclDataset`` reads it back (:func:`quantize_depth`), and
:func:`right_poses` places a stereo rig's right camera.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from ..semantic.detect import cuboids_from_lines, parse_obj_lines, planes_from_rows

# (classname, cx, cy, yaw, sx, sy, sz): half-extents; cz = sz (on the floor)
_DEFAULT_CUBOIDS: List[Tuple[str, float, float, float, float, float, float]] = [
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
        default_factory=lambda: list(_DEFAULT_CUBOIDS)
    )
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
    baseline: float = 0.075  # Camera.bf = fx * baseline in the golden ICL.yaml


# write_sequence's depth PNG scale (IclDataset.depth_factor)
DEPTH_FACTOR = 5000.0

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


def trajectory(n_frames: int, spec: SceneSpec, radius: float = 1.6,
               total_angle_deg: float = 400.0, height: float = 1.5,
               pitch_down_deg: float = 14.0, bob: float = 0.05):
    """(F, 4, 4) float32 camera-to-world poses: a loop around the room
    centre, looking along the tangent, pitched down."""
    th = np.linspace(0.0, np.deg2rad(total_angle_deg), n_frames)
    pos = np.stack(
        [radius * np.cos(th), radius * np.sin(th), height + bob * np.sin(3.0 * th)], axis=-1)
    fwd = np.stack([-np.sin(th), np.cos(th), np.zeros_like(th)], axis=-1)
    down = np.array([0.0, 0.0, -1.0], np.float32)
    a = np.deg2rad(pitch_down_deg)
    out = []
    for i in range(n_frames):
        z = np.cos(a) * fwd[i] + np.sin(a) * down
        z /= np.linalg.norm(z)
        x = np.cross(down, fwd[i])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, pos[i]
        out.append(T)
    return np.stack(out)


def _box_frames(spec: SceneSpec):
    centers, halfs, yaws = [], [], []
    for (_, cx, cy, yaw, sx, sy, sz) in spec.cuboids:
        centers.append([cx, cy, sz])
        halfs.append([sx, sy, sz])
        yaws.append(yaw)
    return (np.array(centers, np.float32), np.array(halfs, np.float32),
            np.array(yaws, np.float32))


def _hash_cells(ix, iy, iz, salt, denom):
    """Integer hash of 3D grid cells to [0, 1), in int64 as the oracle;
    ``denom`` is 65535 as a tensor (see ``BatchRenderer``)."""
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
    prim_id (B, H, W) int64: 0-5 room planes, 6+i cuboid i).

    Divisors are (1,) tensors, not Python numbers: on the card PyTorch turns
    a division by a host scalar into a product with its reciprocal, which
    rounds differently from the oracle's division."""

    def __init__(self, cam: CameraSpec, spec: SceneSpec, device="cuda:0"):
        super().__init__()
        self.cam, self.spec = cam, spec
        H, W = cam.height, cam.width
        u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        d_cam = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1)
        centers, halfs, yaws = _box_frames(spec)
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
        camera-frame points ``depth * d_cam`` over each room face)."""
        spec = self.spec
        B = poses_wc.shape[0]
        H, W = self.cam.height, self.cam.width
        R = poses_wc[:, None, :3, :3]  # (B, 1, 3, 3)
        t = poses_wc[:, None, :3, 3]  # (B, 1, 3)
        d = self.d_cam[None]  # (1, N, 3)
        d_w = torch.stack([_dot3(d, R[:, :, j, :]) for j in range(3)], dim=-1)  # d_cam @ R.T
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
            o_b = torch.stack([_dot3(o, Rz[:, j]) for j in range(3)], dim=-1)  # (t - c) @ Rz
            d_b = torch.stack([_dot3(d_w, Rz[:, j]) for j in range(3)], dim=-1)
            inv = 1.0 / d_b
            t1 = (-s - o_b) * inv
            t2 = (s - o_b) * inv
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            tmin = torch.where(torch.isnan(lo), -float("inf"), lo).max(dim=-1).values  # nanmax
            tmax = torch.where(torch.isnan(hi), float("inf"), hi).min(dim=-1).values  # nanmin
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
        p_cam = (best_t[..., None] * self.d_cam[None]).to(torch.float64)  # as write_sequence's depth * d_cam
        face = torch.where(best_id < 6, best_id, 6) + 7 * torch.arange(B, device=d_w.device)[:, None]
        sums = torch.zeros((B * 7, 3), dtype=torch.float64, device=d_w.device).index_add_(
            0, face.reshape(-1), p_cam.reshape(-1, 3))
        return (*out, counts.reshape(B, n_prim + 1)[:, :n_prim], sums.reshape(B, 7, 3)[:, :6])


def quantize_depth(depth):
    """Depth in metres as ``write_sequence`` stores it
    (``uint16(clip(depth * 5000, 0, 65535))``, synth.py:413) and ``IclDataset``
    reads it back (``/ 5000`` in float32, datasets.py:45-52).  The divisor is
    a tensor: on a card a division by a Python number is a product with its
    reciprocal, which rounds otherwise."""
    return depth16(depth).to(torch.float32) / torch.full((1,), DEPTH_FACTOR, device=depth.device)


def depth16(depth):
    """The depth PNG's samples, ``uint16(clip(depth * 5000, 0, 65535))``,
    as an int32 tensor."""
    return torch.clamp(depth * DEPTH_FACTOR, 0, 65535).to(torch.int32)


def right_poses(poses_wc, baseline: float):
    """(F, 4, 4) float32 camera-to-world poses of a stereo rig's right
    camera: each left camera moved by ``baseline`` along its own +x axis, so
    that a point at depth Z seen at uL is seen at uR = uL - fx * baseline / Z."""
    out = np.array(poses_wc, np.float32)
    out[:, :3, 3] += np.float32(baseline) * out[:, :3, 0]
    return out


def make_batch_renderer(cam: CameraSpec, spec: SceneSpec, device="cuda:0") -> BatchRenderer:
    return BatchRenderer(cam, spec, device)


def render_uint8(renderer: BatchRenderer, poses_wc, chunk: int = 8, stats: bool = False, depth: bool = False):
    """(F, H, W) uint8 frames of ``poses_wc`` (F, 4, 4) numpy, truncated as
    ``write_sequence`` stores its PNGs; rendered ``chunk`` poses at a time.
    With ``stats`` also the renderer's counts and face sums, as host numpy;
    with ``depth`` also the (F, H, W) float32 depth of :func:`quantize_depth`
    on the renderer's device."""
    dev = renderer.d_cam.device
    out, counts, sums, depths = [], [], [], []
    for i in range(0, len(poses_wc), chunk):
        r = renderer(torch.as_tensor(np.asarray(poses_wc[i:i + chunk], np.float32), device=dev), stats=stats)
        out.append(r[0].to(torch.uint8))
        if depth:
            depths.append(quantize_depth(r[1]))
        if stats:
            counts.append(r[3])
            sums.append(r[4])
    res = (torch.cat(out),)
    if stats:
        res += (torch.cat(counts).cpu().numpy(), torch.cat(sums).cpu().numpy())
    if depth:
        res += (torch.cat(depths),)
    return res if len(res) > 1 else res[0]


# ---------------------------------------------------------------------------
# Offline detections (write_sequence's plane_seg / pred_3d_obj_matched_txt)
# ---------------------------------------------------------------------------


def plane_rows_for_frame(T_wc, counts, face_sums, spec: SceneSpec, min_pix: int = 1500):
    """Offline plane rows [id n_cam d_cam centroid_cam num] of the room faces
    with at least ``min_pix`` pixels in this frame (the reference's
    ``_plane_rows_for_frame``, from the renderer's counts and face sums).
    The normal and distance are the reference's float32 numpy expressions on
    the frame's float32 pose; the centroid is the float64 sum over the
    face's pixels divided by their count (the reference's is a float32 numpy
    mean; nothing downstream reads it)."""
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
    pixels whose centre is at least 1 m from the camera (the reference's
    ``_cuboid_lines_for_frame``)."""
    lines = []
    for i, (name, cx, cy, yaw, sx, sy, sz) in enumerate(spec.cuboids):
        dist = np.linalg.norm(np.array([cx, cy, sz]) - T_wc[:3, 3])
        if counts[6 + i] < min_pix or dist < 1.0:
            continue
        lines.append(f"{name} {cx:.6f} {cy:.6f} {sz:.6f} 0 0 {yaw:.6f} {sx:.6f} {sy:.6f} {sz:.6f}")
    return lines


def camera_matrix_np(cam: CameraSpec):
    return np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], np.float32)


def frame_detections(T_wc, counts, face_sums, spec: SceneSpec, cam: CameraSpec, max_planes: int,
                     max_cuboids: int):
    """(PlaneDetections, CuboidDetections) of one frame, as ``mono_icl``
    reads them from ``write_sequence``'s files: plane rows formatted with
    %.9f and cuboid rows with %.6f, parsed back, then cast to float32, and
    the cuboids taken into the camera frame with ``T_wc``, the frame's
    camera-to-world pose."""
    rows = plane_rows_for_frame(T_wc, counts, face_sums, spec)
    pdet = planes_from_rows([[float(f"{x:.9f}") for x in r] for r in rows], max_planes)
    names, vals = parse_obj_lines(cuboid_lines_for_frame(T_wc, counts, spec))
    return pdet, cuboids_from_lines(names, vals, T_wc, camera_matrix_np(cam), max_cuboids)


# ---------------------------------------------------------------------------
# The dataset folder on disk (the reference's write_sequence)
# ---------------------------------------------------------------------------


def R_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(x, y, z, w) of a rotation matrix, Shepperd-style (the reference's
    ``_R_to_quat_np``, synth.py:308-319, for the odom.txt rows)."""
    tr = np.trace(R)
    qw = 0.5 * np.sqrt(max(1.0 + tr, 1e-12))
    qx = 0.5 * np.sqrt(max(1.0 + R[0, 0] - R[1, 1] - R[2, 2], 1e-12))
    qy = 0.5 * np.sqrt(max(1.0 - R[0, 0] + R[1, 1] - R[2, 2], 1e-12))
    qz = 0.5 * np.sqrt(max(1.0 - R[0, 0] - R[1, 1] + R[2, 2], 1e-12))
    qx *= np.sign(R[2, 1] - R[1, 2]) or 1.0
    qy *= np.sign(R[0, 2] - R[2, 0]) or 1.0
    qz *= np.sign(R[1, 0] - R[0, 1]) or 1.0
    q = np.array([qx, qy, qz, qw])
    return q / np.linalg.norm(q)


def write_sequence(folder: str, n_frames: int = 500, cam: CameraSpec | None = None, spec: SceneSpec | None = None,
                   total_angle_deg: float = 400.0, min_plane_pix: int = 1500, min_cuboid_pix: int = 400,
                   fps: float = 30.0, device="cuda:0", n_write: int = 0) -> str:
    """Render the golden sequence on ``device`` and write the reference's
    dataset folder (synth.py:366-450): ``rgb/%04d.png`` (uint8 gray),
    ``depth/%04d.png`` (uint16, metres x 5000), ``plane_seg/`` and
    ``pred_3d_obj_matched_txt/`` detection rows, ``rgb.txt``, ``depth.txt``,
    ``odom.txt`` (camera-to-world ``[t x y z qx qy qz qw]``), ``ICL.yaml`` and
    the ``SYNTH_<n>_<W>x<H>_<seed>_<angle>.done`` marker; a folder with the
    marker is kept as it is.  ``n_write`` > 0 writes only the first
    ``n_write`` frames of the ``n_frames`` trajectory (the marker then names
    ``<n_write>of<n>``).  Returns ``folder``.  The plane rows' centroids
    are the renderer's float64 face sums over the pixel count, where the
    reference takes a float32 mean that adds the points one by one (apart by
    up to pixels x 2^-24 x 6 m; nothing reads them)."""
    from . import png

    cam = cam or CameraSpec()
    spec = spec or SceneSpec()
    count = f"{n_write}of{n_frames}" if n_write > 0 else f"{n_frames}"
    marker = os.path.join(folder, f"SYNTH_{count}_{cam.width}x{cam.height}_{spec.seed}_{int(total_angle_deg)}.done")
    if os.path.exists(marker):
        return folder
    for sub in ("rgb", "depth", "plane_seg", "pred_3d_obj_matched_txt"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    poses = trajectory(n_frames, spec, total_angle_deg=total_angle_deg)
    if n_write > 0:
        poses = poses[:n_write]
    renderer = make_batch_renderer(cam, spec, device)
    dev = renderer.d_cam.device
    rgb_lines, depth_lines, odom_lines = [], [], []
    for f0 in range(0, len(poses), 8):
        gray, depth, _, counts, sums = renderer(torch.as_tensor(poses[f0:f0 + 8], device=dev), stats=True)
        gray = gray.to(torch.uint8).cpu().numpy()
        d16 = depth16(depth).cpu().numpy().astype(np.uint16)
        counts, sums = counts.cpu().numpy(), sums.cpu().numpy()
        for j in range(gray.shape[0]):
            f = f0 + j
            stamp = f / fps
            png.imwrite(os.path.join(folder, "rgb", f"{f:04d}.png"), gray[j])
            png.imwrite(os.path.join(folder, "depth", f"{f:04d}.png"), d16[j])
            rgb_lines.append(f"{stamp:.6f} rgb/{f:04d}.png")
            depth_lines.append(f"{stamp:.6f} depth/{f:04d}.png")
            q = R_to_quat_np(poses[f][:3, :3])
            tx, ty, tz = poses[f][:3, 3]
            odom_lines.append(f"{stamp:.6f} {tx:.9f} {ty:.9f} {tz:.9f} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")
            rows = plane_rows_for_frame(poses[f], counts[j], sums[j], spec, min_plane_pix)
            with open(os.path.join(folder, "plane_seg", f"{f}_offline_plane_multiplane.txt"), "w") as fh:
                for r in rows:
                    fh.write(" ".join(f"{x:.9f}" for x in r) + "\n")
            lines = cuboid_lines_for_frame(poses[f], counts[j], spec, min_cuboid_pix)
            with open(os.path.join(folder, "pred_3d_obj_matched_txt", f"{f:04d}_3d_cuboids.txt"), "w") as fh:
                fh.write("\n".join(lines) + ("\n" if lines else ""))
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines), ("odom.txt", odom_lines)):
        with open(os.path.join(folder, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    with open(os.path.join(folder, "ICL.yaml"), "w") as fh:
        fh.write(
            "%YAML:1.0\n"
            f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\n"
            f"Camera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
            f"Camera.width: {cam.width}\nCamera.height: {cam.height}\n"
            f"Camera.bf: {cam.fx * cam.baseline}\nCamera.fps: {fps}\n"
        )
    with open(marker, "w") as fh:
        fh.write("ok\n")
    return folder
