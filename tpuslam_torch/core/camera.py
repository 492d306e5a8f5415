"""Pinhole camera with radial-tangential distortion (port of
``tpuslam/core/camera.py``).

The intrinsics are Python numbers, so reading them never waits for the
device; only the distortion vector is a tensor.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Camera:
    """``dist`` is OpenCV-ordered ``[k1, k2, p1, p2, k3]``; ``bf`` is the
    stereo baseline times fx, 0 for mono."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: torch.Tensor  # (5,) float32
    width: int
    height: int
    bf: float = 0.0

    @staticmethod
    def make(fx, fy, cx, cy, device, dist=None, width=640, height=480, bf=0.0):
        d = np.zeros(5, np.float32) if dist is None else np.asarray(dist, np.float32)
        return Camera(
            fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
            dist=torch.tensor(d, device=device),
            width=int(width), height=int(height), bf=_f32(bf),
        )


def _f32(x) -> float:
    """The float32 value the reference's ``jnp.float32`` intrinsics hold."""
    return float(np.float32(x))


def camera_from_numpy(fields: dict, device) -> Camera:
    """Build from ``tpuslam.core.camera.Camera._asdict()`` with numpy values."""
    return Camera.make(
        fields["fx"], fields["fy"], fields["cx"], fields["cy"], device,
        dist=fields["dist"], width=fields["width"], height=fields["height"],
        bf=fields["bf"],
    )


def camera_to_numpy(cam: Camera) -> dict:
    out = {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}
    for k in ("fx", "fy", "cx", "cy", "bf"):
        out[k] = np.float32(out[k])
    out["dist"] = cam.dist.cpu().numpy()
    return out


def project(cam: Camera, p_cam):
    """Camera-frame points (..., 3) -> pixels (..., 2), no distortion."""
    z = p_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * p_cam[..., 0] * inv_z + cam.cx
    v = cam.fy * p_cam[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def backproject(cam: Camera, uv, depth):
    """Pixels (..., 2) + depth (...) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort_normalized(cam: Camera, xy):
    """Radial-tangential distortion of normalized coordinates (..., 2)."""
    k1, k2, p1, p2, k3 = cam.dist.unbind(0)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Camera, uv, iters: int = 8):
    """Fixed-point undistortion, the scheme of ``cv::undistortPoints``."""
    xy_d = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )
    k1, k2, p1, p2, k3 = cam.dist.unbind(0)
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack(
            [(xy_d[..., 0] - dx) / radial, (xy_d[..., 1] - dy) / radial], dim=-1
        )
    return torch.stack([xy[..., 0] * cam.fx + cam.cx, xy[..., 1] * cam.fy + cam.cy], dim=-1)


def in_image(cam: Camera, uv, margin: float = 0.0):
    """(...) bool: pixels (..., 2) at least ``margin`` inside the image."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < cam.height - margin)
    )


def camera_matrix(cam: Camera) -> torch.Tensor:
    """(3, 3) intrinsics on ``cam.dist``'s device, filled in place from the
    Python numbers, so no host buffer is copied (no wait on the device)."""
    K = torch.zeros((3, 3), dtype=torch.float32, device=cam.dist.device)
    for (i, j), v in zip(((0, 0), (0, 2), (1, 1), (1, 2), (2, 2)), (cam.fx, cam.cx, cam.fy, cam.cy, 1.0)):
        K[i, j].fill_(v)
    return K
