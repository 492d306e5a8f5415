"""Online plane segmentation from depth (port of ``tpuslam/kernels/planes.py``,
the RGB-D DetectPlane path, Tracking.cc:2404-2513).

The reference replaces PCL's organized multi-plane segmentation with one
program: an organized point cloud at stride 3, normals from central
differences of the point map, Hough voting over (azimuth, elevation,
distance) bins, the strongest peaks as plane hypotheses, three least-squares
refits per hypothesis with tightening gates, and a dedupe.  It is plain JAX,
not a TPU kernel, and so is this: plain PyTorch on tensors.

The votes are an integer scatter-add and the bins come from float-to-int
truncation, as in the reference, so they are exact; the peaks go through
``topk_stable`` (the lower bin first among equal votes, as ``lax.top_k``).
The refits are batched over the hypotheses: one ``eigh`` per refit round.
On a card ``torch.linalg.eigh`` waits for its error check, so a frame costs
three host waits.

Bins are decided by float rounding, so the arithmetic is the reference's as
its compiled program runs it: XLA folds ``x / c * k`` with constant ``c``
and ``k`` into ``x * (k * (1 / c))``, each step rounded to float32 (the
floor's normal has an azimuth of exactly -pi/2, on a bin border, where the
folded and the written form round to different bins).  Divisions by the
focal lengths, run-time values there, stay divisions, by tensors: on a card
a division by a Python number is a product with its reciprocal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .orb import topk_stable


def _folded(k, c) -> float:
    """The float32 constant XLA makes of ``x / c * k``: k * (1 / c)."""
    f = np.float32
    return float(f(f(k) * f(f(1.0) / f(c))))


def _t(x, like):
    """A Python number as a (1,) tensor of ``like``'s dtype and device."""
    return torch.full((1,), float(x), dtype=like.dtype, device=like.device)


def organized_cloud(depth, fx: float, fy: float, cx: float, cy: float, stride: int = 3):
    """(H, W) depth -> (h, w, 3) camera-frame point map at ``stride``
    (planes.py:26-34)."""
    d = depth[::stride, ::stride]
    h, w = d.shape
    ys = torch.arange(h, device=d.device).to(d.dtype) * stride
    xs = torch.arange(w, device=d.device).to(d.dtype) * stride
    X = (xs[None, :] - cx) / _t(fx, d) * d
    Y = (ys[:, None] - cy) / _t(fy, d) * d
    return torch.stack([X, Y, d], dim=-1)


def cloud_normals(pts):
    """Normals from central differences of the organized point map (wrapped
    at the borders, as ``jnp.roll``), turned to face the camera
    (planes.py:37-47)."""
    dx = torch.roll(pts, -1, dims=1) - torch.roll(pts, 1, dims=1)
    dy = torch.roll(pts, -1, dims=0) - torch.roll(pts, 1, dims=0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    nrm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    n = n / torch.clamp(nrm, min=1e-9)
    flip = torch.sum(n * pts, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def hough_votes(depth, fx, fy, cx, cy, stride: int = 3, n_az: int = 24, n_el: int = 12, n_d: int = 64,
                d_max: float = 12.8):
    """The voting half of :func:`segment_planes` (planes.py:72-98): returns
    (points (h*w, 3), sign-canonical normals (h*w, 3), valid pixels (h*w,),
    votes (n_az * n_el * n_d,) int32)."""
    pts = organized_cloud(depth, fx, fy, cx, cy, stride)
    normals = cloud_normals(pts)
    h, w = pts.shape[:2]
    dev = pts.device
    valid_px = (pts[..., 2] > 0.1) & (torch.sum(torch.abs(normals), dim=-1) > 0.1)
    border = torch.zeros((h, w), dtype=torch.bool, device=dev)
    border[1:-1, 1:-1] = True  # border pixels have wrapped gradients
    valid_px = valid_px & border

    d_signed = -torch.sum(normals * pts, dim=-1)  # n.p + d = 0
    flip = d_signed < 0
    normals = torch.where(flip[..., None], -normals, normals)
    d_plane = torch.abs(d_signed)

    az = torch.atan2(normals[..., 1], normals[..., 0])
    el = torch.asin(torch.clamp(normals[..., 2], -1.0, 1.0))
    ia = torch.clamp(((az + math.pi) * _folded(n_az, 2 * math.pi)).to(torch.int32), 0, n_az - 1)
    ie = torch.clamp(((el + math.pi / 2) * _folded(n_el, math.pi)).to(torch.int32), 0, n_el - 1)
    idd = torch.clamp((d_plane * _folded(n_d, d_max)).to(torch.int32), 0, n_d - 1)
    n_bins = n_az * n_el * n_d
    flat = torch.where(valid_px, (ia * n_el + ie) * n_d + idd, n_bins).reshape(-1)
    votes = torch.zeros(n_bins + 1, dtype=torch.int32, device=dev).index_add_(
        0, flat.long(), torch.ones(flat.shape[0], dtype=torch.int32, device=dev))[:-1]
    return pts.reshape(-1, 3), normals.reshape(-1, 3), valid_px.reshape(-1), votes


def segment_planes(depth, fx: float, fy: float, cx: float, cy: float, stride: int = 3, max_planes: int = 8,
                   min_inliers: int = 1000, angle_cos: float = 0.99863, dist_th: float = 0.05,
                   n_az: int = 24, n_el: int = 12, n_d: int = 64, d_max: float = 12.8):
    """Up to ``max_planes`` camera-frame planes of a depth image
    (planes.py:54-168).  Returns (coef (max_planes, 4) with d >= 0,
    centroid (max_planes, 3), inlier counts (max_planes,) int32, valid
    (max_planes,) bool).  ``min_inliers`` is in full-resolution pixels and
    scaled by stride^2, as in the reference."""
    pts, nrm, valid, votes = hough_votes(depth, fx, fy, cx, cy, stride, n_az, n_el, n_d, d_max)
    dev, dt = pts.device, pts.dtype
    # peaks: a bin at least as strong as its neighbours along the distance axis
    v3 = votes.reshape(n_az * n_el, n_d)
    neigh = torch.maximum(v3, torch.maximum(torch.roll(v3, 1, dims=1), torch.roll(v3, -1, dims=1)))
    peaks = torch.where(v3 >= neigh, v3, 0).reshape(-1)
    top_votes, top_bins = topk_stable(peaks, max_planes)

    # the bin centres: the initial hypotheses
    bin_d = top_bins % n_d
    bin_ae = top_bins // n_d
    az0 = (bin_ae // n_el + 0.5) * _folded(2 * math.pi, n_az) - math.pi
    el0 = (bin_ae % n_el + 0.5) * _folded(math.pi, n_el) - math.pi / 2
    d0 = ((bin_d + 0.5) * _folded(d_max, n_d)).to(dt)
    n_cur = torch.stack([torch.cos(el0) * torch.cos(az0), torch.cos(el0) * torch.sin(az0), torch.sin(el0)],
                        dim=-1).to(dt)  # (B, 3)
    d_cur = d0

    def gate(n, d, cos_th, dist_th_):
        cos = torch.abs(n @ nrm.T)  # (B, M)
        dist = torch.abs(n @ pts.T + d[:, None])
        return valid[None, :] & (cos > cos_th) & (dist < dist_th_)

    # coarse-to-fine: a bin centre can be half a bin (7.5 deg, 0.1 m) off
    for cos_th, dist_th_ in ((0.966, 0.3), (0.9945, 0.1), (angle_cos, dist_th)):
        wgt = gate(n_cur, d_cur, cos_th, dist_th_).to(dt)
        cnt = torch.clamp(wgt.sum(dim=1), min=3.0)
        mu = (wgt @ pts) / cnt[:, None]  # (B, 3)
        centred = pts[None] - mu[:, None, :]  # (B, M, 3)
        cov = (centred * wgt[..., None]).transpose(1, 2) @ centred
        _, vecs = torch.linalg.eigh(cov)
        n_new = vecs[..., 0]
        d_new = -torch.sum(n_new * mu, dim=-1)
        sgn = torch.where(d_new < 0, -1.0, 1.0)
        n_cur, d_cur = n_new * sgn[:, None], d_new * sgn
    inl = gate(n_cur, d_cur, angle_cos, dist_th)
    counts = inl.sum(dim=1)
    centroids = (inl.to(dt) @ pts) / torch.clamp(counts, min=1).to(dt)[:, None]
    coefs = torch.cat([n_cur, d_cur[:, None]], dim=-1)

    # dedupe: a plane near-equal to an earlier (stronger) kept one is dropped
    same = ((torch.abs(coefs[:, :3] @ coefs[:, :3].T) > 0.98)
            & (torch.abs(coefs[None, :, 3] - coefs[:, None, 3]) < 0.1))  # same[i, j]
    keep = torch.ones(max_planes, dtype=torch.bool, device=dev)
    for i in range(1, max_planes):
        keep[i] = ~torch.any(same[i, :i] & keep[:i])
    min_count = min_inliers // (stride * stride)
    valid_out = keep & (counts >= min_count) & (top_votes > 0)
    return coefs, centroids, counts.to(torch.int32), valid_out
