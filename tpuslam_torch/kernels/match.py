"""Batched ORB descriptor matching (port of ``tpuslam/kernels/match.py``).

Gated searches build the dense (N, M) Hamming matrix as one matmul over
unpacked bits and mask it; ungated non-mutual searches go to kernel K2
(``cuda_match.hamming_top2``), as the reference sends them to its Pallas
kernel.  The dense path and the gates take leading batch dimensions, so one
call searches several keyframe pairs at once (the reference vmaps them).
"""

from __future__ import annotations

import math

import torch

from .cuda_match import BIG, hamming_top2
from .orb import topk_stable, unpack_descriptor_bits


def hamming_matrix(desc_a, desc_b):
    """(..., N, 8) x (..., M, 8) int32 words -> (..., N, M) float32 Hamming
    distances (``|a| + |b| - 2 a.b`` on {0, 1} bits: exact integers in float32)."""
    a = unpack_descriptor_bits(desc_a)
    b = unpack_descriptor_bits(desc_b)
    dot = a @ b.transpose(-1, -2)
    return a.sum(-1, keepdim=True) + b.sum(-1)[..., None, :] - 2.0 * dot


def masked_argmin2(dist):
    """Best and second-best along the last axis: (idx int64, d1, d2); the
    first minimum wins a tie and a tied minimum surfaces as d2 == d1."""
    idx = torch.argmin(dist, dim=-1)
    d1 = dist.gather(-1, idx[..., None])[..., 0]
    dist2 = dist.scatter(-1, idx[..., None], BIG)
    return idx, d1, torch.min(dist2, dim=-1).values


def match_descriptors(desc_a, desc_b, valid_a, valid_b, gate_mask=None,
                      max_dist: float = 50.0, ratio: float = 1.0, mutual: bool = False):
    """Gated nearest-neighbour matching a -> b: (idx (N,) int64, dists, ok).
    A gated or mutual search may carry leading batch dimensions."""
    if gate_mask is None and not mutual:
        idx, d1, d2 = hamming_top2(desc_a, desc_b, valid_b)
        ok = valid_a & (d1 <= max_dist) & (d1 <= ratio * d2)
        return idx.long(), d1, ok
    mask = valid_a[..., :, None] & valid_b[..., None, :]
    if gate_mask is not None:
        mask = mask & gate_mask
    dist = torch.where(mask, hamming_matrix(desc_a, desc_b), BIG)
    idx, d1, d2 = masked_argmin2(dist)
    ok = (d1 <= max_dist) & (d1 <= ratio * d2)
    if mutual:
        back = torch.argmin(dist, dim=-2)
        rows = torch.arange(dist.shape[-2], device=idx.device)
        ok = ok & (back.gather(-1, idx) == rows)
    return idx, d1, ok


def rotation_consistency(angle_a, angle_b, idx, ok, hist_length: int = 30, top_bins: int = 3):
    """Keep only matches whose angle difference falls in the ``top_bins``
    most popular of ``hist_length`` histogram bins (ties: lower bin first).
    Leading batch dimensions of ``angle_b``, ``idx`` and ``ok`` each keep a
    histogram of their own."""
    rot = torch.remainder(angle_a - angle_b.gather(-1, idx), 2.0 * math.pi)
    bins = torch.clamp((rot * hist_length / (2.0 * math.pi)).to(torch.int64), 0, hist_length - 1)
    batch = bins.shape[:-1]
    rows = torch.arange(bins[..., 0].numel(), device=bins.device).reshape(batch + (1,))
    counts = torch.zeros(batch + (hist_length,), dtype=torch.int32, device=bins.device)
    counts = counts.reshape(-1).index_add(
        0, (rows * hist_length + bins).reshape(-1), ok.to(torch.int32).reshape(-1)
    ).reshape(batch + (hist_length,))
    _, top = topk_stable(counts, top_bins)
    return ok & torch.any(bins[..., :, None] == top[..., None, :], dim=-1)


def window_gate(uv_a, uv_b, radius):
    """(N, 2), (M, 2) -> (N, M) bool: b within ``radius`` pixels of a;
    ``radius`` is a number or a per-row (N,) tensor."""
    d2 = torch.sum((uv_a[..., :, None, :] - uv_b[..., None, :, :]) ** 2, dim=-1)
    if isinstance(radius, torch.Tensor) and radius.dim() >= 1:
        return d2 <= (radius**2)[..., None]
    return d2 <= radius**2


def octave_gate(oct_pred, oct_b, lo: int = -1, hi: int = 1):
    """(N,), (M,) -> (N, M) bool: octave of b within [pred+lo, pred+hi]."""
    diff = oct_b[..., None, :] - oct_pred[..., :, None]
    return (diff >= lo) & (diff <= hi)


def epipolar_gate(uv_a, uv_b, F12, scale_b, th: float = 3.84):
    """(N, 2), (M, 2), fundamental (3, 3) -> (N, M) bool: the squared distance
    of b to the epipolar line ``F12^T a`` below ``th * scale_b**2``
    (CheckDistEpipolarLine, ORBmatcher.cc:640-654)."""
    pa = torch.cat([uv_a, torch.ones_like(uv_a[..., :1])], dim=-1)
    lines = pa @ F12  # (..., N, 3) line coefficients in image b
    num = (
        lines[..., :, None, 0] * uv_b[..., None, :, 0]
        + lines[..., :, None, 1] * uv_b[..., None, :, 1]
        + lines[..., :, None, 2]
    ) ** 2
    den = lines[..., 0:1] ** 2 + lines[..., 1:2] ** 2
    dsq = num / (den + 1e-12)
    return dsq < th * scale_b[..., None, :] ** 2
