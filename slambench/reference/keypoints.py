"""Plain reference of ORB extraction: which (level, y, x) an extractor with
these settings keeps from a raw frame, and the steered BRIEF descriptor at
a given keypoint.

The semantics of ORB-SLAM2's extractor as the port states them
(``tpuslam_torch/kernels/orb.py``, frozen here): an antialiased linear
pyramid, dense FAST-9 with the 20 -> 7 threshold fallback, 3x3
non-maximum suppression, a 20 px edge margin, the best 4 corners of each
32 px cell, then each level's share of the features by score (the lower
index first among equal scores).  The pyramid is computed in float64, so
it stands above the program's float32: level 0 is integer arithmetic and
must agree exactly; the levels below it agree up to the float32 rounding of
the program's resize, which moves a corner across a threshold or a tie only
rarely.  The descriptor follows the port's stated arithmetic: a 7-tap
Gaussian blur, a 48x64 patch around the keypoint centred on the mean of its
48 padded rows and rounded to bfloat16, the intensity-centroid angle of the
radius-15 disc and 256 steered pairs of the seeded pattern, sampled from
the patch rounded to bfloat16 again.  The blur is float64 and the rest
float32, so a float32 program differs from it only where its rounding
tips a bfloat16 rounding or a rotated sample's pixel; arithmetic one
precision lower (TF32 resizes) tips many more.  Nothing here imports the
program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# FAST circle of radius 3 (Bresenham ring, 16 offsets, clockwise), (dy, dx)
FAST_RING = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


@functools.lru_cache(maxsize=64)
def resize_matrix(src: int, dst: int):
    """(dst, src) antialiased linear-interpolation matrix (shrinking)."""
    scale = src / dst
    support = max(scale, 1.0)
    M = np.zeros((dst, src), np.float64)
    j = np.arange(src, dtype=np.float64)
    for i in range(dst):
        c = (i + 0.5) * scale - 0.5
        w = np.maximum(0.0, 1.0 - np.abs(j - c) / support)
        M[i] = w / w.sum()
    return M.astype(np.float32)


def level_dims(H: int, W: int, n_levels: int, scale_factor: float):
    """Level l is the top-left ``round(H/s^l) x round(W/s^l)`` region."""
    return [(int(round(H / scale_factor**lvl)), int(round(W / scale_factor**lvl))) for lvl in range(n_levels)]


def level_quota(n_features: int, n_levels: int, scale_factor: float):
    """Features per level: the geometric series of ORB-SLAM2's extractor."""
    inv = 1.0 / scale_factor
    quota = n_features * (1 - inv) / (1 - inv**n_levels) * inv ** np.arange(n_levels)
    quota = np.floor(quota).astype(np.int32)
    quota[-1] = max(n_features - int(quota[:-1].sum()), 0)
    return [int(q) for q in quota]


def level_scales(n_levels: int, scale_factor: float):
    return np.array([scale_factor**i for i in range(n_levels)], dtype=np.float32)


def pyramid(image, n_levels: int, scale_factor: float):
    """(H, W) -> zero-padded (L, H, W) float64 pyramid: each level resized
    from the one above by two interpolation matmuls, rows then columns."""
    img = image.to(torch.float64)
    H, W = img.shape
    dims = level_dims(H, W, n_levels, scale_factor)
    levels, prev, (ph, pw) = [img], img, dims[0]
    for h, w in dims[1:]:
        ry = torch.as_tensor(resize_matrix(ph, h), dtype=torch.float64, device=img.device)
        cx = torch.as_tensor(resize_matrix(pw, w), dtype=torch.float64, device=img.device)
        padded = img.new_zeros((H, W))
        padded[:h, :w] = ry @ prev[:ph, :pw] @ cx.T
        levels.append(padded)
        prev, ph, pw = padded, h, w
    return torch.stack(levels)


PATCH_H, PATCH_W, PATCH_CY, PATCH_CX, PYR_PAD = 48, 64, 24, 32, 32
PATCH_RADIUS, BLUR_SIGMA, BLUR_RADIUS = 15, 2.0, 3


def ic_angle_weights():
    """(2, 48, 64) moment weights dy, dx inside the radius-15 disc."""
    ys, xs = np.mgrid[-PATCH_CY:PATCH_H - PATCH_CY, -PATCH_CX:PATCH_W - PATCH_CX]
    mask = (ys * ys + xs * xs <= PATCH_RADIUS * PATCH_RADIUS).astype(np.float32)
    return np.stack([ys * mask, xs * mask]).astype(np.float32)


def brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 1234):
    """(n_bits, 2, 2) pairs [pair, point, (y, x)]: Gaussian with sigma
    patch/5, rounded and clipped so rotated samples stay in the patch."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(n_bits, 2, 2) * (patch / 5.0)
    lim = patch // 2 - 2
    return np.clip(np.round(pts), -lim, lim).astype(np.float32)


def blur(pyr):
    """Separable 7-tap Gaussian (x, then y), wrapping at the borders."""
    xs = np.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / BLUR_SIGMA) ** 2)
    taps = [float(v) for v in k / k.sum()]
    out = torch.zeros_like(pyr)
    for d in range(-BLUR_RADIUS, BLUR_RADIUS + 1):
        out = out + taps[d + BLUR_RADIUS] * torch.roll(pyr, -d, dims=-1)
    out2 = torch.zeros_like(out)
    for d in range(-BLUR_RADIUS, BLUR_RADIUS + 1):
        out2 = out2 + taps[d + BLUR_RADIUS] * torch.roll(out, -d, dims=-2)
    return out2


def descriptors(image, rows, n_levels: int, scale_factor: float):
    """(K, 8) int64 words (the uint32 bits) of the steered BRIEF descriptor
    at each (level, y, x) of ``rows`` (K, 3) in the (H, W) ``image``."""
    dev = image.device
    rows = torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=dev)
    blurred = blur(pyramid(image, n_levels, scale_factor)).to(torch.float32)
    L = blurred.shape[0]
    pp = F.pad(blurred, (PYR_PAD,) * 4)
    Hp, Wp = pp.shape[1:]
    flat = pp.reshape(L * Hp, Wp)
    lvl, y, x = rows[:, 0], rows[:, 1], rows[:, 2]
    r = (lvl * Hp + y + (PYR_PAD - PATCH_CY))[:, None] + torch.arange(PATCH_H, device=dev)
    c = (x + (PYR_PAD - PATCH_CX))[:, None] + torch.arange(PATCH_W, device=dev)
    mean = (flat.sum(dim=1)[r].sum(dim=1) / float(PATCH_H * Wp))[:, None, None]
    patches = (flat[r[:, :, None], c[:, None, :]] - mean).to(torch.bfloat16).to(torch.float32) + mean
    w = torch.as_tensor(ic_angle_weights(), device=dev)
    angle = torch.atan2(torch.sum(patches * w[0], dim=(1, 2)), torch.sum(patches * w[1], dim=(1, 2)))
    pairs = torch.as_tensor(brief_pattern(), device=dev)
    py, px = pairs[..., 0].reshape(-1), pairs[..., 1].reshape(-1)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    iy = torch.clamp(PATCH_CY + torch.round(px * sa + py * ca).to(torch.int64), 0, PATCH_H - 1)
    ix = torch.clamp(PATCH_CX + torch.round(px * ca - py * sa).to(torch.int64), 0, PATCH_W - 1)
    n = patches.shape[0]
    samples = patches.to(torch.bfloat16).to(torch.float32).reshape(n, -1).gather(1, iy * PATCH_W + ix)
    bits = (samples.reshape(n, 256, 2)[..., 0] < samples.reshape(n, 256, 2)[..., 1]).reshape(n, 8, 32).long()
    return torch.sum(bits << torch.arange(32, device=dev), dim=-1).cpu()


def bit_mismatch(got_words, want_words) -> int:
    """Bits that differ between two (K, 8) descriptor sets (uint32 words held
    in int32 or int64)."""
    a = np.asarray(got_words, np.int64) & 0xFFFFFFFF
    b = np.asarray(want_words, np.int64) & 0xFFFFFFFF
    return int(np.unpackbits((a ^ b).astype(">u4").view(np.uint8)).sum())


def _has_run9(mask16):
    m = mask16 | (mask16 << 16)
    acc = m
    for k in range(1, 9):
        acc = acc & (m >> k)
    return acc != 0


def fast_score(img, strict_th: float, weak_th: float):
    """Dense FAST-9 score: > 0 iff a corner at the weak threshold, +1e6 iff
    also at the strict one; excesses summed in ring order; the ring wraps."""
    zero = img.new_zeros(())
    bw = dw = bs = ds = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    sb = sd = torch.zeros_like(img)
    for p, (dy, dx) in enumerate(FAST_RING):
        d = torch.roll(img, (-dy, -dx), dims=(-2, -1)) - img
        excess = torch.abs(d) - weak_th
        bright, dark = d > weak_th, d < -weak_th
        bw = bw | (bright.long() << p)
        dw = dw | (dark.long() << p)
        bs = bs | ((d > strict_th).long() << p)
        ds = ds | ((d < -strict_th).long() << p)
        sb = sb + torch.where(bright, excess, zero)
        sd = sd + torch.where(dark, excess, zero)
    weak = _has_run9(bw) | _has_run9(dw)
    strict = _has_run9(bs) | _has_run9(ds)
    score = torch.maximum(sb, sd) + torch.where(strict, 1e6, 0.0)
    return torch.where(weak, score, zero)


def nms3(score):
    """3x3 non-maximum suppression on (L, H, W); the border pads with -inf."""
    neighborhood = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(score >= neighborhood, score, 0.0)


def _topk_stable(x, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(image, n_features: int, n_levels: int, scale_factor: float, ini_th: float, min_th: float,
                     cell_size: int = 32, edge_margin: int = 20, cell_topk: int = 4):
    """(K, 3) int64 rows (level, y, x) of the keypoints kept from the (H, W)
    ``image``, in the extractor's order (level by level, by score)."""
    H, W = image.shape
    L, cs = n_levels, cell_size
    pyr = pyramid(image, n_levels, scale_factor)
    score = nms3(fast_score(pyr, ini_th, min_th))
    dims = level_dims(H, W, n_levels, scale_factor)
    row = torch.arange(H, device=pyr.device)[None, :, None]
    col = torch.arange(W, device=pyr.device)[None, None, :]
    hs = torch.tensor([d[0] for d in dims], device=pyr.device)[:, None, None]
    ws = torch.tensor([d[1] for d in dims], device=pyr.device)[:, None, None]
    m = edge_margin
    inside = (row >= m) & (row < hs - m) & (col >= m) & (col < ws - m)
    score = torch.where(inside, score, 0.0)
    n_cy, n_cx = -(-H // cs), -(-W // cs)
    s = F.pad(score, (0, n_cx * cs - W, 0, n_cy * cs - H))
    s = s.reshape(L, n_cy, cs, n_cx, cs).permute(0, 1, 3, 2, 4)
    cell_scores, cell_idx = _topk_stable(s.reshape(L, n_cy * n_cx, cs * cs), cell_topk)
    cells = torch.arange(n_cy * n_cx, device=pyr.device)
    cand_y = ((cells // n_cx)[None, :, None] * cs + cell_idx // cs).reshape(L, -1)
    cand_x = ((cells % n_cx)[None, :, None] * cs + cell_idx % cs).reshape(L, -1)
    cand_s = cell_scores.reshape(L, -1)
    top_s, top_i = _topk_stable(cand_s, cand_s.shape[1])
    out, total = [], 0
    for lvl, q in enumerate(level_quota(n_features, n_levels, scale_factor)):
        k = min(q, cand_s.shape[1], n_features - total)
        total += max(k, 0)
        if k <= 0:
            continue
        idx = top_i[lvl, :k]
        keep = top_s[lvl, :k] > 0
        ys, xs = cand_y[lvl][idx][keep], cand_x[lvl][idx][keep]
        out.append(torch.stack([torch.full_like(ys, lvl), ys, xs], dim=-1))
    return torch.cat(out).cpu()


def keypoint_rows(uv, octave, valid, scale_factor: float, n_levels: int):
    """(K, 3) int64 rows (level, y, x) of a program's keypoints, from their
    level-0 pixel positions ``uv`` (N, 2) and octaves: each position divided
    by its level's scale and rounded."""
    uv = np.asarray(uv, np.float64)[np.asarray(valid, bool)]
    lvl = np.asarray(octave, np.int64)[np.asarray(valid, bool)]
    s = level_scales(n_levels, scale_factor).astype(np.float64)[lvl]
    return np.stack([lvl, np.rint(uv[:, 1] / s).astype(np.int64), np.rint(uv[:, 0] / s).astype(np.int64)], axis=-1)


def mismatch(got, want):
    """(rows in one set only, per level: level -> (count in one only, rows
    wanted)) of two (K, 3) row sets."""
    a = {tuple(r) for r in np.asarray(got).tolist()}
    b = {tuple(r) for r in np.asarray(want).tolist()}
    diff = a ^ b
    per = {}
    for lvl in sorted({r[0] for r in a | b}):
        per[lvl] = (sum(r[0] == lvl for r in diff), sum(r[0] == lvl for r in b))
    return len(diff), per
