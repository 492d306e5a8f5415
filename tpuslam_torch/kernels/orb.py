"""ORB feature extraction (port of ``tpuslam/kernels/orb.py``).

The pipeline is the reference's: an 8-level pyramid of two resize matmuls
per level, dense FAST-9 + 3x3 NMS on every level (kernel K1 on the card,
``cuda_fast.fast_nms_score``), per-cell top-k, a per-level quota, a 7-tap
Gaussian blur, IC-angle orientation and steered 256-bit BRIEF.

What the reference computes through TPU workarounds is computed directly:
the iterative ``_topk_small`` and ``lax.top_k`` become a stable descending
sort (the lower index wins a tie, as in JAX), and the one-hot-matmul patch
and BRIEF gathers become indexing.  Every bf16 rounding point of the
reference is kept, because each one changes results: the patch is rounded
as ``bf16(strip - mean) + mean`` and the blurred patch is rounded to bf16
before BRIEF sampling.

The constant tables are re-created here in numpy (the reference module
needs its framework) and are checked bit for bit against the reference's in the
tests.  Descriptors are (N, 8) int32 tensors holding the uint32 bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_fast

# ---------------------------------------------------------------------------
# Static tables (numpy, identical to the reference's)
# ---------------------------------------------------------------------------

# FAST circle of radius 3 (Bresenham ring, 16 offsets, clockwise), (dy, dx)
_FAST_RING = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)

_PATCH_RADIUS = 15  # IC-angle circular patch radius
# per-keypoint patch: 48x64 with the keypoint at (24, 32)
_PATCH_H, _PATCH_W = 48, 64
_PATCH_CY, _PATCH_CX = 24, 32
_PYR_PAD = 32  # pyramid border pad so every patch lies in bounds
_BLUR_SIGMA, _BLUR_RADIUS = 2.0, 3


def _ic_angle_weights():
    """(2, PATCH_H, PATCH_W) m01/m10 moment weights: dy/dx inside the
    radius-15 circle centred on the keypoint, zero elsewhere."""
    ys, xs = np.mgrid[-_PATCH_CY : _PATCH_H - _PATCH_CY, -_PATCH_CX : _PATCH_W - _PATCH_CX]
    mask = (ys * ys + xs * xs <= _PATCH_RADIUS * _PATCH_RADIUS).astype(np.float32)
    return np.stack([ys * mask, xs * mask]).astype(np.float32)


def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 1234):
    """(n_bits, 2, 2) sampling pairs [pair, point a/b, (y, x)], Gaussian
    sigma = patch/5, clipped so rotated samples stay inside the patch."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(n_bits, 2, 2) * (patch / 5.0)
    lim = patch // 2 - 2
    return np.clip(np.round(pts), -lim, lim).astype(np.float32)


def _blur_taps():
    xs = np.arange(-_BLUR_RADIUS, _BLUR_RADIUS + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / _BLUR_SIGMA) ** 2)
    return k / k.sum()


def level_scales(n_levels: int, scale_factor: float):
    return np.array([scale_factor**i for i in range(n_levels)], dtype=np.float32)


@functools.lru_cache(maxsize=64)
def _resize_matrix(src: int, dst: int):
    """(dst, src) antialiased linear-interpolation matrix, the semantics of
    the reference's bilinear ``image.resize`` when shrinking."""
    scale = src / dst
    support = max(scale, 1.0)
    M = np.zeros((dst, src), np.float64)
    j = np.arange(src, dtype=np.float64)
    for i in range(dst):
        c = (i + 0.5) * scale - 0.5
        w = np.maximum(0.0, 1.0 - np.abs(j - c) / support)
        M[i] = w / w.sum()
    return M.astype(np.float32)


def _level_dims(H, W, n_levels, scale_factor):
    """Level l is the top-left ``round(H/s^l) x round(W/s^l)`` region."""
    return [
        (int(round(H / scale_factor**lvl)), int(round(W / scale_factor**lvl)))
        for lvl in range(n_levels)
    ]


def _level_quota(n_features: int, n_levels: int, scale_factor: float):
    """Features per level: the geometric series of the reference ctor."""
    inv = 1.0 / scale_factor
    quota = n_features * (1 - inv) / (1 - inv**n_levels) * inv ** np.arange(n_levels)
    quota = np.floor(quota).astype(np.int32)
    quota[-1] = max(n_features - int(quota[:-1].sum()), 0)
    return [int(q) for q in quota]


class Features(NamedTuple):
    """Padded per-frame ORB features (all of length ``N = n_features``)."""

    uv: torch.Tensor  # (N, 2) float32 level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,) float32
    octave: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,) float32 radians
    desc: torch.Tensor  # (N, 8) int32 holding the uint32 descriptor words
    valid: torch.Tensor  # (N,) bool


# ---------------------------------------------------------------------------
# Pyramid and the plain FAST + NMS
# ---------------------------------------------------------------------------


def _has_run9(mask16):
    """int64 16-bit ring masks -> bool: a circular run of >= 9 set bits."""
    m = mask16 | (mask16 << 16)
    acc = m
    for k in range(1, 9):
        acc = acc & (m >> k)
    return acc != 0


def fast_response(img, strict_th: float, weak_th: float):
    """Dense FAST-9 score for (..., H, W): > 0 iff a corner at the weak
    threshold, +1e6 iff also a corner at the strict threshold (the
    reference's 20 -> 7 fallback without branches).  The ring wraps in both
    y and x, like the reference's ``jnp.roll``; excesses are summed in ring
    order, as the CUDA kernel sums them."""
    zero = img.new_zeros(())
    bw = dw = bs = ds = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    sb = sd = torch.zeros_like(img)
    for p, (dy, dx) in enumerate(_FAST_RING.tolist()):
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


def fast_nms_plain(pyramid, strict_th: float = 20.0, weak_th: float = 7.0):
    """Plain PyTorch version of kernel K1: ``nms3(fast_response(...))``."""
    return nms3(fast_response(pyramid, strict_th, weak_th))


def topk_stable(x, k: int):
    """Top-k along the last axis with the reference's tie order (``lax.top_k``:
    the lower index first among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------


class OrbExtractor(torch.nn.Module):
    """ORB extraction for (height, width) images.  The constant tables (the
    pyramid's resize matrices, the border mask, BRIEF pairs, IC-angle
    weights) are buffers created once on ``device``."""

    def __init__(
        self,
        height: int,
        width: int,
        device,
        n_features: int = 1000,
        n_levels: int = 8,
        scale_factor: float = 1.2,
        ini_th: int = 20,
        min_th: int = 7,
        cell_size: int = 32,
        edge_margin: int = 20,
        cell_topk: int = 4,
    ):
        super().__init__()
        self.height, self.width = int(height), int(width)
        self.n_features, self.n_levels = int(n_features), int(n_levels)
        self.scale_factor = float(scale_factor)
        self.ini_th, self.min_th = float(ini_th), float(min_th)
        self.cell_size, self.cell_topk = int(cell_size), int(cell_topk)
        self.dims = _level_dims(self.height, self.width, self.n_levels, self.scale_factor)
        self.quota = _level_quota(self.n_features, self.n_levels, self.scale_factor)
        self.blur_taps = [float(k) for k in _blur_taps()]

        def buf(name, arr, dtype=torch.float32):
            self.register_buffer(name, torch.as_tensor(arr, dtype=dtype, device=device))

        prev_h, prev_w = self.height, self.width
        for lvl, (h, w) in enumerate(self.dims[1:], start=1):
            buf(f"resize_rows{lvl}", _resize_matrix(prev_h, h))
            buf(f"resize_cols{lvl}", _resize_matrix(prev_w, w))
            prev_h, prev_w = h, w
        row = np.arange(self.height)[None, :, None]
        col = np.arange(self.width)[None, None, :]
        hs = np.array([d[0] for d in self.dims])[:, None, None]
        ws = np.array([d[1] for d in self.dims])[:, None, None]
        m = int(edge_margin)
        buf("inside", (row >= m) & (row < hs - m) & (col >= m) & (col < ws - m), torch.bool)
        buf("scales", level_scales(self.n_levels, self.scale_factor))
        # each level's live (h, w): the pyramid is zero outside it, which
        # lets kernel K1 skip the padding
        buf("live_dims", np.array(self.dims), torch.int32)
        buf("ic_weights", _ic_angle_weights())
        buf("brief_pairs", _brief_pattern())

    def pyramid(self, image):
        """(H, W) float32 -> zero-padded (L, H, W) pyramid (the reference's
        ``build_pyramid``): level l is the top-left ``round(H/s^l) x
        round(W/s^l)`` region, resized from level l-1 by two interpolation
        matmuls, rows then columns."""
        levels = [image]
        prev, (ph, pw) = image, self.dims[0]
        for lvl, (h, w) in enumerate(self.dims[1:], start=1):
            padded = image.new_zeros((self.height, self.width))
            ry = getattr(self, f"resize_rows{lvl}")
            cx = getattr(self, f"resize_cols{lvl}")
            padded[:h, :w] = ry @ prev[:ph, :pw] @ cx.T
            levels.append(padded)
            prev, ph, pw = padded, h, w
        return torch.stack(levels, dim=0)

    def forward(self, image) -> Features:
        """Extract from a (H, W) grayscale image in [0, 255]."""
        H, W, L, cs = self.height, self.width, self.n_levels, self.cell_size
        pyr = self.pyramid(image.to(torch.float32))
        score = cuda_fast.fast_nms_score(pyr, self.ini_th, self.min_th, self.live_dims)
        score = torch.where(self.inside, score, 0.0)

        # --- per-cell top-k on each level ----------------------------------
        n_cy, n_cx = -(-H // cs), -(-W // cs)
        s = F.pad(score, (0, n_cx * cs - W, 0, n_cy * cs - H))
        s = s.reshape(L, n_cy, cs, n_cx, cs).permute(0, 1, 3, 2, 4)
        cell_scores, cell_idx = topk_stable(s.reshape(L, n_cy * n_cx, cs * cs), self.cell_topk)
        cells = torch.arange(n_cy * n_cx, device=score.device, dtype=torch.int32)
        cand_y = ((cells // n_cx)[None, :, None] * cs + cell_idx // cs).reshape(L, -1)
        cand_x = ((cells % n_cx)[None, :, None] * cs + cell_idx % cs).reshape(L, -1)
        cand_s = cell_scores.reshape(L, -1)

        # --- per-level quota -----------------------------------------------
        top_s, top_i = topk_stable(cand_s, cand_s.shape[1])
        sel_y, sel_x, sel_s, sel_l = [], [], [], []
        for lvl, q in enumerate(self.quota):
            k = min(q, cand_s.shape[1])
            if k == 0:
                continue
            idx = top_i[lvl, :k]
            sel_y.append(cand_y[lvl][idx])
            sel_x.append(cand_x[lvl][idx])
            sel_s.append(top_s[lvl, :k])
            sel_l.append(torch.full((k,), lvl, dtype=torch.int32, device=score.device))
        pad = max(self.n_features - sum(len(v) for v in sel_s), 0)
        kp_y = F.pad(torch.cat(sel_y)[: self.n_features], (0, pad)).to(torch.int32)
        kp_x = F.pad(torch.cat(sel_x)[: self.n_features], (0, pad)).to(torch.int32)
        kp_s = F.pad(torch.cat(sel_s)[: self.n_features], (0, pad))
        kp_l = F.pad(torch.cat(sel_l)[: self.n_features], (0, pad))
        valid = kp_s > 0.0

        # --- blurred patches, IC angle, steered BRIEF ------------------------
        patches = self._patches(self._blur(pyr), kp_l, kp_y, kp_x)  # (N, 48, 64)
        m01 = torch.sum(patches * self.ic_weights[0], dim=(1, 2))
        m10 = torch.sum(patches * self.ic_weights[1], dim=(1, 2))
        angle = torch.atan2(m01, m10)
        desc = self._brief(patches, angle)

        scale = self.scales[kp_l]
        uv = torch.stack([kp_x * scale, kp_y * scale], dim=-1)
        return Features(uv=uv, response=kp_s, octave=kp_l, angle=angle, desc=desc, valid=valid)

    def _blur(self, pyr):
        """Separable 7-tap Gaussian by shifted adds (x, then y), wrapping at
        the borders like the reference; the 20 px edge margin keeps every
        sampled pixel clear of the wrap."""
        r = _BLUR_RADIUS
        out = torch.zeros_like(pyr)
        for d in range(-r, r + 1):
            out = out + self.blur_taps[d + r] * torch.roll(pyr, -d, dims=-1)
        out2 = torch.zeros_like(out)
        for d in range(-r, r + 1):
            out2 = out2 + self.blur_taps[d + r] * torch.roll(out, -d, dims=-2)
        return out2

    def _patches(self, blurred, kp_l, kp_y, kp_x):
        """(L, H, W) + per-keypoint (level, y, x) -> (N, 48, 64) patches.

        The reference pulls 48 full padded rows per keypoint, centres them on
        their mean, rounds to bf16 and selects 64 columns with a one-hot
        matmul; the same values come out of indexing the 48x64 window,
        rounding ``window - mean`` to bf16 and adding the mean back.  The
        mean is over the keypoint's 48 full padded rows, as in the reference.
        """
        L = blurred.shape[0]
        pp = F.pad(blurred, (_PYR_PAD,) * 4)
        Hp, Wp = pp.shape[1:]
        flat = pp.reshape(L * Hp, Wp)
        rows = (kp_l * Hp + kp_y + (_PYR_PAD - _PATCH_CY)).long()[:, None] + torch.arange(
            _PATCH_H, device=pp.device
        )
        cols = (kp_x + (_PYR_PAD - _PATCH_CX)).long()[:, None] + torch.arange(
            _PATCH_W, device=pp.device
        )
        mean = (flat.sum(dim=1)[rows].sum(dim=1) / float(_PATCH_H * Wp))[:, None, None]
        win = flat[rows[:, :, None], cols[:, None, :]]
        return (win - mean).to(torch.bfloat16).to(torch.float32) + mean

    def _brief(self, patches, angle):
        """Steered BRIEF: (N, 48, 64) blurred patches, (N,) angles -> (N, 8)
        int32 words; samples are rounded to bf16 like the reference's."""
        n = patches.shape[0]
        py = self.brief_pairs[..., 0].reshape(-1)  # (512,) a/b interleaved
        px = self.brief_pairs[..., 1].reshape(-1)
        ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
        ry = torch.round(px * sa + py * ca).to(torch.int64)
        rx = torch.round(px * ca - py * sa).to(torch.int64)
        iy = torch.clamp(_PATCH_CY + ry, 0, _PATCH_H - 1)
        ix = torch.clamp(_PATCH_CX + rx, 0, _PATCH_W - 1)
        flat = patches.to(torch.bfloat16).to(torch.float32).reshape(n, -1)
        samples = flat.gather(1, iy * _PATCH_W + ix).reshape(n, 256, 2)
        bits = (samples[..., 0] < samples[..., 1]).reshape(n, 8, 32).long()
        return pack_words(bits)


def pack_words(bits):
    """(..., 32) int64 bits -> (...) int32 words holding the uint32 value;
    packed in int64, so bit 31 wraps to the int32 sign bit explicitly."""
    shifts = torch.arange(32, device=bits.device)
    w = torch.sum(bits << shifts, dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_descriptor_bits(desc):
    """(..., 8) int32 words -> (..., 256) float32 in {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], 256).to(torch.float32)
