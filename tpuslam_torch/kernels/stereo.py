"""Stereo left-right keypoint matching (port of ``tpuslam/kernels/stereo.py``,
``Frame::ComputeStereoMatches``).

One batched program per frame, as in the reference: the dense left x right
Hamming matrix masked by the epipolar row band (|yL - yR| <= 2 * scale of
the left octave), the disparity gate (uL - fx <= uR <= uL + 1) and the
octave gate (+-1); argmin and the descriptor threshold 75; an 11 x 11 SAD
window (dilated by the left octave's scale) slid over 11 right columns on
the full-resolution images, a parabola through the best triplet for the
sub-pixel disparity; the median-SAD cull.  The reference is plain JAX, not a
TPU kernel, and so is this: plain PyTorch on tensors.

The images are uint8-valued float32, so the SAD sums are integers and exact:
the SAD, its argmin and the ``ok`` mask equal the reference's; only the
parabola's ``delta`` is rounded.  ``argmin`` takes the first minimum, as
``jnp.argmin`` does, and the median is the reference's ``nanmedian`` (the
mean of the middle pair).
"""

from __future__ import annotations

import torch

from ..map.mapstate import nanmedian
from .match import hamming_matrix

_BIG = 1e9


def _octave_scale(octave):
    return torch.pow(1.2, octave.to(torch.float32))


def sad_subpixel(img_l, img_r, uv_l, u_r0, octave_l, w: int = 5, search: int = 5):
    """SAD sliding-window refinement of the right-image u coordinates
    (stereo.py:49-101): for left keypoint i at ``uv_l[i]`` with a coarse
    right match at column ``u_r0[i]`` on the same row, the (2w+1)^2 window
    with its offsets multiplied by round(1.2^octave) is compared at the
    columns ``[-search, +search]`` around it.  Returns (u_refined, sad_best,
    interior), ``interior`` the best shift not at either end."""
    H, W = img_l.shape
    dev = img_l.device
    step = torch.clamp(torch.round(_octave_scale(octave_l)).to(torch.int64), min=1)
    xl = torch.round(uv_l[:, 0]).to(torch.int64)
    yl = torch.round(uv_l[:, 1]).to(torch.int64)
    xr = torch.round(u_r0).to(torch.int64)
    off = torch.arange(-w, w + 1, device=dev)
    dyx = off[None, :] * step[:, None]  # (N, 2w+1) dilated offsets
    ys = torch.clamp(yl[:, None] + dyx, 0, H - 1)  # (N, P)
    shifts = torch.arange(-search, search + 1, device=dev)  # (S,)

    def patch(img, xc):
        """(..., P, P) windows centred on rows ``yl`` and columns ``xc``
        (..., N), centre-subtracted, clamped at the border."""
        xs = torch.clamp(xc[..., None] + dyx, 0, W - 1)  # (..., N, P)
        p = img[ys[:, :, None], xs[..., None, :]]
        return p - p[..., w: w + 1, w: w + 1]

    pl = patch(img_l, xl)  # (N, P, P)
    pr = patch(img_r, xr[None, :] + shifts[:, None])  # (S, N, P, P)
    sads = torch.sum(torch.abs(pl[None] - pr), dim=(-2, -1)).T  # (N, S)
    S = shifts.shape[0]
    best = torch.argmin(sads, dim=1)
    sad_best = sads.gather(1, best[:, None])[:, 0]
    interior = (best > 0) & (best < S - 1)
    bi = torch.clamp(best, 1, S - 2)
    d_m = sads.gather(1, (bi - 1)[:, None])[:, 0]
    d_p = sads.gather(1, (bi + 1)[:, None])[:, 0]
    denom = 2.0 * (d_m + d_p - 2.0 * sad_best)
    delta = torch.where(torch.abs(denom) > 1e-6, (d_m - d_p) / torch.clamp(denom, min=1e-6), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    u_ref = xr.to(torch.float32) + best.to(torch.float32) - search + torch.where(interior, delta, 0.0)
    return u_ref, sad_best, interior


def compute_stereo_matches(img_l, img_r, uv_l, octave_l, desc_l, valid_l, uv_r, octave_r, desc_r, valid_r,
                           bf: float, fx: float, w: int = 5, search: int = 5, th_orb: float = 75.0):
    """Stereo association of one frame (stereo.py:104-160): per left
    keypoint the sub-pixel right u coordinate ``ur``, the depth
    ``bf / disparity`` and the validity mask ``ok`` (``ur`` and ``depth``
    are -1 where not ok).  The gates are Frame::ComputeStereoMatches': the
    row band 2 * scale, disparities in [-1, fx], octaves within one, the
    descriptor threshold 75, and the median-SAD cull at 1.5 * 1.4 * median."""
    row_band = 2.0 * _octave_scale(octave_l)
    dy = torch.abs(uv_l[:, 1:2] - uv_r[None, :, 1])
    du = uv_l[:, 0:1] - uv_r[None, :, 0]  # the disparity if matched
    gate = ((dy <= row_band[:, None]) & (du >= -1.0) & (du <= fx)
            & (torch.abs(octave_l[:, None] - octave_r[None, :]) <= 1))
    mask = valid_l[:, None] & valid_r[None, :] & gate
    dist = torch.where(mask, hamming_matrix(desc_l, desc_r), _BIG)
    idx = torch.argmin(dist, dim=1)
    d1 = dist.gather(1, idx[:, None])[:, 0]
    coarse_ok = d1 < th_orb

    u_ref, sad_best, sp_ok = sad_subpixel(img_l, img_r, uv_l, uv_r[idx, 0], octave_l, w=w, search=search)
    disparity = uv_l[:, 0] - u_ref
    ok = coarse_ok & sp_ok & (disparity > 0.0) & (disparity <= fx)
    med = nanmedian(torch.where(ok, sad_best, float("nan")))
    med = torch.where(torch.isnan(med), _BIG, med)
    ok = ok & (sad_best <= 1.5 * 1.4 * med)
    # a tensor numerator: ``number / tensor`` is a reciprocal times the number
    depth = torch.where(ok, torch.full_like(disparity, bf) / torch.clamp(disparity, min=1e-6), -1.0)
    ur = torch.where(ok, u_ref, -1.0)
    return ur, depth, ok
