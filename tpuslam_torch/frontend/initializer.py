"""Monocular two-view bootstrap (port of ``tpuslam/frontend/initializer.py``).

All 200 RANSAC hypotheses of both models (fundamental and homography) are
fitted and scored at once, as batched tensors; the model is chosen by the
score ratio RH > 0.40 and its motion hypotheses are checked by cheirality,
reprojection and parallax (Initializer.cc:56-937).

The reference draws its minimal samples with its framework's Threefry-2x32
generator inside the solver.  Here the (200, 8) sample indices are an
input: :func:`ransac_samples` draws the reference's own stream on the host
(the same bits, so the same samples for the same seed and mask), and a test
may pass any samples instead.

Eigenvectors and singular vectors are defined up to sign; every quantity
returned here (F and H up to sign, points as ``x[:3] / x[3]``, the chosen
pose) is sign-free.  On a CUDA device ``torch.linalg.eigh`` and ``svd``
check their results on the host, so each call waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import geometry as geo


class InitResult(NamedTuple):
    ok: torch.Tensor  # () bool
    T_21: torch.Tensor  # (4, 4) pose of frame 2 wrt frame 1 (world = frame 1)
    points: torch.Tensor  # (N, 3) triangulated points in frame-1 coords
    good: torch.Tensor  # (N,) bool triangulation inlier mask
    used_h: torch.Tensor  # () bool which model won


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC 2011) on uint32 numpy
    arrays (broadcast), as the reference's framework hashes a counter pair
    ``(x1, x2)`` under a key ``(k1, k2)``.  Returns the two output words."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = x1 ^ ((x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r)))
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def ransac_samples(valid, seed: int, n_iters: int = 200, n_pick: int = 8):
    """(n_iters, n_pick) int64 sample indices on the CPU, the reference's
    draw bit for bit (initializer.py:281-287, pnp.py:64-68,
    sim3solver.py:73-77 of the reference): the key ``PRNGKey(seed)`` split
    into ``n_iters`` keys (counters 0..n_iters-1), per key a uniform float32
    per entry from the xor of the two hash words, Gumbel noise
    ``-log(-log(u))`` plus ``-1e9`` on invalid entries, and its ``n_pick``
    largest, ties to the lower index: distinct valid indices drawn
    uniformly."""
    valid = np.asarray(valid.cpu()) if isinstance(valid, torch.Tensor) else np.asarray(valid)
    n = valid.shape[0]
    k1, k2 = threefry2x32(0, int(seed) & 0xFFFFFFFF, np.zeros(n_iters, np.uint32), np.arange(n_iters, dtype=np.uint32))
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], np.zeros((1, n), np.uint32), np.arange(n, dtype=np.uint32)[None])
    u = (((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    u = np.maximum(u, np.finfo(np.float32).tiny)
    g = -np.log(-np.log(u)) + np.where(valid, np.float32(0.0), np.float32(-1e9))
    return torch.from_numpy(np.argsort(-g, axis=1, kind="stable")[:, :n_pick].astype(np.int64))


def _normalize(pts, valid):
    """Mean / mean-abs-dev normalization (Initializer::Normalize)."""
    w = valid.to(pts.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    dev = torch.sum(torch.abs(pts - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(dev, min=1e-6)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (pts - mean) * s, T


def _smallest_eigvec(A):
    """Unit vector minimizing |A x| via eigh(A^T A), batched over leading dims."""
    M = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(M)
    return vecs[..., :, 0]


def _fundamental_from_8(p1, p2):
    """(..., 8, 2) x 2 normalized points -> F (..., 3, 3), rank 2 enforced."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1)
    F = _smallest_eigvec(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U * S[..., None, :]) @ Vh


def _homography_from_8(p1, p2):
    """(..., 8, 2) x 2 normalized points -> H (..., 3, 3) via DLT."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    return _smallest_eigvec(A).reshape(A.shape[:-2] + (3, 3))


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _check_fundamental(F, p1, p2, valid, sigma: float = 1.0):
    """Symmetric epipolar score (Initializer::CheckFundamental), batched over
    the leading dims of F (..., 3, 3): chi2 > 3.841 -> outlier, else score +=
    5.991 - chi2 per direction."""
    th, th_score = 3.841, 5.991
    inv_s2 = 1.0 / sigma**2
    h1, h2 = _homog(p1), _homog(p2)
    l2 = h1 @ F.transpose(-1, -2)  # epipolar lines in image 2
    d2 = torch.sum(l2 * h2, dim=-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    l1 = h2 @ F
    d1 = torch.sum(l1 * h1, dim=-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    c1, c2 = d1 * inv_s2, d2 * inv_s2
    inlier = (c1 <= th) & (c2 <= th) & valid
    score = torch.sum(
        torch.where(valid & (c1 <= th), th_score - c1, 0.0)
        + torch.where(valid & (c2 <= th), th_score - c2, 0.0),
        dim=-1,
    )
    return score, inlier


def _check_homography(H, p1, p2, valid, sigma: float = 1.0):
    """Symmetric transfer score (Initializer::CheckHomography), th 5.991."""
    th = 5.991
    inv_s2 = 1.0 / sigma**2
    Hinv, _ = torch.linalg.inv_ex(H)

    def transfer(M, src, dst):
        q = _homog(src) @ M.transpose(-1, -2)
        q = q[..., :2] / (q[..., 2:3] + 1e-12)
        return torch.sum((q - dst) ** 2, dim=-1)

    c1 = transfer(Hinv, p2, p1) * inv_s2
    c2 = transfer(H, p1, p2) * inv_s2
    inlier = (c1 <= th) & (c2 <= th) & valid
    score = torch.sum(
        torch.where(valid & (c1 <= th), th - c1, 0.0) + torch.where(valid & (c2 <= th), th - c2, 0.0),
        dim=-1,
    )
    return score, inlier


def triangulate(T1, T2, uv1, uv2, K):
    """Linear DLT triangulation: the 4x4 system of two projection matrices,
    solved by eigh (Initializer::Triangulate).  T1, T2 (..., 4, 4) broadcast
    against uv1, uv2 (..., N, 2); returns (..., N, 3)."""
    P1 = (K @ T1[..., :3, :])[..., None, :, :]
    P2 = (K @ T2[..., :3, :])[..., None, :, :]
    rows = torch.broadcast_tensors(
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    )
    A = torch.stack(rows, dim=-2)
    x = _smallest_eigvec(A)
    w = x[..., 3]
    return x[..., :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)[..., None]


def _check_rt(R, t, uv1, uv2, valid, K, sigma2: float = 1.0):
    """Cheirality + reprojection + parallax check (Initializer::CheckRT),
    batched over hypotheses R (H, 3, 3), t (H, 3).

    Returns (n_good (H,), good (H, N), points (H, N, 3), parallax_cos (H,))."""
    T2 = geo.se3_from_Rt(R, t)
    T1 = torch.eye(4, dtype=R.dtype, device=R.device).expand_as(T2)
    pts = triangulate(T1, T2, uv1, uv2, K)
    finite = torch.all(torch.isfinite(pts), dim=-1)
    c2 = -torch.einsum("hji,hj->hi", R, t)
    r1 = pts
    r2 = pts - c2[:, None, :]
    cosp = torch.sum(r1 * r2, dim=-1) / (
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1) + 1e-12
    )
    z1 = pts[..., 2]
    pc2 = geo.se3_apply(T2[:, None], pts)
    z2 = pc2[..., 2]

    def reproj(p_cam, uv):
        q = p_cam @ K.T
        q = q[..., :2] / torch.where(torch.abs(q[..., 2:3]) < 1e-12, 1e-12, q[..., 2:3])
        return torch.sum((q - uv) ** 2, dim=-1)

    e1 = reproj(pts, uv1)
    e2 = reproj(pc2, uv2)
    th2 = 4.0 * sigma2
    good = valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998) & (e1 < th2) & (e2 < th2)
    cosp_good = torch.where(good, cosp, 1.0)
    n_good = torch.sum(good, dim=-1)
    k = torch.clamp(n_good, min=1).clamp(max=50)
    sorted_cos = torch.sort(cosp_good, dim=-1).values  # smallest cos = largest parallax
    idx = torch.clamp(k - 1, 0, cosp_good.shape[-1] - 1)
    parallax_cos = sorted_cos.gather(-1, idx[:, None])[:, 0]
    return n_good, good, pts, parallax_cos


def _decompose_essential(E):
    """E -> (R1, R2, t) (Initializer::DecomposeE)."""
    U, _, Vh = torch.linalg.svd(E)
    t = U[:, 2]
    t = t / (torch.linalg.vector_norm(t) + 1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    return R1, R2, t


def _decompose_homography(H, K):
    """Faugeras SVD decomposition -> 8 (R, t) hypotheses
    (Initializer::ReconstructH, Faugeras & Lustman 1988)."""
    Kinv, _ = torch.linalg.inv_ex(K)
    A = Kinv @ H @ K
    U, S, Vh = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = S[0], S[1], S[2]
    dev = H.device

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + 1e-12), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + 1e-12), min=0.0))
    sign_a = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev)
    sign_b = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev)
    sign_c = torch.tensor([1.0, -1.0, -1.0, 1.0], device=dev)
    x1s, x3s = sign_a * aux1, sign_b * aux3
    zero4, one4 = torch.zeros(4, device=dev), torch.ones(4, device=dev)

    def hyps(st, ct, sign_y, tp):
        # Rp = [[ct, 0, -st*sign_y... ]] per case, built row by row
        Rp = torch.stack([
            torch.stack([ct, zero4, st[0]], dim=-1),
            torch.stack([zero4, sign_y * one4, zero4], dim=-1),
            torch.stack([st[1], zero4, st[2]], dim=-1),
        ], dim=-2)
        R = s * (U @ Rp @ Vh)
        t = tp @ U.T
        return R, t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)

    # case d' > 0
    aux_st = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) / ((d1 + d3) * d2 + 1e-12)
    ctheta = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + 1e-12)
    st = sign_c * aux_st
    ct = ctheta * one4
    R_pos, t_pos = hyps((-st, st, ct), ct, 1.0, torch.stack([x1s, zero4, -x3s], dim=-1) * (d1 - d3))
    # case d' < 0
    aux_sp = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) / ((d1 - d3) * d2 + 1e-12)
    cphi = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2 + 1e-12)
    sp = sign_c * aux_sp
    cp = cphi * one4
    R_neg, t_neg = hyps((sp, sp, -cp), cp, -1.0, torch.stack([x1s, zero4, x3s], dim=-1) * (d1 + d3))
    return torch.cat([R_pos, R_neg]), torch.cat([t_pos, t_neg])


def initialize_two_view(uv1, uv2, valid, K, samples, sigma: float = 1.0) -> InitResult:
    """Two-view bootstrap from padded match arrays.

    uv1, uv2: (N, 2) matched undistorted pixels in frames 1 / 2; valid (N,)
    bool; K (3, 3); samples (S, 8) int64 RANSAC sample indices (on any
    device; see :func:`ransac_samples`)."""
    samples = samples.to(uv1.device)
    n1, T1n = _normalize(uv1, valid)
    n2, T2n = _normalize(uv2, valid)

    Fn = _fundamental_from_8(n1[samples], n2[samples])
    Fs = T2n.T @ Fn @ T1n
    Hn = _homography_from_8(n1[samples], n2[samples])
    T2n_inv, _ = torch.linalg.inv_ex(T2n)
    Hs = T2n_inv @ Hn @ T1n
    f_scores, f_inliers = _check_fundamental(Fs, uv1, uv2, valid, sigma)
    h_scores, h_inliers = _check_homography(Hs, uv1, uv2, valid, sigma)

    bf = torch.argmax(f_scores)
    bh = torch.argmax(h_scores)
    SF, SH = f_scores[bf], h_scores[bh]
    use_h = SH / (SH + SF + 1e-12) > 0.40  # Initializer.cc:112-115

    E = K.T @ Fs[bf] @ K
    R1, R2, tE = _decompose_essential(E)
    f_Rs = torch.stack([R1, R1, R2, R2])
    f_ts = torch.stack([tE, -tE, tE, -tE])
    h_Rs, h_ts = _decompose_homography(Hs[bh], K)
    # the F branch is padded to 8 so both have one shape; the copy is masked
    Rs = torch.where(use_h, h_Rs, torch.cat([f_Rs, f_Rs]))
    ts = torch.where(use_h, h_ts, torch.cat([f_ts, f_ts]))
    hyp_valid = torch.where(use_h, True, torch.arange(8, device=uv1.device) < 4)
    inl = torch.where(use_h, h_inliers[bh], f_inliers[bf])

    n_goods, goods, ptss, par_cos = _check_rt(Rs, ts, uv1, uv2, inl, K, sigma**2)
    n_goods = torch.where(hyp_valid, n_goods, -1)
    best = torch.argmax(n_goods)
    n_best = n_goods[best]
    n_inl = torch.sum(inl)
    second = torch.sort(n_goods).values[-2]
    ok = (
        (n_best > 0.7 * torch.clamp(n_inl, min=1))
        & (n_best >= 50)
        & (second < 0.75 * n_best)
        & (par_cos[best] < 0.99985)
    )
    T_21 = geo.se3_from_Rt(Rs[best], ts[best])
    return InitResult(ok=ok, T_21=T_21, points=ptss[best], good=goods[best], used_h=use_h)
