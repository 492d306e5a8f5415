"""Schur-complement solver for the reduced camera system (port of
``tpuslam/graph/schur.py``).

The landmark blocks are a batch of 3x3s, inverted in closed form; the reduced
(pose) system is one dense matrix.  The reduction is one (D x 3P) x (3P x D)
matmul in float32 (TF32 is off for the whole package) and the reduced solve
uses ``solve_ex`` without its error check, so nothing here waits for the
device: a singular system gives non-finite steps that LM rejects.
"""

from __future__ import annotations

import torch


def inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def schur_solve(H_cc, H_cl, H_ll, b_c, b_l, lam, free_c, point_active):
    """Solve the damped normal equations by eliminating the point blocks.

    H_cc (D, D), H_cl (D, P, 3), H_ll (P, 3, 3), b_c (D,), b_l (P, 3); ``lam``
    the LM damping (multiplicative on the diagonal); ``free_c`` (D,) 1.0 for
    free reduced dims; ``point_active`` (P,) 1.0 for optimized points.
    Returns (delta_c (D,), delta_l (P, 3))."""
    D = H_cc.shape[0]
    P = H_ll.shape[0]
    mask2 = free_c[:, None] * free_c[None, :]
    H_cc = H_cc * mask2 + torch.diag(1.0 - free_c)
    b_c = b_c * free_c
    H_cl = H_cl * free_c[:, None, None] * point_active[None, :, None]

    eye3 = torch.eye(3, dtype=H_ll.dtype, device=H_ll.device)
    H_ll_damped = H_ll + lam * (H_ll * eye3) + (1.0 - point_active)[:, None, None] * eye3 + 1e-6 * eye3
    b_l = b_l * point_active[:, None]
    Hll_inv = inv3x3(H_ll_damped)

    eye_d = torch.eye(D, dtype=H_cc.dtype, device=H_cc.device)
    H_cc_damped = H_cc + lam * torch.diag(torch.diagonal(H_cc)) + 1e-6 * eye_d
    tmp2 = torch.einsum("dpi,pij->dpj", H_cl, Hll_inv).reshape(D, P * 3)
    Hcl2 = H_cl.reshape(D, P * 3)
    S = H_cc_damped - tmp2 @ Hcl2.T
    rhs = b_c - tmp2 @ b_l.reshape(P * 3)
    delta_c = torch.linalg.solve_ex(S, rhs, check_errors=False)[0] * free_c
    Hlc_dc = (delta_c @ Hcl2).reshape(P, 3)
    delta_l = torch.einsum("pij,pj->pi", Hll_inv, b_l - Hlc_dc) * point_active[:, None]
    return delta_c, delta_l
