"""Plain numpy geometry of the checks: the Umeyama similarity alignment and
the ATE (a frozen copy of ``tpuslam_torch/io/trajectory.py``'s
``umeyama_alignment`` and ``ate_rmse``), the rotation drift, a whole-pose
similarity fit, and distances to the room's surfaces."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src, dst, with_scale=True):
    """Least-squares similarity transform: (s, R, t) with dst ~= s R src + t
    (Umeyama 1991)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / src.shape[0]
    s = (D * S.diagonal()).sum() / var_s if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def centers(poses_cw):
    """(F, 3) camera centres of world->camera poses."""
    out = []
    for T in poses_cw:
        T = np.asarray(T, np.float64)
        out.append(-T[:3, :3].T @ T[:3, 3])
    return np.stack(out)


def ate_rmse(est_cw, gt_cw, with_scale=True):
    """ATE RMSE after Sim3 (mono) or SE3 alignment of camera centres; pairs
    with a non-finite pose are dropped.  Returns (rmse, per-pose errors)."""
    c_est = centers(est_cw)
    c_gt = centers(gt_cw)
    keep = np.isfinite(c_est).all(axis=1) & np.isfinite(c_gt).all(axis=1)
    c_est, c_gt = c_est[keep], c_gt[keep]
    s, R, t = umeyama_alignment(c_est, c_gt, with_scale)
    aligned = (s * (R @ c_est.T)).T + t
    err = np.linalg.norm(aligned - c_gt, axis=1)
    return float(np.sqrt((err**2).mean())), err


def rotation_drift_deg(est_cw, gt_cw):
    """(F,) angle in degrees between each estimated orientation relative to
    the first one and the true relative orientation (no world alignment)."""
    E0 = np.asarray(est_cw[0], np.float64)[:3, :3]
    G0 = np.asarray(gt_cw[0], np.float64)[:3, :3]
    out = []
    for E, G in zip(est_cw, gt_cw):
        rel_e = np.asarray(E, np.float64)[:3, :3] @ E0.T
        rel_g = np.asarray(G, np.float64)[:3, :3] @ G0.T
        out.append(_angle_deg(rel_e, rel_g))
    return np.array(out)


def _angle_deg(A, B):
    """Degrees between two rotations by the chord |A - B|_F = 2 sqrt(2)
    sin(angle / 2), exact at small angles."""
    return float(np.degrees(2.0 * np.arcsin(min(np.linalg.norm(A - B) / (2.0 * np.sqrt(2.0)), 1.0))))


def rpe_rot_deg(est_cw, gt_cw, skip=()):
    """(F-1,) degrees between each estimated frame-to-frame rotation and the
    true one, over consecutive poses (no world alignment, no scale); a pair
    whose index (of its first pose) is in ``skip`` reads 0."""
    out = []
    for i, ((E0, E1), (G0, G1)) in enumerate(zip(zip(est_cw, est_cw[1:]), zip(gt_cw, gt_cw[1:]))):
        if i in skip:
            out.append(0.0)
            continue
        rel_e = np.asarray(E1, np.float64)[:3, :3] @ np.asarray(E0, np.float64)[:3, :3].T
        rel_g = np.asarray(G1, np.float64)[:3, :3] @ np.asarray(G0, np.float64)[:3, :3].T
        out.append(_angle_deg(rel_e, rel_g))
    return np.array(out)


def rpe_dir_deg(est_cw, gt_cw):
    """(F-1,) degrees between the direction of each estimated frame-to-frame
    translation (the second camera's view of the first's motion, so no
    world alignment and no scale) and the true one; an estimated motion of
    zero reads 180."""
    out = []
    for (E0, E1), (G0, G1) in zip(zip(est_cw, est_cw[1:]), zip(gt_cw, gt_cw[1:])):
        te = _relative_t(E0, E1)
        tg = _relative_t(G0, G1)
        ne, ng = np.linalg.norm(te), np.linalg.norm(tg)
        if not (ne > 0 and ng > 0 and np.isfinite(ne)):
            out.append(180.0)
            continue
        out.append(float(np.degrees(np.arccos(np.clip(te @ tg / (ne * ng), -1.0, 1.0)))))
    return np.array(out)


def _relative_t(T0, T1):
    """Translation of T1 T0^-1 (world->camera poses), as the second camera
    sees the first's centre: exactly zero for two equal poses."""
    c0, c1 = centers([T0, T1])
    return np.asarray(T1, np.float64)[:3, :3] @ (c0 - c1)


def pose_alignment(est_cw, gt_cw):
    """(s, R, t) with X_gt ~= s R X_est + t from whole poses: R the rotation
    nearest the sum of the camera-to-world orientation pairs, then s and t
    by least squares on the camera centres.  Unlike a fit of the centres
    alone, it holds when the centres lie near a line."""
    M = np.zeros((3, 3))
    for E, G in zip(est_cw, gt_cw):
        M += np.asarray(G, np.float64)[:3, :3].T @ np.asarray(E, np.float64)[:3, :3]
    U, _, Vt = np.linalg.svd(M)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ S @ Vt
    c_e, c_g = centers(est_cw), centers(gt_cw)
    mu_e, mu_g = c_e.mean(axis=0), c_g.mean(axis=0)
    xe = (R @ (c_e - mu_e).T).T
    s = float((xe * (c_g - mu_g)).sum() / max((xe**2).sum(), 1e-300))
    return s, R, mu_g - s * R @ mu_e


def surface_distance(points, planes, box_centers, box_halfs, box_yaws):
    """(P,) distance of each world point to the nearest surface of a room
    (``planes`` (6, 4), inward [n, d]) holding yaw-rotated boxes."""
    p = np.asarray(points, np.float64)
    pl = np.asarray(planes, np.float64)
    best = np.abs(p @ pl[:, :3].T + pl[:, 3]).min(axis=1)
    for c, h, yaw in zip(box_centers, box_halfs, box_yaws):
        cs, sn = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[cs, -sn, 0.0], [sn, cs, 0.0], [0.0, 0.0, 1.0]])
        q = np.abs((p - np.asarray(c, np.float64)) @ Rz)  # box frame
        outside = np.linalg.norm(np.maximum(q - h, 0.0), axis=1)
        inside = np.maximum(np.min(h - q, axis=1), 0.0)
        best = np.minimum(best, np.where(outside > 0, outside, inside))
    return best


def plane_errors(coefs, s, R, t, planes):
    """Per estimated world plane [n, d] (n.X + d = 0), carried into the
    ground truth's frame by X' = s R X + t: (degrees, metres) to the room
    plane it lies nearest, either orientation, by offset plus 3 m per
    radian of normal angle."""
    out = []
    pl = np.asarray(planes, np.float64)
    for c in np.asarray(coefs, np.float64):
        n = R @ c[:3]
        norm = np.linalg.norm(n)
        n, d = n / norm, (s * c[3] - n @ t) / norm
        best = None
        for sign in (1.0, -1.0):
            ang = np.arccos(np.clip(pl[:, :3] @ (sign * n), -1.0, 1.0))
            off = np.abs(sign * d - pl[:, 3])
            i = int(np.argmin(off + 3.0 * ang))
            if best is None or off[i] + 3.0 * ang[i] < best[0]:
                best = (off[i] + 3.0 * ang[i], float(np.degrees(ang[i])), float(off[i]))
        out.append(best[1:])
    return out


def ate_by_epoch(est_cw, gt_cw, epochs):
    """ATE RMSE of poses whose map changed scale on the way: a Sim3 fit of
    the camera centres per epoch (each epoch's poses from ``epochs``, an
    epoch label or None per pose, 3 poses or more), each pose's error the
    least over the fits.  One epoch is the plain ATE's fit."""
    c_e, c_g = centers(est_cw), centers(gt_cw)
    labels = sorted({e for e in epochs if e is not None})
    fits = []
    for e in labels:
        sel = [i for i, x in enumerate(epochs) if x == e]
        if len(sel) >= 3:
            fits.append(umeyama_alignment(c_e[sel], c_g[sel], True))
    if not fits:
        fits.append(umeyama_alignment(c_e, c_g, True))
    err = np.min([np.linalg.norm((s * (R @ c_e.T)).T + t - c_g, axis=1) for s, R, t in fits], axis=0)
    return float(np.sqrt((err**2).mean())), err
