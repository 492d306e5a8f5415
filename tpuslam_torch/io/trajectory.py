"""Trajectory, cuboid and plane output and ATE evaluation, in numpy (port of
``tpuslam/io/trajectory.py``).

``save_tum`` writes the reference's SaveKeyFrameTrajectoryTUM format
(System.cc:341-380), ``save_kitti`` its SaveTrajectoryKITTI rows
(System.cc:496-549), ``save_cuboids`` / ``save_planes`` its
SaveCuboidOptimized / SavePlaneOptimized rows (System.cc:439-494);
``ate_rmse`` is Umeyama Sim3 (or SE3) alignment of the camera centres plus
the RMSE.
"""

from __future__ import annotations

import numpy as np


def R_to_quat(R) -> np.ndarray:
    """(x, y, z, w) unit quaternion of a rotation matrix, branch-free
    (Shepperd), in float32: the numpy twin of
    ``tpuslam/core/geometry.py:R_to_quat``."""
    R = np.asarray(R, np.float32)
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    one, lo = np.float32(1.0), np.float32(1e-12)
    qw = np.float32(0.5) * np.sqrt(np.maximum(one + tr, lo))
    qx = np.float32(0.5) * np.sqrt(np.maximum(one + m00 - m11 - m22, lo))
    qy = np.float32(0.5) * np.sqrt(np.maximum(one - m00 + m11 - m22, lo))
    qz = np.float32(0.5) * np.sqrt(np.maximum(one - m00 - m11 + m22, lo))
    qx = qx * np.sign(one if m21 - m12 == 0 else m21 - m12)
    qy = qy * np.sign(one if m02 - m20 == 0 else m02 - m20)
    qz = qz * np.sign(one if m10 - m01 == 0 else m10 - m01)
    q = np.array([qx, qy, qz, qw], np.float32)
    return q / (np.linalg.norm(q) + np.float32(1e-32))


def save_cuboids(path, minimal_vectors):
    """9-DoF minimal cuboid rows (System::SaveCuboidOptimized, System.cc:439-467)."""
    with open(path, "w") as f:
        for i, v in enumerate(minimal_vectors):
            f.write(str(i) + " " + " ".join(f"{x:.6f}" for x in np.asarray(v)) + "\n")


def save_planes(path, coeffs):
    """4-vector plane rows (System::SavePlaneOptimized, System.cc:469-494)."""
    with open(path, "w") as f:
        for i, c in enumerate(coeffs):
            f.write(str(i) + " " + " ".join(f"{x:.6f}" for x in np.asarray(c)) + "\n")


def se3_inv(T):
    """Inverse of a (4, 4) rigid transform, in float32."""
    T = np.asarray(T, np.float32)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def save_tum(path, stamps, poses_cw):
    """TUM format: ``stamp tx ty tz qx qy qz qw`` of the camera-to-world pose."""
    with open(path, "w") as f:
        for stamp, T_cw in zip(stamps, poses_cw):
            T_wc = se3_inv(T_cw)
            q = R_to_quat(T_wc[:3, :3])
            t = T_wc[:3, 3]
            f.write(
                f"{stamp} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_kitti(path, poses_cw):
    """KITTI format: 12 numbers per row of Twc (System.cc:496-549)."""
    with open(path, "w") as f:
        for T_cw in poses_cw:
            row = se3_inv(T_cw)[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


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


def ate_rmse(est_cw, gt_cw, with_scale=True):
    """ATE RMSE after Sim3 (mono) or SE3 alignment of camera centres; pairs
    with a non-finite pose are dropped.  Returns (rmse, per-pose errors)."""

    def centers(poses):
        out = []
        for T in poses:
            T = np.asarray(T, np.float64)
            out.append(-T[:3, :3].T @ T[:3, 3])
        return np.stack(out)

    c_est = centers(est_cw)
    c_gt = centers(gt_cw)
    keep = np.isfinite(c_est).all(axis=1) & np.isfinite(c_gt).all(axis=1)
    c_est, c_gt = c_est[keep], c_gt[keep]
    s, R, t = umeyama_alignment(c_est, c_gt, with_scale)
    aligned = (s * (R @ c_est.T)).T + t
    err = np.linalg.norm(aligned - c_gt, axis=1)
    return float(np.sqrt((err**2).mean())), err
