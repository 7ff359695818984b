"""Trajectory evaluation: ATE with rigid alignment, and the KITTI writer
(port of the slice's part of vslam_tpu/eval/trajectory.py; numpy)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (+scale) transform aligning x onto y.
    x, y: (N, 3).  Returns (R, t, s) with y ~ s * R @ x + t."""
    mu_x, mu_y = x.mean(0), y.mean(0)
    xc, yc = x - mu_x, y - mu_y
    U, d, Vt = np.linalg.svd(yc.T @ xc / len(x))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / ((xc**2).sum() / len(x))) if with_scale else 1.0
    return R, mu_y - s * R @ mu_x, s


def ate_rmse(estimate: np.ndarray, ground_truth: np.ndarray, align: bool = True,
             with_scale: bool = False):
    """Absolute trajectory error RMSE over (T, 4, 4) or (T, 3) inputs.
    Returns (rmse, aligned_positions, raw_rmse)."""
    p_est = estimate[:, :3, 3] if estimate.ndim == 3 else estimate
    p_gt = ground_truth[:, :3, 3] if ground_truth.ndim == 3 else ground_truth
    if p_est.shape != p_gt.shape:
        raise ValueError(f"trajectory shapes differ: {p_est.shape} vs {p_gt.shape}")
    raw = float(np.sqrt(np.mean(np.sum((p_est - p_gt) ** 2, axis=1))))
    if not align:
        return raw, p_est, raw
    R, t, s = umeyama_alignment(p_est, p_gt, with_scale)
    p_al = (s * (R @ p_est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((p_al - p_gt) ** 2, axis=1)))), p_al, raw


def write_kitti(path: str, poses: np.ndarray) -> None:
    """KITTI format: 12 floats per line, row-major 3x4."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1)) + "\n")
