"""Trajectory evaluation (ATE, RPE with rigid alignment) and the KITTI /
TUM trajectory files (port of vslam_tpu/eval/trajectory.py; numpy).

The files are byte-compatible with the reference writers
(world_map.cpp:184-258) and with the JAX package's: quaternions are
computed in f32 with a correctly rounded square root, as XLA computes
them, so the same poses give the same digits.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_tpu_torch.ops import lie


def rot_to_quat_f32(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotations -> (..., 4) f32 quaternions (w, x, y, z),
    XLA's digits (exact square root)."""
    R = torch.from_numpy(np.ascontiguousarray(R, np.float32))
    return lie.rot_to_quat(R, sqrt=lie.exact_sqrt).numpy()


def quat_to_rot_f32(q_wxyz: np.ndarray) -> np.ndarray:
    """(..., 4) quaternions (w, x, y, z) -> (..., 3, 3) f32 rotations."""
    return lie.quat_to_rot(torch.from_numpy(np.ascontiguousarray(q_wxyz, np.float32))).numpy()


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


def rpe(estimate: np.ndarray, ground_truth: np.ndarray, delta: int = 1):
    """Relative pose error over pose arrays (T, 4, 4).
    Returns (trans_rmse_per_step, rot_rmse_rad_per_step)."""
    if estimate.ndim != 3 or ground_truth.ndim != 3:
        raise ValueError("rpe takes (T, 4, 4) pose arrays")
    t_errs, r_errs = [], []
    for i in range(len(estimate) - delta):
        dE = np.linalg.inv(estimate[i]) @ estimate[i + delta]
        dG = np.linalg.inv(ground_truth[i]) @ ground_truth[i + delta]
        E = np.linalg.inv(dG) @ dE
        t_errs.append(np.linalg.norm(E[:3, 3]))
        r_errs.append(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))


def write_kitti(path: str, poses: np.ndarray) -> None:
    """KITTI format: 12 floats per line, row-major 3x4."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1)) + "\n")


def read_kitti(path: str) -> np.ndarray:
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4, dtype=np.float64), (len(rows), 1, 1))
    out[:, :3, :4] = rows
    return out


def write_tum(path: str, poses: np.ndarray, timestamps=None) -> None:
    """TUM format: `ts tx ty tz qx qy qz qw` per line."""
    if timestamps is None:
        timestamps = np.arange(len(poses), dtype=np.float64)
    q = rot_to_quat_f32(np.asarray(poses)[:, :3, :3])
    with open(path, "w") as f:
        for ts, T, (qw, qx, qy, qz) in zip(timestamps, poses, q):
            t = T[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")


def read_tum(path: str):
    """Returns (timestamps (T,), poses (T, 4, 4))."""
    data = np.atleast_2d(np.loadtxt(path))
    qxyzw = data[:, 4:8]
    out = np.tile(np.eye(4, dtype=np.float64), (len(data), 1, 1))
    out[:, :3, :3] = quat_to_rot_f32(np.concatenate([qxyzw[:, 3:4], qxyzw[:, :3]], axis=1))
    out[:, :3, 3] = data[:, 1:4]
    return data[:, 0], out


def associate_timestamps(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-neighbour timestamp association (reference
    trajectory_analyzer.cpp:161-205).  Returns (idx_a, idx_b)."""
    ia, ib = [], []
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        if abs(ts_b[j] - ta) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia), np.asarray(ib)
