"""Synthetic stereo and RGB-D sequences with exact ground truth (port of the
parts of vslam_tpu/io/synthetic.py; host-side numpy).

A procedurally textured 3D point world rendered along a known trajectory
gives stereo pairs + ground-truth poses.  Each world point carries a
fixed random texture patch (bright 5x5 center + random surround) splatted
at its projection with far-first ordering over a low-amplitude noise
background.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.ops import lie


@dataclass
class SyntheticWorld:
    cam: cam_ops.CameraParams
    points_w: np.ndarray  # (M, 3) world points
    textures: np.ndarray  # (M, P, P) per-point patches
    poses: np.ndarray  # (T, 4, 4) T_world_cam ground truth
    background: np.ndarray  # (H, W) fixed noise background
    patch: int = 27


def corridor_trajectory(n_frames: int, step: float = 0.5, turn_rate: float = 0.004):
    """Forward motion along +z with gentle yaw — KITTI-like."""
    poses = [np.eye(4, dtype=np.float32)]
    for t in range(1, n_frames):
        yaw = turn_rate * np.sin(t * 0.05)
        xi = torch.tensor([0.0, 0.0, step, 0.0, yaw, 0.0], dtype=torch.float32)
        dT = lie.exp_se3(xi).numpy()
        poses.append((poses[-1] @ dT).astype(np.float32))
    return np.stack(poses)


def circle_trajectory(n_frames: int, radius: float = 8.0, laps: float = 1.0):
    """Closed loop: the camera moves on a circle facing the tangent."""
    poses = []
    for k in range(n_frames):
        ang = 2 * np.pi * laps * k / n_frames
        c, s = np.cos(ang), np.sin(ang)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T[:3, 3] = [radius * (1 - c), 0.0, radius * s]
        poses.append(T)
    return np.stack(poses)


def make_world(
    cam: cam_ops.CameraParams,
    n_frames: int = 60,
    n_points: int = 4000,
    seed: int = 0,
    step: float = 0.5,
    turn_rate: float = 0.004,
    patch: int = 27,
    poses: np.ndarray | None = None,
) -> SyntheticWorld:
    rng = np.random.default_rng(seed)
    if poses is None:
        poses = corridor_trajectory(n_frames, step, turn_rate)
    n_frames = len(poses)
    centers = poses[rng.integers(0, n_frames, n_points)][:, :3, 3]
    offs = np.stack(
        [
            rng.uniform(-20, 20, n_points),
            rng.uniform(-4, 6, n_points),
            rng.uniform(3, 45, n_points),
        ],
        axis=1,
    )
    Rs = poses[rng.integers(0, n_frames, n_points)][:, :3, :3]
    points = centers + np.einsum("nij,nj->ni", Rs, offs)
    # One dominant corner per landmark (repeatable detection) inside a
    # random texture filling the BRIEF footprint (distinctive description).
    tex = rng.uniform(0, 140, (n_points, patch, patch)).astype(np.float32)
    c = patch // 2
    tex[:, c - 2 : c + 3, c - 2 : c + 3] = rng.uniform(
        220, 255, (n_points, 5, 5)
    ).astype(np.float32)
    bg = rng.uniform(10, 30, (cam.rows, cam.cols)).astype(np.float32)
    return SyntheticWorld(
        cam=cam,
        points_w=points.astype(np.float32),
        textures=np.clip(tex, 0, 255),
        poses=poses,
        background=bg,
        patch=patch,
    )


def render_frame(world: SyntheticWorld, frame_idx: int):
    """Render the (left, right) stereo pair for a trajectory frame.
    Returns (img_l, img_r) f32 (H, W) and the camera-frame points (M, 3)."""
    cam = world.cam
    T_wc = world.poses[frame_idx]
    R = T_wc[:3, :3].T
    t = -R @ T_wc[:3, 3]
    p_cam = world.points_w @ R.T + t
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    b = float(cam.baseline_m)

    def render(shift_baseline: bool):
        img = world.background.copy()
        z = p_cam[:, 2]
        vis = z > 0.5
        u = fx * p_cam[:, 0] / np.where(vis, z, 1.0) + cx
        if shift_baseline:
            u = u - fx * b / np.where(vis, z, 1.0)
        v = fy * p_cam[:, 1] / np.where(vis, z, 1.0) + cy
        r = world.patch // 2
        H, W = img.shape
        ui_all = np.round(u).astype(np.int64)
        vi_all = np.round(v).astype(np.int64)
        cand = np.flatnonzero(
            vis
            & (ui_all >= r) & (ui_all < W - r)
            & (vi_all >= r) & (vi_all < H - r)
        )
        cand = cand[np.argsort(-z[cand])]  # far first; near overwrites
        if len(cand) == 0:
            return img
        # Duplicate pixel indices resolve to the LAST (= nearest) write.
        dy = np.arange(-r, r + 1)
        rows = vi_all[cand][:, None, None] + dy[None, :, None]
        cols = ui_all[cand][:, None, None] + dy[None, None, :]
        img.reshape(-1)[(rows * W + cols).reshape(-1)] = world.textures[cand].reshape(-1)
        return img

    return render(False), render(True), p_cam.astype(np.float32)


def render_depth_frame(world: SyntheticWorld, frame_idx: int):
    """Render (intensity, depth_m) for RGB-D mode: the left image of
    render_frame, and a depth map exact on the rendered patches (nearest
    point wins) and 0 (invalid) elsewhere."""
    cam = world.cam
    img_l, _, p_cam = render_frame(world, frame_idx)
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    depth = np.zeros_like(img_l)
    z = p_cam[:, 2]
    vis = z > 0.5
    u = fx * p_cam[:, 0] / np.where(vis, z, 1.0) + cx
    v = fy * p_cam[:, 1] / np.where(vis, z, 1.0) + cy
    r = world.patch // 2
    H, W = depth.shape
    zbuf = np.full_like(depth, np.inf)
    for i in np.argsort(-z):
        if not vis[i]:
            continue
        ui, vi = int(round(u[i])), int(round(v[i]))
        if ui < r or ui >= W - r or vi < r or vi >= H - r:
            continue
        if z[i] >= zbuf[vi, ui]:
            continue
        depth[vi - r:vi + r + 1, ui - r:ui + r + 1] = z[i]
        zbuf[vi - r:vi + r + 1, ui - r:ui + r + 1] = z[i]
    return img_l, depth
