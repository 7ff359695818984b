"""The benchmark's synthetic stereo world, in plain numpy: a frozen copy
of the port's io/synthetic.py (circle_trajectory, make_world,
render_frame), kept here so that a change to the program cannot change
the inputs or the ground truth it is judged by.

A procedurally textured 3D point world is rendered along a known
trajectory: each world point carries a fixed random 27x27 texture patch
(a bright 5x5 centre in a random surround), splatted at its projection
far-first over a low-amplitude noise background.  The poses the frames
are rendered from are the ground truth of every run.

generator.py renders the same frames on the card; tests hold the two
against each other at a small size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    baseline_m: float
    rows: int
    cols: int


@dataclass
class World:
    cam: Camera
    points_w: np.ndarray  # (M, 3) f32 world points
    textures: np.ndarray  # (M, P, P) f32 per-point patches
    poses: np.ndarray  # (T, 4, 4) f32 T_world_cam ground truth
    background: np.ndarray  # (H, W) f32 fixed noise background
    patch: int = 27


def circle_trajectory(n_frames: int, radius: float, laps: float = 1.0) -> np.ndarray:
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


def make_world(cam: Camera, poses: np.ndarray, n_points: int, scene_seed: int,
               seed: int, patch: int = 27) -> World:
    """The points' places from scene_seed (the scene a deployment drives
    through), their textures and the background from seed.  (The port's
    make_world draws all from one seed; with scene_seed == seed the points
    are the same.)"""
    rng = np.random.default_rng(scene_seed)
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
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 140, (n_points, patch, patch)).astype(np.float32)
    c = patch // 2
    tex[:, c - 2 : c + 3, c - 2 : c + 3] = rng.uniform(
        220, 255, (n_points, 5, 5)
    ).astype(np.float32)
    bg = rng.uniform(10, 30, (cam.rows, cam.cols)).astype(np.float32)
    return World(cam=cam, points_w=points.astype(np.float32),
                 textures=np.clip(tex, 0, 255), poses=poses, background=bg, patch=patch)


def camera_points(world: World, frame_idx: int) -> np.ndarray:
    """The world points in the camera frame of frame_idx, (M, 3) f32."""
    T_wc = world.poses[frame_idx]
    R = T_wc[:3, :3].T
    t = -R @ T_wc[:3, 3]
    return world.points_w @ R.T + t


def render_frame(world: World, frame_idx: int):
    """The (left, right) f32 (H, W) stereo pair of a trajectory frame."""
    cam = world.cam
    p_cam = camera_points(world, frame_idx)
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
        # Far first, near overwrites (a stable sort, so that equal depths
        # resolve alike on the card).
        cand = cand[np.argsort(-z[cand], kind="stable")]
        if len(cand) == 0:
            return img
        # Duplicate pixel indices resolve to the LAST (= nearest) write.
        dy = np.arange(-r, r + 1)
        rows = vi_all[cand][:, None, None] + dy[None, :, None]
        cols = ui_all[cand][:, None, None] + dy[None, None, :]
        img.reshape(-1)[(rows * W + cols).reshape(-1)] = world.textures[cand].reshape(-1)
        return img

    return render(False), render(True)
