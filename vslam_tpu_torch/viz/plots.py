"""Offline visualization: frame overlays and map/trajectory plots (port of
vslam_tpu/viz/plots.py).

The reference renders live Qt/OpenGL viewers (src/visualization/
image_viewer.cpp, map_viewer.cpp); real-time display is a non-goal
(reference README.md:7), so the port writes the same content as image
files: framepoint overlays colored by landmark state with track lines
(image_viewer.cpp:84-155 parity) and a top-down map view with the
trajectory, keyframes and landmarks (map_viewer.cpp:107-143 parity).

matplotlib is optional: it is imported inside the functions, and
`require_matplotlib` raises an ImportError naming it, so a run that asks
for dumps fails before it starts where matplotlib is missing.
"""

from __future__ import annotations

import os

import numpy as np


def require_matplotlib():
    """matplotlib.pyplot on the Agg backend; ImportError naming matplotlib
    where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("image dumps (visualization.enable_image_dump, --dump) need "
                          "matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_frame_overlay(img: np.ndarray, uv: np.ndarray, has_landmark: np.ndarray,
                       valid: np.ndarray, proj_uv: np.ndarray | None = None,
                       path: str | None = None):
    """Framepoint overlay: green = landmark-backed, blue = tracked point,
    thin lines to predicted projections (the adaptive-window debug view)."""
    plt = require_matplotlib()
    fig, ax = plt.subplots(figsize=(img.shape[1] / 100, img.shape[0] / 100), dpi=100)
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    v = np.asarray(valid)
    lm = np.asarray(has_landmark) & v
    pt = v & ~lm
    ax.scatter(uv[pt, 0], uv[pt, 1], s=12, facecolors="none", edgecolors="#4477ff",
               linewidths=0.8)
    ax.scatter(uv[lm, 0], uv[lm, 1], s=14, facecolors="none", edgecolors="#33cc55",
               linewidths=1.0)
    if proj_uv is not None:
        for a, b in zip(uv[v], np.asarray(proj_uv)[v]):
            ax.plot([a[0], b[0]], [a[1], b[1]], color="#ffaa00", linewidth=0.5)
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.axis("off")
    fig.tight_layout(pad=0)
    if path:
        fig.savefig(path)
        plt.close(fig)
        return None
    return fig


def plot_trajectory_topdown(estimate: np.ndarray, ground_truth: np.ndarray | None = None,
                            keyframes: np.ndarray | None = None,
                            landmarks: np.ndarray | None = None, path: str | None = None):
    """Top-down (x-z) map view: trajectory, keyframes, landmark cloud."""
    plt = require_matplotlib()
    fig, ax = plt.subplots(figsize=(8, 8))
    if landmarks is not None and len(landmarks):
        ax.scatter(landmarks[:, 0], landmarks[:, 2], s=1, c="#bbbbbb", label="landmarks")
    p = estimate[:, :3, 3] if estimate.ndim == 3 else estimate
    ax.plot(p[:, 0], p[:, 2], "-", color="#4477ff", linewidth=1.5, label="estimate")
    if ground_truth is not None:
        g = ground_truth[:, :3, 3] if ground_truth.ndim == 3 else ground_truth
        ax.plot(g[:, 0], g[:, 2], "--", color="#33cc55", linewidth=1.2, label="ground truth")
    if keyframes is not None and len(keyframes):
        k = keyframes[:, :3, 3] if keyframes.ndim == 3 else keyframes
        ax.scatter(k[:, 0], k[:, 2], s=25, marker="^", color="#cc3344", label="keyframes")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend(loc="best", fontsize=8)
    ax.grid(alpha=0.3)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return None
    return fig


def dump_run(engine, out_dir: str, ground_truth: np.ndarray | None = None):
    """Write the standard post-run artifact set for an engine."""
    os.makedirs(out_dir, exist_ok=True)
    traj = engine.trajectory  # flushes the device pipeline
    table = engine.tracker.table
    lms = table.xyz_w[table.valid].cpu().numpy()
    maps = engine.world_map.local_maps
    kfs = np.stack([m.T_world_kf for m in maps]) if maps else None
    plot_trajectory_topdown(traj, ground_truth, keyframes=kfs, landmarks=lms,
                            path=os.path.join(out_dir, "map_topdown.png"))
    return out_dir
