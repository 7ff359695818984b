"""The port's offline visualization (port of tests/test_viz.py) and the
engine's keyframe image dump, on the CPU.  These are host plotting, not
device work: they skip where matplotlib is not installed."""

import os

import numpy as np
import pytest
import torch

from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.io.config import ParameterCollection
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.system.engine import SlamEngine
from vslam_tpu_torch.viz import plots

pytest.importorskip("matplotlib")

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RNG = np.random.default_rng(33)


def test_frame_overlay(tmp_path):
    img = RNG.uniform(0, 255, (120, 160)).astype(np.float32)
    uv = RNG.uniform(10, 100, (30, 2)).astype(np.float32)
    has_lm = RNG.random(30) > 0.5
    valid = np.ones(30, bool)
    p = str(tmp_path / "overlay.png")
    plots.draw_frame_overlay(img, uv, has_lm, valid, proj_uv=uv + 3.0, path=p)
    assert os.path.getsize(p) > 1000


def test_topdown_plot(tmp_path):
    traj = np.cumsum(RNG.normal(0, 0.3, (50, 3)), axis=0)
    gt = traj + RNG.normal(0, 0.05, traj.shape)
    lms = RNG.uniform(-10, 10, (500, 3))
    p = str(tmp_path / "map.png")
    plots.plot_trajectory_topdown(traj, gt, landmarks=lms, path=p)
    assert os.path.getsize(p) > 5000


def test_engine_image_dump(tmp_path):
    """An engine with visualization.enable_image_dump writes one overlay a
    keyframe from its image ring, and dump_run the map plot."""
    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512, device="cpu")
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.border_pixels = 12
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.6
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.command_line.option_disable_relocalization = True
    cfg.visualization.enable_image_dump = True
    cfg.visualization.dump_directory = str(tmp_path / "viz")
    world = synthetic.make_world(cam, n_frames=6, n_points=1500, seed=40, step=0.3)
    eng = SlamEngine(cam, cfg, landmark_capacity=4096, device="cpu")
    for t in range(6):
        eng.process(*synthetic.render_frame(world, t)[:2])
    plots.dump_run(eng, cfg.visualization.dump_directory, ground_truth=world.poses)
    files = sorted(os.listdir(tmp_path / "viz"))
    overlays = [f for f in files if f.startswith("overlay_")]
    assert overlays == [f"overlay_{m.keyframe_index:06d}.png" for m in eng.world_map.local_maps]
    assert len(overlays) >= 2
    assert all(os.path.getsize(tmp_path / "viz" / f) > 1000 for f in overlays)
    assert "map_topdown.png" in files
    assert len(eng._viz_ring) <= 129
