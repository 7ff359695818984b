"""The port's benchmark workload: `bench.py`'s closed loop (bench.py:57-94)
on the port, shared by `python -m vslam_tpu_torch bench` and chip_smoke.py.

KITTI-resolution synthetic stereo (KITTI's calibration), a 128-frame
13 m-radius circle through 7,000 points (seed 0), the reference-default
closed loop (relocalization, pose graph, merging; bundle adjustment off)
with bench.py's settings, and its BA-enabled variant (windowed BA every
48 frames, bench.py:98-100).
"""

from __future__ import annotations

import copy
import time

import numpy as np

KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22, baseline_m=0.5372,
                 rows=376, cols=1241)
N_FRAMES = 128
RADIUS_M = 13.0
BA_EVERY_FRAMES = 48


def bench_config(parameter_collection):
    """The bench's configuration, open loop, as an instance of the given
    ParameterCollection class (the port's, or the JAX package's for
    chip_smoke_jax_reference.py)."""
    cfg = parameter_collection()
    cfg.framepoint_generation.capacity = 1024
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.world_map.minimum_distance_traveled_for_local_map = 1.5
    cfg.world_map.minimum_number_of_frames_for_local_map = 3
    cfg.local_map.maximum_number_of_landmarks = 512
    cfg.parallelism.frames_per_chunk = 32
    cfg.graph_optimization.enable_full_bundle_adjustment = False
    cfg.command_line.option_disable_relocalization = True
    return cfg


def closed_loop_config(cfg_open):
    """bench.py's closed-loop settings on top of the open-loop ones."""
    cfg = copy.deepcopy(cfg_open)
    cfg.command_line.option_disable_relocalization = False
    cfg.relocalization.preliminary_minimum_interspace_queries = 8
    cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
    cfg.relocalization.icp_minimum_number_of_inliers = 10
    cfg.relocalization.icp_minimum_inlier_ratio = 0.3
    cfg.graph_optimization.minimum_closure_residual_for_optimization_meters = 0.10
    cfg.graph_optimization.minimum_closure_residual_for_optimization_degrees = 0.5
    return cfg


def ba_closed_config(cfg_open):
    """bench.py's BA-enabled run: the closed loop with windowed bundle
    adjustment every BA_EVERY_FRAMES frames (bench.py:98-100)."""
    cfg = closed_loop_config(cfg_open)
    cfg.graph_optimization.enable_full_bundle_adjustment = True
    cfg.graph_optimization.number_of_frames_per_bundle_adjustment = BA_EVERY_FRAMES
    return cfg


def bench_world(cam, n_frames: int = N_FRAMES):
    """The bench's world (7000 points, seed 0) on the 128-frame circle and
    its first n_frames stereo frames."""
    from vslam_tpu_torch.io import synthetic

    poses = synthetic.circle_trajectory(N_FRAMES, radius=RADIUS_M)
    world = synthetic.make_world(cam, n_points=7000, seed=0, poses=poses)
    return world, [synthetic.render_frame(world, t)[:2] for t in range(n_frames)]


def _timed_run(cfg, world, frames, device) -> dict:
    """One engine over the frames, as bench.py times it: frames prestaged
    on the device, then process_prestaged and the final flush on the
    clock.  Returns ms/frame, ATE and the events."""
    import torch

    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.ops import camera as cam_ops
    from vslam_tpu_torch.system.engine import SlamEngine

    engine = SlamEngine(cam_ops.make_camera(**KITTI_CAM, device=device), cfg,
                        landmark_capacity=65536, device=device)
    handles = engine.tracker.prestage(frames)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    for h in handles:
        engine.process_prestaged(h)
    traj = engine.trajectory  # flushes the tracker and the closure pipeline
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    rmse, _, _ = traj_eval.ate_rmse(traj, world.poses[:len(frames)])
    rep = engine.report()
    out = {"ms_per_frame": 1e3 * wall / len(frames), "fps": len(frames) / wall,
           "ate_rmse_m": float(rmse)}
    out.update({k: rep[k] for k in ("n_local_maps", "n_closures", "n_optimizations",
                                    "n_merged_landmarks", "n_track_breaks", "n_ba_runs")})
    return out


def run_bench(device, n_frames: int = N_FRAMES) -> dict:
    """bench.py's two timed runs on the first n_frames frames: the closed
    loop, then its BA-enabled variant under "ba".  Returns the summary."""
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.ops import camera as cam_ops

    world, frames = bench_world(cam_ops.make_camera(**KITTI_CAM, device="cpu"), n_frames)
    cfg = bench_config(ParameterCollection)
    out = {"workload": "closed loop", "frames": n_frames}
    out.update(_timed_run(closed_loop_config(cfg), world, frames, device))
    out["ba"] = _timed_run(ba_closed_config(cfg), world, frames, device)
    return out
