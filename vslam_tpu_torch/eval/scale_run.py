"""KITTI-00-scale closed-loop run on synthetic imagery (port of
scripts/scale_run.py).

The reference's end-to-end regression runs the full app on KITTI
sequence 00: 4,541 frames with many late loop closures.  This is its
synthetic stand-in at KITTI resolution: a multi-lap circuit (2.5 laps of
a 65 m circle through 26,000 points) on which the map reaches hundreds
of local maps, the relocalization database tens of thousands of rows,
and closures keep firing deep into the run, with windowed BA every 128
frames.  Frames are rendered and prestaged in blocks of 128, both off
the clock; the clock runs over process_prestaged and the final flush.

    python -m vslam_tpu_torch.eval.scale_run [n_frames] [--device cpu]

run_scale(...) returns the JAX script's metrics dict (bench runs it at
1,024 frames).  It runs on the card unless the caller passes
device="cpu".
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from vslam_tpu_torch.eval.workloads import KITTI_CAM
from vslam_tpu_torch.utils.device import DEFAULT_DEVICE


def run_scale(
    n_frames: int = 2048,
    radius: float = 65.0,
    laps: float = 2.5,
    n_points: int = 26000,
    seed: int = 0,
    block: int = 128,
    landmark_capacity: int = 65536,
    enable_ba: bool = True,
    verbose: bool = False,
    config_overrides: dict | None = None,
    device=DEFAULT_DEVICE,
) -> dict:
    """The scale run over n_frames frames of the circuit; returns its
    metrics (ate_ok: ATE RMSE within 0.3% of the path length, or 0.5 m).
    config_overrides maps "group.key" to a value."""
    from vslam_tpu_torch.backend import pose_graph as pg
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.io import synthetic
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.loop import relocalizer as reloc_mod
    from vslam_tpu_torch.ops import camera as cam_ops
    from vslam_tpu_torch.system import ba_runner
    from vslam_tpu_torch.system.engine import SlamEngine

    cam = cam_ops.make_camera(**KITTI_CAM, device="cpu")
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 1024
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.world_map.minimum_distance_traveled_for_local_map = 2.5
    cfg.world_map.minimum_number_of_frames_for_local_map = 3
    cfg.relocalization.preliminary_minimum_interspace_queries = 20
    cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
    cfg.relocalization.icp_minimum_number_of_inliers = 10
    cfg.relocalization.icp_minimum_inlier_ratio = 0.3
    # The closure residual gate (off by default for reference parity),
    # on at KITTI scale, where closures fire on most keyframes.
    cfg.graph_optimization.minimum_closure_residual_for_optimization_meters = 0.10
    cfg.graph_optimization.minimum_closure_residual_for_optimization_degrees = 0.5
    cfg.local_map.maximum_number_of_landmarks = 512
    cfg.graph_optimization.enable_full_bundle_adjustment = enable_ba
    cfg.graph_optimization.number_of_frames_per_bundle_adjustment = 128
    for dotted, val in (config_overrides or {}).items():
        grp, key = dotted.split(".", 1)
        setattr(getattr(cfg, grp), key, val)
    poses = synthetic.circle_trajectory(n_frames, radius=radius, laps=laps)
    world = synthetic.make_world(cam, n_points=n_points, seed=seed, poses=poses)

    t_render = 0.0
    engine = SlamEngine(cam, cfg, landmark_capacity=landmark_capacity, device=device)
    # The warm-ups before the clock starts, as the JAX script runs them.
    pg.warm_hierarchical_buckets(device=engine.device)
    ba_runner.warm_windowed_ba(engine)
    reloc_mod.warm_icp_batches(cfg.relocalization, device=engine.device)
    t_proc = 0.0
    closures_after_150 = 0
    n0_closures = 0
    for start in range(0, n_frames, block):
        t0 = time.perf_counter()
        frames = [synthetic.render_frame(world, t)[:2]
                  for t in range(start, min(start + block, n_frames))]
        t_render += time.perf_counter() - t0
        # Uploads are off the clock too (the reference times process()
        # only, not image loading).
        handles = engine.tracker.prestage(frames)
        t0 = time.perf_counter()
        for h in handles:
            engine.process_prestaged(h)
        t_proc += time.perf_counter() - t0
        nc = len(engine.world_map.closures)
        if nc > n0_closures:
            closures_after_150 += sum(1 for c in engine.world_map.closures[n0_closures:]
                                      if c.query_id >= 150)
            n0_closures = nc
        if verbose:
            rep = engine.report_lite()
            print(f"[scale] frame {min(start + block, n_frames)}/{n_frames} "
                  f"maps={rep['n_local_maps']} closures={rep['n_closures']} "
                  f"opts={rep['n_optimizations']} db_rows={engine.relocalizer.n_rows}",
                  file=sys.stderr)
    t0 = time.perf_counter()
    engine._flush_tracker()
    t_proc += time.perf_counter() - t0

    est = np.stack(engine.tracker.trajectory)
    rmse, _, _ = traj_eval.ate_rmse(est, world.poses)
    rep = engine.report()
    path_len = float(np.sum(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)))
    table_rows = int(engine.tracker.table.valid.sum())
    # Closures must deliver: ATE within 0.3% of the multi-lap path.
    ate_ok = bool(rmse <= max(0.003 * path_len, 0.5))
    return {
        "n_frames": n_frames,
        "ate_ok": ate_ok,
        "fps": round(n_frames / t_proc, 2),
        "render_s": round(t_render, 1),
        "process_s": round(t_proc, 1),
        "ate_rmse_m": round(float(rmse), 3),
        "path_length_m": round(path_len, 1),
        "n_local_maps": rep["n_local_maps"],
        "n_closures": rep["n_closures"],
        "n_pose_graph_optimizations": rep["n_optimizations"],
        "n_ba_runs": rep["n_ba_runs"],
        "n_merged_landmarks": rep["n_merged_landmarks"],
        "reloc_db_rows": engine.relocalizer.n_rows,
        "landmark_table_live_rows": table_rows,
        "landmarks_spawned": rep["n_landmarks"],
        "tracking_breaks": rep["n_track_breaks"],
        "closures_after_map_150": closures_after_150,
        "stage_table": rep["stage_table"],
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m vslam_tpu_torch.eval.scale_run",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_frames", nargs="?", type=int, default=2048)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to run on (cuda, the default, or cpu)")
    args = p.parse_args(argv)
    print(json.dumps(run_scale(n_frames=args.n_frames, verbose=True, device=args.device),
                     indent=2))


if __name__ == "__main__":
    main()
