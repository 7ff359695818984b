"""The port's benchmark: `bench.py` on the port, shared by
`python -m vslam_tpu_torch bench` and chip_smoke.py.

KITTI-resolution synthetic stereo (KITTI's calibration), a 128-frame
13 m-radius circle through 7,000 points (seed 0), the reference-default
closed loop (relocalization, pose graph, merging; bundle adjustment off)
with bench.py's settings, and its BA-enabled variant (windowed BA every
48 frames).  run_bench runs them as bench.py does: a warm engine over
the BA-enabled run and the four warm-ups first (pose-graph buckets, BA,
ICP buckets, and the DB query programs up to the warm engine's prefix),
then the timed engines, which replay the programs the warm engine and
the warm-ups captured (fused.make_frame_step, the ICP buckets and the
query programs are one per process); then
the open-loop tracker-only rates, the device-only rate, the stage
ms/frame and the KITTI-00-scale run (eval/scale_run.py).
"""

from __future__ import annotations

import copy
import gc
import time
from collections import Counter

import numpy as np

from vslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22, baseline_m=0.5372,
                 rows=376, cols=1241)
N_FRAMES = 128
RADIUS_M = 13.0
BA_EVERY_FRAMES = 48
# ProSLAM's upper bound on one CPU core, the baseline of bench.py's
# vs_baseline.
BASELINE_FPS = 40.0
SCALE_FRAMES = 1024


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


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_events() -> Counter:
    """The programs' eager runs, captures and replays so far (CUDA): the
    tracker's ("eager", ...), the closure ICP's ("icp eager", ...), the
    relocalizer's DB query's ("query eager", ...), the pose graph's ("pose
    graph eager", ..., "pose graph distribute eager", ...), the windowed
    BA's ("ba eager", ...) and the modular tracker's ("modular front-end
    eager", "modular track replay", ...)."""
    from vslam_tpu_torch.backend import ba
    from vslam_tpu_torch.backend import pose_graph as pg
    from vslam_tpu_torch.loop import relocalizer as rl
    from vslam_tpu_torch.tracking import fused, modular

    out = Counter(fused.EVENTS)
    for prefix, events in (("icp", rl.EVENTS), ("query", rl.QUERY_EVENTS),
                           ("pose graph", pg.EVENTS), ("ba", ba.EVENTS),
                           ("modular", modular.EVENTS)):
        out.update({f"{prefix} {k}": v for k, v in events.items()})
    return out


def _engine(cfg, device):
    from vslam_tpu_torch.ops import camera as cam_ops
    from vslam_tpu_torch.system.engine import SlamEngine

    return SlamEngine(cam_ops.make_camera(**KITTI_CAM, device="cpu"), cfg,
                      landmark_capacity=65536, device=device)


def _timed_run(cfg, world, frames, device) -> dict:
    """One fresh engine over the frames, as bench.py times it: frames
    prestaged on the device off the clock, then process_prestaged and the
    final flush on it.  Returns ms/frame (and of the first handle), ATE,
    the events, the report, and the programs' eager frames, captures and
    replays inside the run."""
    from vslam_tpu_torch.eval import trajectory as traj_eval

    engine = _engine(cfg, device)
    handles = engine.tracker.prestage(frames)
    _sync(device)
    events0 = program_events()
    t0 = time.perf_counter()
    first = None
    for h in handles:
        engine.process_prestaged(h)
        if first is None:
            first = (time.perf_counter() - t0) / len(h)
    engine._flush_tracker()
    _sync(device)
    wall = time.perf_counter() - t0
    events = program_events() - events0
    rmse, _, _ = traj_eval.ate_rmse(np.stack(engine.tracker.trajectory),
                                    world.poses[:len(frames)])
    rep = engine.report()
    return {"ms_per_frame": 1e3 * wall / len(frames), "fps": len(frames) / wall,
            "first_chunk_ms_per_frame": 1e3 * first, "ate_rmse_m": float(rmse),
            "closures": [[c.query_id, c.reference_id] for c in engine.world_map.closures],
            "program_events": dict(events), "report": rep}


def _tracker_only_fps(cam, frames, device, split: bool) -> float:
    """The open-loop tracker alone (bench.py's tracker_fps_run): the
    default configuration at capacity 1024, fused or with the split
    front-end, warmed on its first handle, the rest timed."""
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.tracking.tracker import FusedPoseTracker

    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 1024
    cfg.tracking.batch_frontend = split
    tracker = FusedPoseTracker(cam, cfg, landmark_capacity=65536, device=device)
    handles = tracker.prestage(frames)
    n_timed = sum(len(h) for h in handles[1:])
    assert n_timed > 0, "open-loop bench: timed frame set is empty"
    tracker.compute_prestaged(handles[0])
    tracker.flush()
    t0 = time.perf_counter()
    for h in handles[1:]:
        tracker.compute_prestaged(h)
    tracker.flush()
    fps = n_timed / (time.perf_counter() - t0)
    assert fps > 0.0
    return fps


def _device_only(cam, cfg, frames, device) -> tuple[float, float]:
    """bench.py's device-only rate: every handle but the first stepped
    back to back with no drain and one sync at the end (on the card, the
    frames' replays).  Returns (frames/s, ms/frame)."""
    from vslam_tpu_torch.tracking.tracker import FusedPoseTracker

    tracker = FusedPoseTracker(cam, copy.deepcopy(cfg), landmark_capacity=65536,
                               device=device)
    handles = tracker.prestage(frames)
    tracker._dispatch_staged(handles[0])
    _sync(device)
    n = sum(len(h) for h in handles[1:])
    assert n > 0
    t0 = time.perf_counter()
    for h in handles[1:]:
        tracker._dispatch_staged(h)
    _sync(device)
    dt = time.perf_counter() - t0
    return n / dt, 1e3 * dt / n


def run_bench(device=DEFAULT_DEVICE, n_frames: int = N_FRAMES) -> dict:
    """bench.py on the port over the first n_frames frames; returns
    bench.py's JSON line as a dict (metric, value, unit, vs_baseline,
    extra).  The scale run's failure is raised, not reported in extra.

    extra carries bench.py's keys and the port's own: the warm-up's
    seconds, each timed run's ms/frame and that of its first handle,
    merged landmarks, closures (query, reference), and the programs'
    eager frames, captures and replays inside each timed run."""
    from vslam_tpu_torch.backend import pose_graph as pg
    from vslam_tpu_torch.eval import scale_run
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.loop import relocalizer as rl
    from vslam_tpu_torch.ops import camera as cam_ops
    from vslam_tpu_torch.system import ba_runner
    from vslam_tpu_torch.utils import log

    device = resolve_device(device)
    cam = cam_ops.make_camera(**KITTI_CAM, device="cpu")
    world, frames = bench_world(cam, n_frames)
    cfg_open = bench_config(ParameterCollection)
    cfg, cfg_ba = closed_loop_config(cfg_open), ba_closed_config(cfg_open)

    # Warm-up: one engine over the BA-enabled run (every program either
    # timed run needs), then the four warm-ups.
    t0 = time.perf_counter()
    warm = _engine(cfg_ba, device)
    ba_runner.warm_windowed_ba(warm)
    for h in warm.tracker.prestage(frames):
        warm.process_prestaged(h)
    warm._flush_tracker()
    pg.warm_hierarchical_buckets(device=device)
    rl.warm_icp_batches(cfg.relocalization, device=device)
    reloc = warm.relocalizer
    rl.warm_query_programs(cfg.relocalization, reloc.QUERY_CAP, reloc._active_prefix(),
                           reloc.capacity, device)
    del warm
    gc.collect()
    _sync(device)
    warmup_s = time.perf_counter() - t0

    # The chronometers are global: the timed runs' stage tables start empty.
    log.chronometers.clear()
    closed = _timed_run(cfg, world, frames, device)
    log.chronometers.clear()
    ba = _timed_run(cfg_ba, world, frames, device)

    tracker_fps = _tracker_only_fps(cam, frames, device, split=False)
    split_fps = _tracker_only_fps(cam, frames, device, split=True)
    device_fps, device_ms = _device_only(cam, cfg, frames, device)

    scale_out = scale_run.run_scale(n_frames=SCALE_FRAMES, device=device)
    scale_out.pop("stage_table", None)

    rep = closed["report"]
    stage_ms = {k: round(1e3 * v["seconds"] / n_frames, 3)
                for k, v in rep["stage_table"].items()}
    stage_ms["frame_step_dispatch"] = round(
        1e3 * rep["stage_seconds"].get("frame_step", 0.0) / n_frames, 3)
    fps = closed["fps"]
    return {
        "metric": "closed_loop_frames_per_second",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "extra": {
            "ate_rmse_m": round(closed["ate_rmse_m"], 4),
            "ba_enabled": False,
            "fps_with_ba": round(ba["fps"], 2),
            "ate_rmse_m_with_ba": round(ba["ate_rmse_m"], 4),
            "n_ba_runs": ba["report"]["n_ba_runs"],
            "loop_length_m": round(2 * np.pi * RADIUS_M, 1),
            "n_frames": n_frames,
            "resolution": f"{KITTI_CAM['rows']}x{KITTI_CAM['cols']}",
            "backend": device.type,
            "n_local_maps": rep["n_local_maps"],
            "n_closures": rep["n_closures"],
            "n_pose_graph_optimizations": rep["n_optimizations"],
            "n_recovered_landmarks": rep["n_recovered_landmarks"],
            "tracking_breaks": rep["n_track_breaks"],
            "tracker_only_fps": round(tracker_fps, 2),
            "tracker_split_frontend_fps": round(split_fps, 2),
            "device_compute_fps": round(device_fps, 2),
            "device_ms_per_frame": round(device_ms, 3),
            "stage_ms_per_frame": stage_ms,
            "kitti00_scale_run": scale_out,
            "warmup_s": round(warmup_s, 3),
            "ms_per_frame": round(closed["ms_per_frame"], 3),
            "ms_per_frame_with_ba": round(ba["ms_per_frame"], 3),
            "first_chunk_ms_per_frame": round(closed["first_chunk_ms_per_frame"], 3),
            "first_chunk_ms_per_frame_with_ba": round(ba["first_chunk_ms_per_frame"], 3),
            "n_merged_landmarks": rep["n_merged_landmarks"],
            "n_merged_landmarks_with_ba": ba["report"]["n_merged_landmarks"],
            "tracking_breaks_with_ba": ba["report"]["n_track_breaks"],
            "n_local_maps_with_ba": ba["report"]["n_local_maps"],
            "closures": closed["closures"],
            "closures_with_ba": ba["closures"],
            "program_events": closed["program_events"],
            "program_events_with_ba": ba["program_events"],
        },
    }
