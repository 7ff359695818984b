"""A cell small enough for the CPU: a 192x512 camera, a 7 m circle of 48
frames through 1,500 points, 8-frame episodes, the closed loop on the
fused tracker (handles of 2 frames) or on the modular one (frame by
frame)."""

from perfbench import generator, synthetic_np, window

LIMITS = {"frames_missing": 0, "track_m": 0.1}
METRICS = {"fps": "frames/s", "pose_batch_ms.p90": "ms", "setup_s": "s",
           "programs.uncached_runs": "runs",
           "loop.relocalization_host_ms_per_frame": "ms/frame"}


def config(fused: bool) -> window.Config:
    return window.Config(
        name="tiny", camera=synthetic_np.Camera(300.0, 300.0, 256.0, 96.0, 0.4, 192, 512),
        landmark_capacity=8192,
        settings={
            "framepoint_generation.capacity": 256,
            "framepoint_generation.border_pixels": 12,
            "world_map.minimum_distance_traveled_for_local_map": 0.8,
            "world_map.minimum_number_of_frames_for_local_map": 2,
            "relocalization.preliminary_minimum_interspace_queries": 6,
            "relocalization.preliminary_minimum_matching_ratio": 0.08,
            "relocalization.icp_minimum_number_of_inliers": 8,
            "relocalization.icp_minimum_inlier_ratio": 0.3,
            "parallelism.frames_per_chunk": 2,
            "tracking.use_fused_tracker": fused,
        }, raw={})


def traffic(fused: bool, episode_frames: int = 8) -> generator.Traffic:
    return generator.traffic("tiny", {
        "world": "circle", "circuit_frames": 48, "radius_m": 7.0, "laps": 1.0,
        "n_points": 1500, "scene_seed": 21, "episode_frames": episode_frames,
        "handoff": "prestaged" if fused else "per_frame", "trace_start": 0, "trace_frames": 2})
