"""SlamEngine: system orchestration (port of vslam_tpu/system/engine.py).

This slice runs the engine in OPEN-LOOP mode (the reference's
`-open-loop`, command_line.option_disable_relocalization): per-frame
tracking, landmark mapping + recovery, in-step keyframe snapshots and
local-map registration with pose-graph bookkeeping.  Relocalization,
the pose graph, landmark merging and full BA are not ported yet; a
configuration that asks for them raises NotImplementedError.
"""

from __future__ import annotations

import time

import numpy as np

from vslam_tpu_torch.io.config import ParameterCollection
from vslam_tpu_torch.mapping.local_maps import WorldMap
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.tracking.tracker import FusedPoseTracker, KeyframeSnapshot

# Odometry edges spanning a tracking break carry ~no information.
BREAK_EDGE_WEIGHT = 1e-3


def _check_supported(cfg: ParameterCollection) -> None:
    if not cfg.command_line.option_disable_relocalization:
        raise NotImplementedError(
            "closed-loop mode (relocalization, pose graph, landmark merging) "
            "is not ported yet (ROADMAP Queue 1 items 9-11); set "
            "command_line.option_disable_relocalization=True for open loop")
    if cfg.graph_optimization.enable_full_bundle_adjustment:
        raise NotImplementedError(
            "full bundle adjustment is not ported yet (ROADMAP Queue 1 item 12)")
    if not cfg.tracking.use_fused_tracker:
        raise NotImplementedError(
            "the modular PoseTracker is not ported (ROADMAP: not to port)")
    if cfg.visualization.enable_image_dump:
        raise NotImplementedError(
            "keyframe image dumps are not ported yet (ROADMAP Queue 1 item 18)")


class SlamEngine:
    def __init__(self, cam: cam_ops.CameraParams,
                 config: ParameterCollection | None = None,
                 landmark_capacity: int = 65536, device="cpu"):
        self.cfg = config or ParameterCollection()
        self.cfg.validate()
        _check_supported(self.cfg)
        self.tracker = FusedPoseTracker(cam, self.cfg, landmark_capacity, device=device)
        self.cam = self.tracker.cam
        self.device = self.tracker.device
        wm = self.cfg.world_map
        self.world_map = WorldMap(
            min_distance=wm.minimum_distance_traveled_for_local_map,
            min_degrees=wm.minimum_degrees_rotated_for_local_map,
            min_frames=wm.minimum_number_of_frames_for_local_map,
        )
        self.open_loop = True
        # Pose-graph bookkeeping: one vertex per local-map keyframe.
        self.kf_poses: list[np.ndarray] = []
        self.kf_frame_indices: list[int] = []
        self.kf_odometry: list[np.ndarray] = []  # T_{k-1,k} measured
        self.kf_odom_weight: list[float] = []  # breakTrack-aware edge weights
        self._breaks_consumed = 0
        self._t_start = time.perf_counter()
        self._frame_times: list[float] = []

    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                odometry: np.ndarray | None = None) -> np.ndarray:
        """Process one stereo frame; returns the tracker's last harvested
        T_world_cam (exact per frame on the CPU)."""
        t0 = time.perf_counter()
        T = self.tracker.compute(img_l, img_r, odometry)
        self._consume_keyframe_events()
        self._frame_times.append(time.perf_counter() - t0)
        return T

    def _flush_tracker(self):
        self.tracker.flush()
        self._consume_keyframe_events()

    def _consume_keyframe_events(self):
        """Register every harvested keyframe snapshot as a local map."""
        for snap in self.tracker.pop_keyframes():
            self._register_keyframe(snap)

    def _register_keyframe(self, snap: KeyframeSnapshot):
        """Local-map creation + pose-graph vertex/odometry bookkeeping for
        one keyframe event; returns the new LocalMap."""
        if snap.map_id != len(self.world_map.local_maps):
            raise RuntimeError(
                f"keyframe {snap.map_id} out of order "
                f"({len(self.world_map.local_maps)} local maps)")
        local_map = self.world_map.create_local_map(
            snap.T_world_kf, snap.frame_idx, snap.slots, snap.xyz_w, snap.desc,
            uv4=snap.uv4,
        )
        local_map.ring_row = snap.ring_row
        self.kf_poses.append(snap.T_world_kf.copy())
        self.kf_frame_indices.append(snap.frame_idx)
        if len(self.kf_poses) > 1:
            self.kf_odometry.append(np.linalg.inv(self.kf_poses[-2]) @ self.kf_poses[-1])
            prev_fidx = self.kf_frame_indices[-2]
            breaks = self.tracker._break_frames
            spans_break = any(prev_fidx < b <= snap.frame_idx
                              for b in breaks[self._breaks_consumed:])
            self._breaks_consumed = len(breaks)
            self.kf_odom_weight.append(BREAK_EDGE_WEIGHT if spans_break else 1.0)
        return local_map

    @property
    def trajectory(self) -> np.ndarray:
        self._flush_tracker()
        return np.stack(self.tracker.trajectory)

    def report_lite(self) -> dict:
        """Status-line statistics without draining the device pipeline."""
        ft = np.asarray(self._frame_times) if self._frame_times else np.zeros(1)
        stats = self.tracker.stats
        return {
            "total_frames": stats.n_frames,
            "mean_frame_hz": round(float(1.0 / max(ft.mean(), 1e-9)), 2),
            "n_landmarks": stats.n_spawned,
            "n_local_maps": len(self.world_map),
            "n_closures": 0,
            "n_optimizations": 0,
            "n_track_breaks": stats.n_breaks,
        }

    def report(self) -> dict:
        """printReport parity (slam_assembly.cpp:622-744), open loop."""
        self._flush_tracker()
        ft = np.asarray(self._frame_times) if self._frame_times else np.zeros(1)
        stats = self.tracker.stats
        return {
            "total_frames": stats.n_frames,
            "total_compute_time_s": round(float(ft.sum()), 3),
            "mean_frame_time_s": round(float(ft.mean()), 4),
            "mean_frame_hz": round(float(1.0 / max(ft.mean(), 1e-9)), 2),
            "median_frame_time_s": round(float(np.median(ft)), 4),
            "max_frame_time_s": round(float(ft.max()), 4),
            "wall_time_s": round(time.perf_counter() - self._t_start, 3),
            "n_landmarks": self.tracker.allocator.num_allocated,
            "n_local_maps": len(self.world_map),
            "n_closures": 0,
            "n_optimizations": 0,
            "n_ba_runs": 0,
            "n_merged_landmarks": 0,
            "n_track_breaks": stats.n_breaks,
            "n_recovered_landmarks": stats.n_recovered,
            "stage_seconds": {k: round(v, 3) for k, v in stats.stage_seconds.items()},
        }

    def print_report(self):
        rep = self.report()
        print("-" * 60)
        print("vslam_tpu_torch run report")
        for k, v in rep.items():
            print(f"  {k:26s} {v}")
        print("-" * 60)
