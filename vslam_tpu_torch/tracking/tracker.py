"""Per-frame stereo and RGB-D odometry (port of FusedPoseTracker,
vslam_tpu/tracking/tracker.py): owns the device TrackerState, steps it
once per frame, and harvests poses, statistics and keyframe snapshots
from the device rings in batched readbacks.  World-frame corrections from
the pose graph that land while frames are in flight are applied to those
frames' poses and snapshots at harvest."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from vslam_tpu_torch.io.config import ParameterCollection
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.solve import gn
from vslam_tpu_torch.tracking import fused
from vslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

LOCALIZING = "Localizing"
TRACKING = "Tracking"


@dataclass
class KeyframeSnapshot:
    """One harvested keyframe event from the device snapshot ring; host
    numpy arrays truncated to the n valid rows."""

    map_id: int  # local-map index (device kf_count order)
    frame_idx: int
    T_world_kf: np.ndarray  # (4, 4)
    slots: np.ndarray  # (n,) int32 landmark table slots
    xyz_w: np.ndarray  # (n, 3) landmark world positions at snapshot
    desc: np.ndarray | None  # descriptors stay in the device ring (None)
    uv4: np.ndarray  # (n, 4) keyframe observations (stereo or [u, v, z, 0])
    ring_row: int = -1  # device snapshot-ring row


@dataclass
class TrackerStats:
    n_frames: int = 0
    n_tracked_points: int = 0
    n_inliers: int = 0
    n_keypoints: int = 0
    n_framepoints: int = 0
    tracking_ratio: float = 0.0
    n_breaks: int = 0
    n_recovered: int = 0
    n_spawned: int = 0
    stage_seconds: dict = field(default_factory=dict)

    def add_time(self, stage: str, dt: float):
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + dt


class _AllocatorView:
    """Allocator facade over the device slot counter and free list."""

    def __init__(self, owner):
        self._owner = owner

    @property
    def num_allocated(self) -> int:
        st = self._owner.state
        return int(st.next_slot) - int(st.free_count)

    def release(self, slots):
        """Push merge-freed slots onto the device free stack, so spawn
        recycles them (no device read)."""
        slots = [int(s) for s in np.asarray(slots) if s >= 0]
        if not slots:
            return
        st = self._owner.state
        fl, fc = fused.push_free_slots(
            st.free_list, st.free_count,
            torch.tensor(slots, dtype=torch.int32, device=st.free_list.device))
        self._owner.state = st._replace(free_list=fl, free_count=fc)


class _ControllerView:
    def __init__(self, owner):
        self._owner = owner

    @property
    def threshold(self) -> float:
        return float(self._owner.state.threshold)

    @threshold.setter
    def threshold(self, v: float):
        st = self._owner.state
        self._owner.state = st._replace(threshold=torch.full_like(st.threshold, v))


def _depth_calibration(fp, device):
    """(K_depth (3, 3), T_rgb_depth (4, 4)) of a depth sensor that is not
    aligned with the intensity camera, or None when the depth image is
    already registered to it."""
    if fp.depth_camera_intrinsics is None or fp.depth_camera_to_rgb is None:
        return None
    return (torch.tensor(np.asarray(fp.depth_camera_intrinsics, np.float32).reshape(3, 3),
                         device=device),
            torch.tensor(np.asarray(fp.depth_camera_to_rgb, np.float32).reshape(4, 4),
                         device=device))


def params_from_config(cam: cam_ops.CameraParams, config: ParameterCollection,
                       device: torch.device) -> fused.FusedParams:
    """FusedParams from the configuration tree, as the JAX tracker builds
    them; the keyframe ring is the full archive on CUDA and 32 rows on
    the CPU (the JAX tracker's TPU / CPU split)."""
    fp = config.framepoint_generation
    tr = config.tracking
    n_cells = (cam.rows // fp.bin_size_pixels) * (cam.cols // fp.bin_size_pixels)
    return fused.FusedParams(
        capacity=fp.capacity,
        bin_size=fp.bin_size_pixels,
        border=fp.border_pixels,
        mode="depth" if config.command_line.tracker_mode == "RGB_DEPTH" else "stereo",
        descriptor=fp.descriptor_type,
        detector=fp.detector_type,
        octaves=fp.detector_number_of_octaves,
        max_hamming_stereo=fp.maximum_matching_distance_triangulation,
        epipolar_tol=fp.maximum_epipolar_search_offset_pixels,
        min_disparity=fp.minimum_disparity_pixels,
        max_disparity=fp.maximum_disparity_pixels,
        min_depth=fp.minimum_depth_meters,
        max_depth=fp.maximum_depth_meters,
        min_track_for_landmark=tr.minimum_track_length_for_landmark_creation,
        min_inliers=tr.aligner_minimum_number_of_inliers,
        min_inlier_ratio=tr.aligner_minimum_inlier_ratio,
        enable_recovery=(config.command_line.option_recover_landmarks
                         and tr.maximum_number_of_landmark_recoveries > 0),
        radius_min=float(tr.minimum_threshold_distance_tracking_pixels),
        radius_max=float(tr.maximum_distance_tracking_pixels),
        radius_adaptive_max=float(max(tr.maximum_threshold_distance_tracking_pixels,
                                      tr.minimum_threshold_distance_tracking_pixels)),
        min_landmarks_to_track=tr.minimum_number_of_landmarks_to_track,
        min_delta_ang=tr.minimum_delta_angular_for_movement,
        min_delta_trans=tr.minimum_delta_translational_for_movement,
        gate_min=float(fp.matching_distance_tracking_threshold),
        good_tracking_ratio=tr.good_tracking_ratio,
        target_keypoints=min(int(n_cells * 0.7), int(fp.capacity * 0.7)),
        target_tolerance=fp.target_number_of_keypoints_tolerance,
        lm_min_forced_updates=config.landmark.minimum_number_of_forced_updates,
        lm_min_meas_for_opt=config.landmark.minimum_number_of_measurements_for_optimization,
        lm_max_t_err_depth_ratio=config.landmark.maximum_translation_error_to_depth_ratio,
        enable_eviction=config.command_line.option_drop_framepoints,
        bilateral_depth=fp.enable_bilateral_filtering,
        ring_size=max(64, 4 * int(config.parallelism.frames_per_chunk)),
        kf_ring_size=(int(config.parallelism.kf_archive_size)
                      if device.type == "cuda" else 32),
        threshold_min=fp.detector_threshold_minimum,
        threshold_max=fp.detector_threshold_maximum,
        threshold_max_change=fp.detector_threshold_maximum_change,
        kf_min_distance=config.world_map.minimum_distance_traveled_for_local_map,
        kf_min_radians=float(np.deg2rad(config.world_map.minimum_degrees_rotated_for_local_map)),
        kf_min_frames=config.world_map.minimum_number_of_frames_for_local_map,
        kf_min_landmarks=config.local_map.minimum_number_of_landmarks,
        kf_max_landmarks=min(config.local_map.maximum_number_of_landmarks, fp.capacity),
        gn_config=gn.GNConfig(
            max_iterations=tr.aligner_maximum_number_of_iterations,
            kernel_max_error=tr.aligner_maximum_error_kernel,
            damping=tr.aligner_damping,
            min_num_inliers=tr.aligner_minimum_number_of_inliers,
        ),
    )


class FusedPoseTracker:
    """Per-frame stereo or RGB-D odometry over the device-resident tracker
    step.

    Poses and statistics are written by the step into a device result
    ring and read back every `harvest_every` frames: every frame on the
    CPU, every `parallelism.frames_per_chunk` frames on CUDA."""

    def __init__(self, cam: cam_ops.CameraParams, config: ParameterCollection,
                 landmark_capacity: int = 65536, device=DEFAULT_DEVICE):
        if config.tracking.batch_frontend:
            raise NotImplementedError(
                "the split (batched) front-end is not ported yet "
                "(ROADMAP Queue 1 item 15)")
        self.device = resolve_device(device)
        self.cam = cam_ops.to_device(cam, self.device)
        self.params = params_from_config(self.cam, config, self.device)
        self.mode = self.params.mode
        fp, tr = config.framepoint_generation, config.tracking
        self.depth_calib = _depth_calibration(fp, self.device)
        # Stereo frames cross to the device as uint8, like the JAX
        # tracker's upload (FAST scores and ties are those of the integer
        # image); RGB-D frames as f32, for depth in meters.
        self._frame_dtype = np.uint8 if self.mode == "stereo" else np.float32
        self.state = fused.init_state(self.cam, self.params, landmark_capacity,
                                      fp.detector_threshold_starting_value)
        self.motion_model_on = tr.motion_model == "CONSTANT_VELOCITY"
        self.odometry_on = (tr.motion_model == "CAMERA_ODOMETRY"
                            or config.command_line.option_use_odometry)
        self.harvest_every = (max(int(config.parallelism.frames_per_chunk), 1)
                              if self.device.type == "cuda" else 1)
        self.trajectory: list[np.ndarray] = []
        self.stats = TrackerStats()
        self.allocator = _AllocatorView(self)
        self.controller = _ControllerView(self)
        self._dispatched = 0  # frames stepped on the device
        self._harvested = 0  # frames read back from the ring
        self._kf_harvested = 0  # device kf_count already harvested
        self._pending_keyframes: list[KeyframeSnapshot] = []
        # World-frame corrections applied while frames were in flight:
        # (cutoff, C) — results of frames < cutoff were computed in the
        # old world frame and get C at harvest.
        self._pending_corrections: list[tuple[int, np.ndarray]] = []
        self._drained = False  # a drain ran since take_drained()
        self._last_pose = np.eye(4, dtype=np.float32)
        self._last_status = LOCALIZING
        # Frame indices where registration failed (track re-rooted).
        self._break_frames: list[int] = []

    @property
    def status(self) -> str:
        """Localizing / Tracking after the last harvested frame."""
        return self._last_status

    def compute(self, img_l: np.ndarray, img_r: np.ndarray,
                odometry: np.ndarray | None = None) -> np.ndarray:
        """Process one frame: the stereo pair, or in depth mode the
        intensity image and the depth map in meters.  Returns the last
        harvested pose (exact per frame on the CPU, up to harvest_every
        frames behind on CUDA — flush() first for exact state)."""
        t0 = time.perf_counter()
        pair = torch.from_numpy(np.stack([img_l, img_r]).astype(self._frame_dtype))
        self._step(pair.to(self.device), odometry)
        self.stats.add_time("frame_step", time.perf_counter() - t0)
        return self._last_pose

    def prestage(self, frame_pairs) -> list:
        """Upload every frame ahead of the loop (dataset playback) in one
        transfer, as compute() would (uint8 stereo, f32 RGB-D); returns one
        handle per harvest_every frames for compute_prestaged()."""
        frames = torch.from_numpy(np.stack(
            [np.stack([l, r]) for l, r in frame_pairs]).astype(self._frame_dtype)
        ).to(self.device)
        C = self.harvest_every
        return [frames[i:i + C] for i in range(0, len(frames), C)]

    def compute_prestaged(self, staged: torch.Tensor) -> np.ndarray:
        """Step the frames of one prestaged handle (see prestage())."""
        t0 = time.perf_counter()
        for pair in staged:
            self._step(pair, None)
        self.stats.add_time("frame_step", time.perf_counter() - t0)
        return self._last_pose

    def _step(self, imgs: torch.Tensor, odometry):
        T_odom = None
        if self.odometry_on:
            T_odom = torch.as_tensor(
                np.eye(4, dtype=np.float32) if odometry is None
                else np.asarray(odometry, np.float32), device=self.device)
        self.state = fused.step(self.cam, self.params, self.state, imgs,
                                self.motion_model_on, T_odom, self.depth_calib)
        self._dispatched += 1
        if self._dispatched - self._harvested >= self.harvest_every:
            self._drain()

    def take_drained(self) -> bool:
        """Whether a drain ran since the last call (the engine resolves its
        in-flight closure work at drains only)."""
        out, self._drained = self._drained, False
        return out

    def _corrected(self, T: np.ndarray, fidx: int) -> np.ndarray:
        """Apply the corrections that landed while frame fidx was in flight."""
        for cutoff, C in self._pending_corrections:
            if fidx < cutoff:
                T = C @ T
        return T.astype(np.float32)

    def _drain(self):
        """One device->host copy of the result ring: per-frame poses and
        statistics of every unharvested frame, then any new keyframes."""
        self._drained = True
        upto = self._dispatched
        if upto == self._harvested:
            return
        assert upto - self._harvested <= self.params.ring_size
        ring = self.state.ring.cpu().numpy()
        s = self.stats
        kf_total = self._kf_harvested
        for fi in range(self._harvested, upto):
            row = ring[fi % self.params.ring_size]
            T = self._corrected(row[:16].reshape(4, 4), fi)
            self.trajectory.append(T)
            self._last_pose = T
            n_fp = int(row[fused._R_NFP])
            n_matches = int(row[fused._R_NMATCH])
            s.n_frames += 1
            s.n_keypoints += int(row[fused._R_NKP])
            s.n_framepoints += n_fp
            s.n_tracked_points += n_matches
            s.n_inliers += int(row[fused._R_NINL])
            s.n_recovered += int(row[fused._R_NRECOVER])
            s.n_spawned += int(row[fused._R_NSPAWN])
            s.tracking_ratio = n_matches / max(n_fp, 1)
            if row[fused._R_OK] == 0.0:
                s.n_breaks += 1
                self._break_frames.append(fi)
            self._last_status = TRACKING if row[fused._R_STATUS] > 0.0 else LOCALIZING
            kf_total = int(row[fused._R_KFCOUNT])
        if kf_total > self._kf_harvested:
            self._harvest_keyframes(kf_total)
        self._harvested = upto
        # Corrections older than everything still unharvested are spent.
        self._pending_corrections = [(c, C) for c, C in self._pending_corrections
                                     if c > self._harvested]

    def _harvest_keyframes(self, kf_total: int):
        """Copy the new keyframe snapshots out of the device ring."""
        start = self._kf_harvested
        KR = self.params.kf_ring_size
        if kf_total - start > KR:
            raise RuntimeError(f"keyframe ring overflow: {kf_total - start} "
                               f"keyframes since the last drain > ring size {KR}")
        rows = torch.tensor([k % KR for k in range(start, kf_total)],
                            dtype=torch.int64, device=self.device)
        st = self.state
        pose, fidx, ns, slots, xyz, uv4 = (
            a[rows].cpu().numpy() for a in (st.kf_pose, st.kf_frame_idx, st.kf_n,
                                            st.kf_slots, st.kf_xyz, st.kf_uv4)
        )
        for r, k in enumerate(range(start, kf_total)):
            n = int(ns[r])
            C = self._corrected(np.eye(4, dtype=np.float32), int(fidx[r]))
            self._pending_keyframes.append(KeyframeSnapshot(
                map_id=k,
                frame_idx=int(fidx[r]),
                T_world_kf=(C @ pose[r]).astype(np.float32),
                slots=slots[r][:n].copy(),
                xyz_w=(xyz[r][:n] @ C[:3, :3].T + C[:3, 3]).astype(np.float32),
                desc=None,
                uv4=uv4[r][:n].copy(),
                ring_row=k % KR,
            ))
        self._kf_harvested = kf_total

    def pop_keyframes(self) -> list[KeyframeSnapshot]:
        """Harvested-but-unconsumed keyframe events (engine API)."""
        out = self._pending_keyframes
        self._pending_keyframes = []
        return out

    def apply_world_correction(self, C: np.ndarray):
        """Left-multiply a rigid world-frame correction onto the live pose
        state (the pose graph's most recent segment); frames already
        dispatched get it at harvest.  Landmarks are corrected separately
        by origin local map (landmarks.apply_kf_corrections)."""
        C = np.asarray(C, np.float32)
        Cd = torch.from_numpy(C).to(self.device)
        self.state = self.state._replace(T_world_cam=Cd @ self.state.T_world_cam,
                                         T_last_kf=Cd @ self.state.T_last_kf)
        self._pending_corrections.append((self._dispatched, C))

    def flush(self):
        """Harvest every stepped frame (call before reading final state)."""
        self._drain()
