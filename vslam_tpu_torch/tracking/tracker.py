"""Per-frame stereo and RGB-D odometry (port of vslam_tpu/tracking/tracker.py).

FusedPoseTracker, the production tracker, owns the device TrackerState,
steps it once per frame, and harvests poses, statistics and keyframe
snapshots from the device rings in batched readbacks.  World-frame
corrections from the pose graph that land while frames are in flight are
applied to those frames' poses and snapshots at harvest.

PoseTracker is the modular reference (tracking.use_fused_tracker: false):
the front-end, pose solve and landmark programs of tracking/modular.py
run one at a time from a host state machine that reads a handful of
scalars a frame (the registration ladder's verdicts, the spawn mask),
with a host slot allocator and threshold controller.  The engine runs
its keyframe and closure path synchronously after every frame."""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from vslam_tpu_torch.frontend import detect
from vslam_tpu_torch.io.config import ParameterCollection
from vslam_tpu_torch.mapping import frame as frame_mod
from vslam_tpu_torch.mapping import landmarks as lm_mod
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.solve import gn
from vslam_tpu_torch.tracking import fused, modular
from vslam_tpu_torch.utils import log
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
    # Descriptors stay in the device ring (None); the modular tracker's
    # snapshots carry a host copy.
    desc: np.ndarray | None
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
    """(K_depth^-1 (3, 3), T_rgb_depth (4, 4)) of a depth sensor that is
    not aligned with the intensity camera, or None when the depth image is
    already registered to it (depth.register_depth's arguments; the
    inverse is made here, once)."""
    if fp.depth_camera_intrinsics is None or fp.depth_camera_to_rgb is None:
        return None
    K_depth = torch.tensor(np.asarray(fp.depth_camera_intrinsics, np.float32).reshape(3, 3),
                           device=device)
    return (torch.linalg.inv(K_depth),
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
        gn_config=_gn_config(tr),
    )


def _gn_config(tr) -> gn.GNConfig:
    return gn.GNConfig(
        max_iterations=tr.aligner_maximum_number_of_iterations,
        kernel_max_error=tr.aligner_maximum_error_kernel,
        damping=tr.aligner_damping,
        min_num_inliers=tr.aligner_minimum_number_of_inliers,
    )


class PoseTracker:
    """Modular per-frame stereo or RGB-D odometry (reference
    pose_tracker_3d.cpp): motion-model guess, Localizing / Tracking,
    registration with the adaptive-search retry ladder (_registerRecursive,
    :300-419), adaptive tracking window and descriptor gate (:251-288),
    landmark creation and update (:475-549) and the fallback estimate
    (:551-566).  The O(N) math runs on the device as the programs of
    tracking/modular.py (on CUDA each one run eagerly once, captured at
    its second use and replayed after; on the CPU each one eagerly on the
    same buffers); each retry attempt and each frame's spawn read a few
    scalars and masks to the host between the programs, as the JAX
    package's PoseTracker does between its jitted calls.  The pose is
    exact after every frame (no pipelining), so the engine's keyframe path
    runs synchronously.

    The landmark table and the previous frame live in the programs'
    static buffers while this tracker holds them (`table` and `prev_frame`
    read and write them in place); the programs are the process's for the
    tracker's key, and a tracker takes them over when it is built and
    before it steps after another took them (_hold), keeping its state in
    tensors of its own meanwhile."""

    def __init__(self, cam: cam_ops.CameraParams, config: ParameterCollection,
                 landmark_capacity: int = 65536, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.cam = cam_ops.to_device(cam, self.device)
        self.cfg = config
        fp, tr = config.framepoint_generation, config.tracking
        self.capacity = fp.capacity
        n_cells = (cam.rows // fp.bin_size_pixels) * (cam.cols // fp.bin_size_pixels)
        # The target stays below the capacity: detected counts are clipped
        # at it, and a target above would pin the threshold at its minimum.
        self.controller = detect.ThresholdController(
            initial=fp.detector_threshold_starting_value,
            target_count=min(int(n_cells * 0.7), int(fp.capacity * 0.7)),
            max_change=fp.detector_threshold_maximum_change,
            minimum=fp.detector_threshold_minimum,
            maximum=fp.detector_threshold_maximum,
        )
        self.gn_config = _gn_config(tr)
        # Adaptive search state (pose_tracker_3d.cpp:251-288).
        self.radius_px = float(tr.minimum_threshold_distance_tracking_pixels)
        self.desc_gate = float(fp.matching_distance_tracking_threshold)
        self.allocator = lm_mod.SlotAllocator(landmark_capacity)
        self.mode = "depth" if config.command_line.tracker_mode == "RGB_DEPTH" else "stereo"
        self.depth_calib = _depth_calibration(fp, self.device)
        self.programs = modular.make_programs(
            self.cam, self.mode,
            modular.FrontEndSettings(fp.capacity, fp.bin_size_pixels, fp.border_pixels,
                                     fp.descriptor_type, fp.detector_type,
                                     fp.detector_number_of_octaves),
            self.gn_config, landmark_capacity, self.depth_calib)
        if self.mode == "stereo":
            self._gates = (np.int32(fp.maximum_matching_distance_triangulation),
                           np.float32(fp.maximum_epipolar_search_offset_pixels),
                           np.float32(fp.minimum_disparity_pixels),
                           np.float32(fp.maximum_disparity_pixels))
        else:
            self._gates = (np.float32(fp.minimum_depth_meters),
                           np.float32(fp.maximum_depth_meters))
        # The state in tensors of this tracker's own while another tracker
        # holds the programs' buffers; None while this one holds them.
        self._own = modular.ModularState(lm_mod.empty_table(landmark_capacity, self.device),
                                         frame_mod.empty_frame(fp.capacity, self.device))
        self._has_prev = False
        self.status = LOCALIZING
        self.T_world_cam = np.eye(4, dtype=np.float32)
        self.last_motion = np.eye(4, dtype=np.float32)  # T_cur_prev
        self.frame_idx = 0
        self.stats = TrackerStats()
        self.trajectory: list[np.ndarray] = []
        # Local map that newly spawned landmarks belong to; the engine
        # bumps it when it creates a local map.
        self.kf_count = 0
        self._break_frames: list[int] = []
        self._hold()

    @property
    def n_frames_in(self) -> int:
        return self.frame_idx

    def _hold(self):
        """Make the programs' buffers this tracker's state (see the class
        docstring): the tracker that held them takes its state out into
        tensors of its own first; then this one's state and gates are
        copied in."""
        if self._own is None:
            return
        progs = self.programs
        other = progs.holder() if progs.holder is not None else None
        if other is not None:
            other._own = fused.clone_state(progs.state)
        modular.assign(progs.table, self._own.table)
        modular.assign(progs.prev, self._own.prev)
        for buf, v in zip(progs.gates, self._gates):
            buf.fill_(v.item())
        progs.holder = weakref.ref(self)
        self._own = None

    @property
    def _state(self) -> modular.ModularState:
        return self.programs.state if self._own is None else self._own

    @property
    def table(self) -> lm_mod.LandmarkTable:
        """The landmark table: the programs' buffers while this tracker
        holds them, else its own copy."""
        return self._state.table

    @table.setter
    def table(self, t: lm_mod.LandmarkTable):
        modular.assign(self._state.table, t)

    @property
    def prev_frame(self) -> frame_mod.FrameState | None:
        """The last frame's framepoints (None before the first frame or
        after a checkpoint load: the next frame re-seeds tracking)."""
        return self._state.prev if self._has_prev else None

    @prev_frame.setter
    def prev_frame(self, f: frame_mod.FrameState | None):
        if f is not None:
            modular.assign(self._state.prev, f)
        self._has_prev = f is not None

    def _front_end(self, img_l, img_r):
        """img_r: the right image in stereo mode, the depth map in meters
        in depth mode (registered to the intensity camera in the program
        when the configuration gives the depth sensor's calibration).
        Runs the front-end program into the current frame; the two counts
        come back in one read."""
        counts = self.programs.front.run((np.asarray(img_l, np.float32),
                                          np.asarray(img_r, np.float32),
                                          np.float32(self.controller.threshold)))
        n_kp, n_fp = (int(v) for v in counts.cpu().numpy())
        self.controller.update(n_kp)
        return n_kp, n_fp

    def _register(self, T_guess):
        """Registration with adaptive retries (_registerRecursive: up to two
        retries with a widened window, the last from the identity), one
        run of the track program an attempt, its verdict read in one
        transfer.  Returns (the last attempt's verdict, success)."""
        tr = self.cfg.tracking
        attempts = [
            (self.radius_px, self.desc_gate, T_guess),
            (min(2.0 * self.radius_px, tr.maximum_distance_tracking_pixels),
             min(self.desc_gate + 10, 90.0), T_guess),
            (tr.maximum_distance_tracking_pixels, 90.0, np.eye(4, dtype=np.float32)),
        ]
        for radius, gate, guess in attempts:
            v = self.programs.track.run((np.asarray(guess, np.float32), np.float32(radius),
                                         np.int32(int(gate)))).cpu().numpy()
            n_inl = int(v[modular.VERDICT_INLIERS])
            inl_ratio = n_inl / max(int(v[modular.VERDICT_MATCHES]), 1)
            if (v[modular.VERDICT_CONVERGED] != 0 and n_inl >= tr.aligner_minimum_number_of_inliers
                    and inl_ratio >= tr.aligner_minimum_inlier_ratio):
                return v, True
        return v, False

    def _adapt_search(self, tracking_ratio: float):
        """Widen the window when tracking is poor, narrow it when strong
        (pose_tracker_3d.cpp:251-288)."""
        tr = self.cfg.tracking
        if tracking_ratio < tr.good_tracking_ratio:
            self.radius_px = min(self.radius_px * 1.2, tr.maximum_distance_tracking_pixels)
            self.desc_gate = min(self.desc_gate + 5, 90.0)
        else:
            self.radius_px = max(self.radius_px * 0.95,
                                 tr.minimum_threshold_distance_tracking_pixels)
            self.desc_gate = max(self.desc_gate - 1,
                                 self.cfg.framepoint_generation.matching_distance_tracking_threshold)

    def _spawn_and_update_landmarks(self):
        """Create landmarks for mature reliable tracks of the current frame,
        then refine every observed one (_updatePoints,
        pose_tracker_3d.cpp:475-549); the current frame becomes the
        previous one.  The spawn mask is read to the host, which allocates
        the slots, between the programs."""
        progs = self.programs
        needs = modular.spawn_mask(progs.cur,
                                   self.cfg.tracking.minimum_track_length_for_landmark_creation)
        rows = np.flatnonzero(needs.cpu().numpy())
        T_wc, fidx = self.T_world_cam, np.int32(self.frame_idx)
        if len(rows):
            slots = self.allocator.allocate(len(rows))
            ok = slots >= 0
            rows, slots = rows[ok], slots[ok]
            if len(rows):
                # One fixed-capacity assignment array for every frame.
                assigned = np.full(self.capacity, -1, np.int32)
                assigned[rows] = slots
                progs.spawn.run((assigned, T_wc, fidx, np.int32(self.kf_count)))
                self.stats.n_spawned += len(rows)
                self._has_prev = True
                return
        progs.update.run((T_wc, fidx))
        self._has_prev = True

    def compute(self, img_l: np.ndarray, img_r: np.ndarray,
                odometry: np.ndarray | None = None) -> np.ndarray:
        """Process one frame (the stereo pair, or the intensity image and
        the depth map in meters); returns T_world_cam (4, 4).

        odometry: an external motion guess T_cur_prev (the CAMERA_ODOMETRY
        motion model, pose_tracker_3d.cpp:41-66)."""
        tr = self.cfg.tracking
        self._hold()
        t0 = time.perf_counter()
        n_kp, n_fp = self._front_end(img_l, img_r)
        self.stats.add_time("frontend", time.perf_counter() - t0)
        self.stats.n_keypoints += n_kp
        self.stats.n_framepoints += n_fp

        if not self._has_prev:
            self.status = LOCALIZING
            if self.frame_idx > 0 and tr.motion_model == "CONSTANT_VELOCITY":
                # Re-seeding mid-run (checkpoint resume): dead-reckon one
                # step so the trajectory stays continuous.
                self.T_world_cam = (self.T_world_cam
                                    @ np.linalg.inv(self.last_motion)).astype(np.float32)
            self._spawn_and_update_landmarks()
            self._finish_frame()
            return self.T_world_cam

        if odometry is not None and (tr.motion_model == "CAMERA_ODOMETRY"
                                     or self.cfg.command_line.option_use_odometry):
            T_guess = np.asarray(odometry, np.float32)
        elif tr.motion_model == "CONSTANT_VELOCITY":
            T_guess = self.last_motion
        else:
            T_guess = np.eye(4, dtype=np.float32)

        t0 = time.perf_counter()
        verdict, ok = self._register(T_guess)
        self.stats.add_time("tracking", time.perf_counter() - t0)

        n_prev = int(verdict[modular.VERDICT_PREV_VALID])
        n_matches = int(verdict[modular.VERDICT_MATCHES])
        ratio = n_matches / max(n_prev, 1)
        self.stats.n_tracked_points += n_matches
        self.stats.n_inliers += int(verdict[modular.VERDICT_INLIERS])
        self.stats.tracking_ratio = ratio
        if ok:
            motion = verdict[modular.VERDICT_T:].reshape(4, 4)
            self.status = TRACKING
        else:
            # Dead-reckon on the motion model and re-root the tracks
            # (breakTrack, world_map.cpp:260-279).
            motion = T_guess
            self.status = LOCALIZING
            self.stats.n_breaks += 1
            self._break_frames.append(self.frame_idx)
        self.T_world_cam = (self.T_world_cam @ np.linalg.inv(motion)).astype(np.float32)
        self.last_motion = motion.astype(np.float32)

        t0 = time.perf_counter()
        if ok:
            self.programs.propagate.run()
        self._spawn_and_update_landmarks()
        self.stats.add_time("mapping", time.perf_counter() - t0)

        self._adapt_search(ratio)
        self._finish_frame()
        return self.T_world_cam

    def _finish_frame(self):
        self.trajectory.append(self.T_world_cam.copy())
        self.frame_idx += 1
        self.stats.n_frames += 1

    def apply_world_correction(self, C: np.ndarray):
        """Left-multiply a world-frame correction onto the live pose (the
        pose graph's or BA's newest segment); nothing is in flight."""
        self.T_world_cam = (np.asarray(C, np.float32) @ self.T_world_cam).astype(np.float32)


class FusedPoseTracker:
    """Per-frame stereo or RGB-D odometry over the device-resident tracker
    step.

    Poses and statistics are written by the step into a device result
    ring and read back every `harvest_every` frames: every frame on the
    CPU, every `parallelism.frames_per_chunk` frames on CUDA.

    The state lives in the static buffers of a fused.FrameProgram, which
    steps every frame (on CUDA a replay of one captured graph), or with
    the split front-end of a fused.TrackProgram, which steps every
    frame's tail after the chunk's front-end.  Every
    writer of `state` (and of `table` / `prev_frame`) copies into those
    buffers in place (fused.assign_state): a rebound tensor would leave
    the graph reading a stale one.

    With tracking.batch_frontend (the split pipeline) frames are buffered
    on the device into chunks of `harvest_every` frames, counted from the
    first frame (frames cC .. cC + C - 1), and each chunk goes through
    fused.chunk_step_split: one batched front-end at the detector
    threshold of the chunk's first frame, then the per-frame tails (here
    replays of the track program).  A
    flush dispatches a partial chunk; the rest of that chunk keeps its
    threshold, so a flush does not change the results.

    The program is the process's one for the tracker's configuration
    (fused.make_frame_step / make_track_step), so a tracker built after
    another of the same configuration replays its captured graph from
    its first frame.  Its buffers hold one tracker's state at a time: a
    tracker takes them over when it is built and again before it steps
    after another took them (_hold_program); the one that held them
    keeps its state in tensors of its own."""

    def __init__(self, cam: cam_ops.CameraParams, config: ParameterCollection,
                 landmark_capacity: int = 65536, device=DEFAULT_DEVICE):
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
        # The state in tensors of this tracker's own while another tracker
        # holds the program's buffers; None while this one holds them.
        self._own = fused.init_state(self.cam, self.params, landmark_capacity,
                                     fp.detector_threshold_starting_value)
        self.motion_model_on = tr.motion_model == "CONSTANT_VELOCITY"
        self.odometry_on = (tr.motion_model == "CAMERA_ODOMETRY"
                            or config.command_line.option_use_odometry)
        self.harvest_every = (max(int(config.parallelism.frames_per_chunk), 1)
                              if self.device.type == "cuda" else 1)
        self.split = bool(tr.batch_frontend)
        # The split front-end replays its per-frame tail (make_track_step);
        # every other route the whole frame (make_frame_step).  Either is
        # the process's program for this configuration, shared with every
        # other tracker of it.
        if self.split:
            self.program = fused.make_track_step(self.cam, self.params, landmark_capacity,
                                                 self.odometry_on)
        else:
            self.program = fused.make_frame_step(
                self.cam, self.params, landmark_capacity,
                torch.uint8 if self.mode == "stereo" else torch.float32,
                odometry=self.odometry_on, depth_calib=self.depth_calib)
        self._buf: list[torch.Tensor] = []  # split: device frames awaiting their chunk
        self._odom_buf: list = []
        self._chunk_threshold = None  # split: the current chunk's detector threshold
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
        # (clock, log.chronometers.outer_seconds) when the last drain's ring
        # read returned; None once the next replay is queued.
        self._ring_read_at = None
        self._last_pose = np.eye(4, dtype=np.float32)
        self._last_status = LOCALIZING
        # Frame indices where registration failed (track re-rooted).
        self._break_frames: list[int] = []
        self._hold_program()

    @property
    def status(self) -> str:
        """Localizing / Tracking after the last harvested frame."""
        return self._last_status

    @property
    def state(self) -> fused.TrackerState:
        """The device state: the program's static buffers while this
        tracker holds them, else its own copy."""
        return self.program.state if self._own is None else self._own

    @state.setter
    def state(self, new: fused.TrackerState):
        fused.assign_state(self.state, new)

    def _hold_program(self):
        """Make the program's buffers this tracker's state: at
        construction and before every step while another tracker of the
        configuration may have taken them over (the program is shared).
        The tracker that held them takes its state out into tensors of its
        own first, so no tracker sees or changes another's; then this
        one's state is copied in."""
        if self._own is None:
            return
        prog = self.program
        other = prog.holder() if prog.holder is not None else None
        if other is not None:
            other._own = fused.clone_state(prog.state)
        fused.assign_state(prog.state, self._own)
        prog.motion.fill_(self.motion_model_on)
        prog.holder = weakref.ref(self)
        self._own = None

    @property
    def step_route(self) -> str:
        """How frames are stepped: "graph" (one CUDA graph replayed a
        frame; with the split front-end, of the frame's tail) or "program"
        (the program's body on the CPU)."""
        return "graph" if self.device.type == "cuda" else "program"

    @property
    def table(self) -> lm_mod.LandmarkTable:
        return self.state.table

    @table.setter
    def table(self, t: lm_mod.LandmarkTable):
        self.state = self.state._replace(table=t)

    @property
    def prev_frame(self) -> frame_mod.FrameState:
        return self.state.prev

    @prev_frame.setter
    def prev_frame(self, f: frame_mod.FrameState):
        self.state = self.state._replace(prev=f)

    def compute(self, img_l: np.ndarray, img_r: np.ndarray,
                odometry: np.ndarray | None = None) -> np.ndarray:
        """Process one frame: the stereo pair, or in depth mode the
        intensity image and the depth map in meters.  Returns the last
        harvested pose (exact per frame on the CPU, up to harvest_every
        frames behind on CUDA — flush() first for exact state)."""
        t0 = time.perf_counter()
        pair = self._upload(np.stack([img_l, img_r]).astype(self._frame_dtype))
        if self.split:
            self._buffer(pair[None], [odometry])
        else:
            self._step(pair, odometry)
        self.stats.add_time("frame_step", time.perf_counter() - t0)
        return self._last_pose

    @property
    def n_frames_in(self) -> int:
        """Frames received so far: dispatched, or buffered for a chunk."""
        return self._dispatched + len(self._buf)

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
        if self.split:
            self._buffer(staged, [None] * len(staged))
        else:
            self._hold_program()
            done = 0
            while done < len(staged):
                # Replays back to back up to the next drain.
                k = min(len(staged) - done, max(
                    1, self.harvest_every - (self._dispatched - self._harvested)))
                with self._enqueuing():
                    self.program.run_chunk(staged[done:done + k], k)
                self._dispatched += k
                done += k
                if self._dispatched - self._harvested >= self.harvest_every:
                    self._drain()
        self.stats.add_time("frame_step", time.perf_counter() - t0)
        return self._last_pose

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A frame's host array on the device with no wait for the device:
        on CUDA through pinned memory with an asynchronous copy (a copy from
        pageable memory waits for the stream, i.e. for the frames queued
        before it).  The pinned block goes back to PyTorch's caching host
        allocator, which records an event on the copy and reuses the block
        only after it."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _dispatch_staged(self, staged: torch.Tensor):
        """Step a prestaged handle's frames back to back with no drain
        after them (the JAX tracker's _dispatch_staged; bench's
        device-only rate).  The per-frame route only."""
        if self.split:
            raise ValueError("_dispatch_staged steps the per-frame program; the split "
                             "front-end steps its chunks through compute_prestaged")
        self._hold_program()
        self.program.run_chunk(staged, len(staged))
        self._dispatched += len(staged)

    def _odometry(self, odometry) -> torch.Tensor:
        return self._upload(np.eye(4, dtype=np.float32) if odometry is None
                            else np.asarray(odometry, np.float32))

    def _buffer(self, frames: torch.Tensor, odometry: list):
        """Split pipeline: queue device frames; dispatch each chunk as it
        fills."""
        for pair, odo in zip(frames, odometry):
            self._buf.append(pair)
            self._odom_buf.append(odo)
            if self.n_frames_in % self.harvest_every == 0:
                self._dispatch_chunk()

    def _dispatch_chunk(self):
        """Step the buffered frames as one chunk (chunk_step_split), then
        drain if harvest_every frames are unharvested."""
        k = len(self._buf)
        if k == 0:
            return
        if self._dispatched % self.harvest_every == 0 or self._chunk_threshold is None:
            # A chunk starts here; a copy, as the buffer moves on with the tails.
            self._chunk_threshold = self.state.threshold.clone()
        odom = (torch.stack([self._odometry(o) for o in self._odom_buf])
                if self.odometry_on else None)
        # fused.chunk_step_split with the tails through the track program.
        imgs = fused._chunk_images(self.cam, self.params, torch.stack(self._buf),
                                   self.depth_calib)
        self._buf, self._odom_buf = [], []
        self._hold_program()
        front = fused.chunk_front_end(self.cam, self.params, self._chunk_threshold, imgs)
        with self._enqueuing():
            for i in range(k):
                self.program.run(front, imgs, i, None if odom is None else odom[i])
        self._dispatched += k
        if self._dispatched - self._harvested >= self.harvest_every:
            self._drain()

    def _step(self, imgs: torch.Tensor, odometry):
        self._hold_program()
        with self._enqueuing():
            self.program.run(imgs, self._odometry(odometry) if self.odometry_on else None)
        self._dispatched += 1
        if self._dispatched - self._harvested >= self.harvest_every:
            self._drain()

    def _enqueuing(self):
        """The `tracker_enqueue` stage around queueing frames' replays;
        the host gap since the last drain's ring read ends here."""
        if self._ring_read_at is not None:
            t, outer = self._ring_read_at
            chrono = log.chronometers
            chrono.add("tracker_host_gap", time.perf_counter() - t,
                       chrono.outer_seconds - outer)
            self._ring_read_at = None
        return log.measure("tracker_enqueue")

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
        statistics of every unharvested frame, then any new keyframes.
        On BRIEF256R the frames' keypoints, both images', go to
        fused.EVENTS["rotated keypoints"]; in depth mode their keypoints,
        framepoints (keypoints with a depth in the window) and recovered
        landmarks to fused.EVENTS["depth keypoints"], ["depth
        framepoints"] and ["depth recovered"]."""
        self._drained = True
        upto = self._dispatched
        if upto == self._harvested:
            return
        assert upto - self._harvested <= self.params.ring_size
        with log.measure("tracker_drain_wait"):
            ring = self.state.ring.cpu().numpy()
        self._ring_read_at = (time.perf_counter(), log.chronometers.outer_seconds)
        s = self.stats
        kf_total = self._kf_harvested
        rotated = 0
        depth0 = (s.n_keypoints, s.n_framepoints, s.n_recovered)
        for fi in range(self._harvested, upto):
            row = ring[fi % self.params.ring_size]
            T = self._corrected(row[:16].reshape(4, 4), fi)
            self.trajectory.append(T)
            self._last_pose = T
            n_fp = int(row[fused._R_NFP])
            n_matches = int(row[fused._R_NMATCH])
            s.n_frames += 1
            s.n_keypoints += int(row[fused._R_NKP])
            rotated += int(row[fused._R_NKP]) + int(row[fused._R_NKP_R])
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
        if self.params.descriptor == "BRIEF256R":
            fused.EVENTS["rotated keypoints"] += rotated
        if self.mode == "depth":
            for key, n, n0 in zip(("depth keypoints", "depth framepoints", "depth recovered"),
                                  (s.n_keypoints, s.n_framepoints, s.n_recovered), depth0):
                fused.EVENTS[key] += n - n0
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
        """Step any buffered frames (split: a partial chunk) and harvest
        every stepped frame (call before reading final state)."""
        self._dispatch_chunk()
        self._drain()
