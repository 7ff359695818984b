"""The per-frame tracker step (port of vslam_tpu/tracking/fused.py).

One call of `step` runs the whole per-frame pipeline of the reference's
PoseTracker3D::compute on a device-resident TrackerState: the stereo
front-end (fused kernel K1, or the staged front-end on K2/K3/K4) or the
RGB-D one (FAST and K3 on the intensity image, depth gathered), the
detector-threshold controller, the registration retry ladder, track
propagation, temporary-point promotion, landmark recovery, landmark
spawn + refinement, the local-map trigger with its keyframe snapshot,
the landmark eviction sweep, the adaptive search window, and one row of
the per-frame result ring.

No host reads: the decisions the JAX package takes with lax.cond and
lax.while_loop are taken on the device, through ops/control.py -- the
retry ladder's attempts 2 and 3 each under a cond on the earlier
attempt's rejection, the keyframe snapshot under a cond on the trigger,
the eviction sweep under one on frame_idx, and every Gauss-Newton phase
a while_loop.  The keyframe snapshot rings and the result ring are
updated in place (they are large and only ever appended to); every
other field of the state is replaced.

make_frame_step builds a FrameProgram: static buffers for the state and
the frame's inputs, and on CUDA one captured CUDA graph of the step that
every later frame replays (the JAX package's make_frame_step), its
conds IF nodes and its loops WHILE nodes (control.graph_capture);
FrameProgram.run_chunk replays it k times back to back (make_chunk_step).
Like the JAX package's memoized step functions, make_frame_step and
make_track_step return one program per key for the whole process, so a
second tracker of the same configuration replays the graph the first
captured; trackers hand its state buffers to one another
(FusedPoseTracker._hold_program).

The split pipeline (tracking.batch_frontend, chunk_step_split) runs the
front-end of a whole chunk at once -- one K1 launch over its 2C images,
or one K2 launch for the staged path's level-0 planes -- and then the
same tail per frame; make_track_step's TrackProgram replays that tail.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import NamedTuple

import torch

from vslam_tpu_torch.frontend import dense_brief
from vslam_tpu_torch.frontend import depth as depth_mod
from vslam_tpu_torch.mapping import frame as frame_mod
from vslam_tpu_torch.mapping import landmarks as lm_mod
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.ops import control, lie
from vslam_tpu_torch.solve import gn


class TrackerState(NamedTuple):
    """Complete device-resident tracker state (same fields as the JAX
    package's TrackerState)."""

    prev: frame_mod.FrameState
    table: lm_mod.LandmarkTable
    T_world_cam: torch.Tensor  # (4, 4)
    last_motion: torch.Tensor  # (4, 4) T_cur_prev
    radius_px: torch.Tensor  # f32 scalar
    desc_gate: torch.Tensor  # f32 scalar
    threshold: torch.Tensor  # f32 scalar (FAST)
    next_slot: torch.Tensor  # int32 scalar
    frame_idx: torch.Tensor  # int32 scalar
    has_prev: torch.Tensor  # bool scalar
    localizing: torch.Tensor  # bool scalar: last registration failed
    ring: torch.Tensor  # (RING, RING_W) f32 packed per-frame results
    T_last_kf: torch.Tensor  # (4, 4) pose at the last trigger reset
    frames_since_kf: torch.Tensor  # int32 scalar
    kf_count: torch.Tensor  # int32 scalar: local maps created so far
    free_list: torch.Tensor  # (F,) int32 stack of recycled slots
    free_count: torch.Tensor  # int32 scalar
    kf_pose: torch.Tensor  # (KR, 4, 4) keyframe poses
    kf_frame_idx: torch.Tensor  # (KR,) int32
    kf_n: torch.Tensor  # (KR,) int32 valid snapshot rows
    kf_slots: torch.Tensor  # (KR, K) int32 landmark slots (-1 pad)
    kf_xyz: torch.Tensor  # (KR, K, 3) landmark world positions at snapshot
    kf_desc: torch.Tensor  # (KR, K, 8) int32 landmark descriptors
    kf_uv4: torch.Tensor  # (KR, K, 4) f32 keyframe observations


# Ring row layout: flattened pose (16) + stats.
RING_W = 28
(_R_NKP, _R_NFP, _R_NMATCH, _R_NINL, _R_OK, _R_CHI2, _R_NSPAWN, _R_FIDX,
 _R_KFCOUNT, _R_NRECOVER, _R_STATUS, _R_SPARE) = range(16, 28)


class FusedParams(NamedTuple):
    """Static parameters of the per-frame step (the JAX package's
    FusedParams without the split front-end's switch, which is the
    tracker's; same names and defaults)."""

    capacity: int = 1024
    bin_size: int = 16
    border: int = 20
    mode: str = "stereo"  # stereo | depth
    descriptor: str = "BRIEF256"
    detector: str = "FAST"
    octaves: int = 1
    max_hamming_stereo: int = 60
    epipolar_tol: float = 1.5
    min_disparity: float = 1.0
    max_disparity: float = 200.0
    min_depth: float = 0.3
    max_depth: float = 10.0
    min_track_for_landmark: int = 2
    min_inliers: int = 20
    min_inlier_ratio: float = 0.0
    retry_attempts: int = 3
    enable_recovery: bool = True
    max_recovery_gate: float = 50.0
    radius_min: float = 50.0
    radius_max: float = 150.0
    radius_adaptive_max: float = 60.0
    min_landmarks_to_track: int = 5
    min_delta_ang: float = 0.001
    min_delta_trans: float = 0.01
    gate_min: float = 60.0
    gate_max: float = 90.0
    good_tracking_ratio: float = 0.3
    target_keypoints: int = 700
    target_tolerance: float = 0.1
    lm_min_forced_updates: int = 0
    lm_min_meas_for_opt: int = 0
    lm_max_t_err_depth_ratio: float = 0.0
    threshold_min: float = 5.0
    threshold_max: float = 100.0
    threshold_max_change: float = 10.0
    ring_size: int = 64
    kf_min_distance: float = 0.5
    kf_min_radians: float = 0.5236
    kf_min_frames: int = 4
    kf_min_landmarks: int = 50
    kf_max_landmarks: int = 1024
    kf_ring_size: int = 32
    # RGB-D: bilateral smoothing of the registered depth map
    # (depth_framepoint_generator.cpp:415-421).
    bilateral_depth: bool = False
    enable_eviction: bool = True
    evict_every: int = 32
    evict_age_frames: int = 120
    evict_max_updates: int = 3
    evict_protected_age_frames: int = 600
    free_list_size: int = 16384
    gn_config: gn.GNConfig = gn.GNConfig()


def init_state(cam: cam_ops.CameraParams, params: FusedParams,
               landmark_capacity: int, threshold0: float) -> TrackerState:
    dev = cam.device
    KR, K = params.kf_ring_size, min(params.kf_max_landmarks, params.capacity)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    eye = torch.eye(4, **f32)
    # Every field its own tensor: a FrameProgram writes them in place.
    return TrackerState(
        prev=frame_mod.empty_frame(params.capacity, dev),
        table=lm_mod.empty_table(landmark_capacity, dev),
        T_world_cam=eye,
        last_motion=eye.clone(),
        radius_px=torch.tensor(params.radius_min, **f32),
        desc_gate=torch.tensor(params.gate_min, **f32),
        threshold=torch.tensor(threshold0, **f32),
        next_slot=torch.tensor(0, **i32),
        frame_idx=torch.tensor(0, **i32),
        has_prev=torch.tensor(False, device=dev),
        localizing=torch.tensor(True, device=dev),
        ring=torch.zeros((params.ring_size, RING_W), **f32),
        T_last_kf=eye.clone(),
        frames_since_kf=torch.tensor(0, **i32),
        kf_count=torch.tensor(0, **i32),
        free_list=torch.zeros(params.free_list_size, **i32),
        free_count=torch.tensor(0, **i32),
        kf_pose=eye.repeat(KR, 1, 1),
        kf_frame_idx=torch.full((KR,), -1, **i32),
        kf_n=torch.zeros(KR, **i32),
        kf_slots=torch.full((KR, K), -1, **i32),
        kf_xyz=torch.zeros((KR, K, 3), **f32),
        kf_desc=torch.zeros((KR, K, 8), **i32),
        kf_uv4=torch.zeros((KR, K, 4), **f32),
    )


def gather_kf_desc(kf_desc: torch.Tensor, rows: torch.Tensor,
                   out_cap: int) -> torch.Tensor:
    """Device-side descriptor gather for the relocalizer: ring rows ->
    (R, out_cap, 8) int32, zero-padded past the snapshot width K.

    out_cap is the relocalizer's query width, min(local-map landmark
    cap, front-end capacity) = K.  The JAX package fixes it at 1024,
    which drops every row past 1024 of a wider snapshot."""
    if out_cap < kf_desc.shape[1]:
        raise ValueError(f"query width {out_cap} < snapshot width {kf_desc.shape[1]}")
    out = torch.zeros((rows.shape[0], out_cap, 8), dtype=kf_desc.dtype,
                      device=kf_desc.device)
    out[:, :kf_desc.shape[1]] = kf_desc[rows]
    return out


def push_free_slots(free_list: torch.Tensor, free_count: torch.Tensor,
                    slots: torch.Tensor):
    """Push released slot ids (-1 = skip) onto the device free stack (the
    slots landmark merges absorb); returns (free_list, free_count)."""
    F = free_list.shape[0]
    ok = slots >= 0
    dest = free_count + torch.cumsum(ok.to(torch.int32), 0, dtype=torch.int32) - 1
    push = ok & (dest < F)
    tgt = torch.where(push, dest, 0).to(torch.int64)
    delta = torch.where(push, slots - free_list[tgt], 0).to(free_list.dtype)
    return (free_list.index_add(0, tgt, delta),
            free_count + push.sum(dtype=torch.int32))


def _front_end(cam, params: FusedParams, state: TrackerState, img_l, img_r):
    """Returns (frame, n_kp, n_fp, planes); planes (the dense BRIEF maps
    kept for landmark recovery: (2, 8, H, W) stereo, (8, H, W) RGB-D) is
    None when recovery is off or the descriptor is ORB256 (its recovery
    describes the images).  In depth mode img_r is the registered depth
    map in meters."""
    want_planes = params.enable_recovery and params.descriptor != "ORB256"
    if params.mode == "stereo":
        out = frame_mod.stereo_frontend_core(
            cam, img_l, img_r, state.threshold,
            params.max_hamming_stereo, params.epipolar_tol,
            params.min_disparity, params.max_disparity,
            capacity=params.capacity, bin_size=params.bin_size,
            border=params.border, descriptor=params.descriptor,
            detector=params.detector, want_planes=want_planes,
            octaves=params.octaves,
        )
    else:
        out = frame_mod.process_depth_frame(
            cam, img_l, img_r, state.threshold, params.min_depth, params.max_depth,
            capacity=params.capacity, bin_size=params.bin_size, border=params.border,
            descriptor=params.descriptor, detector=params.detector,
            want_planes=want_planes, octaves=params.octaves,
        )
    return out if want_planes else out + (None,)


def _register_depth_input(cam, params: FusedParams, depth_m, depth_calib=None):
    """The depth image as the front-end reads it: reprojected into the
    RGB camera when the sensors are not aligned (depth_calib = (K_depth^-1,
    T_rgb_depth)), then bilateral-smoothed if configured."""
    if depth_calib is not None:
        depth_m = depth_mod.register_depth(cam, depth_m, *depth_calib)
    if params.bilateral_depth:
        depth_m = depth_mod.bilateral_filter_depth(depth_m)
    return depth_m


def _spawn_and_update(cam, params: FusedParams, state: TrackerState, cur):
    """Landmark allocation + batched refinement.  Allocation draws
    recycled slots from the free-list stack first, then fresh rows from
    the next_slot watermark (a prefix-sum rank per spawning point)."""
    table = state.table
    cap_lm = table.capacity
    F = state.free_list.shape[0]
    needs = (cur.valid & cur.reliable & (cur.landmark_slot < 0)
             & (cur.track_len >= params.min_track_for_landmark))
    order = torch.cumsum(needs.to(torch.int32), 0, dtype=torch.int32) - 1
    n_needs = needs.sum(dtype=torch.int32)
    fc = state.free_count
    # Rank r takes free_list[fc-1-r] while r < fc, else next_slot + (r - fc).
    slot_free = state.free_list[torch.clamp(fc - 1 - order, 0, F - 1).to(torch.int64)]
    slot = torch.where(order < fc, slot_free, state.next_slot + (order - fc))
    slot = torch.where(needs & (slot < cap_lm) & (slot >= 0), slot, -1).to(torch.int32)
    fresh = slot >= 0
    n_spawned = fresh.sum(dtype=torch.int32)
    free_count = fc - torch.minimum(n_needs, fc)
    next_slot = torch.clamp(
        state.next_slot + torch.clamp(n_needs - fc, min=0), max=cap_lm
    ).to(torch.int32)
    cur = cur._replace(landmark_slot=torch.where(fresh, slot, cur.landmark_slot))
    # New landmarks belong to the NEXT local map to be created (= kf_count).
    table = lm_mod.spawn_and_update_observed(
        cam, table, state.T_world_cam, cur.landmark_slot, fresh, cur.p_cam,
        cur.uv4, cur.desc, cur.valid, state.frame_idx,
        origin_kf=state.kf_count,
        mode=params.mode,
        min_forced_updates=params.lm_min_forced_updates,
        min_meas_for_opt=params.lm_min_meas_for_opt,
        max_t_err_depth_ratio=params.lm_max_t_err_depth_ratio,
    )
    return table, cur, next_slot, n_spawned, free_count


def _take_snapshot(params, state, table, cur, T_world_cam, lm_backed, n_lm_backed, fire):
    """The keyframe snapshot under control.cond on `fire` (the JAX
    package's lax.cond): ring row kf_count % KR of each snapshot ring is
    rewritten in place, with its old contents where fire is false.
    Returns the table with the snapshotted slots protected from recycling."""
    row = (state.kf_count % params.kf_ring_size).to(torch.int64).reshape(1)
    rings = (state.kf_pose, state.kf_frame_idx, state.kf_n, state.kf_slots, state.kf_xyz,
             state.kf_desc, state.kf_uv4)

    def take():
        KW = state.kf_slots.shape[1]
        n_snap = torch.clamp(n_lm_backed, max=KW)
        perm = frame_mod.stable_partition_perm(lm_backed)[:KW]
        rank = torch.arange(KW, device=perm.device)
        slots_s = torch.where(rank < n_snap, cur.landmark_slot[perm], -1)
        g = torch.clamp(slots_s, min=0).to(torch.int64)
        new = (T_world_cam, state.frame_idx, n_snap, slots_s, table.xyz_w[g], table.desc[g],
               cur.uv4[perm])
        return (tuple(n.to(r.dtype)[None] for r, n in zip(rings, new)),
                frame_mod._put_rows(table.protected, g, slots_s >= 0, True))

    def keep():
        return tuple(r.index_select(0, row) for r in rings), table.protected

    rows, protected = control.cond(fire, take, keep, name="snapshot")
    for ring, new in zip(rings, rows):
        ring.index_copy_(0, row, new)
    return table._replace(protected=protected)


def _evict(params, state, table, cur, free_list, free_count):
    """Invalidate stale low-quality unprotected slots (and protected ones
    unseen for much longer), none referenced by the live frame, and push
    them on the free stack in slot order: a control.cond on the frames
    with frame_idx % evict_every == evict_every - 1 (the JAX package's
    lax.cond)."""
    F = free_list.shape[0]
    cap = table.capacity
    dev = free_list.device

    def sweep(valid, protected, free_list, free_count):
        age = state.frame_idx - table.last_seen
        referenced = frame_mod._put_rows(
            torch.zeros(cap, dtype=torch.bool, device=dev),
            torch.clamp(cur.landmark_slot, min=0).to(torch.int64),
            cur.landmark_slot >= 0, True,
        )
        cand_unprot = (~protected & (age > params.evict_age_frames)
                       & (table.n_updates <= params.evict_max_updates))
        cand_prot = protected & (age > params.evict_protected_age_frames)
        cand = valid & ~referenced & (cand_unprot | cand_prot)
        dest = free_count + torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32) - 1
        push = cand & (dest < F)
        n_push = push.sum(dtype=torch.int32)
        ids = torch.arange(cap, dtype=torch.int32, device=dev)
        pushed_ids = torch.sort(torch.where(push, ids, cap)).values
        pos = torch.arange(F, dtype=torch.int32, device=dev)
        appended = pushed_ids[torch.clamp(pos - free_count, 0, cap - 1).to(torch.int64)]
        in_window = (pos >= free_count) & (pos < free_count + n_push)
        return (valid & ~push, protected & ~push, torch.where(in_window, appended, free_list),
                free_count + n_push)

    due = state.frame_idx % params.evict_every == params.evict_every - 1
    valid, protected, free_list, free_count = control.cond(
        due, sweep, lambda *a: a, (table.valid, table.protected, free_list, free_count),
        name="eviction")
    return table._replace(valid=valid, protected=protected), free_list, free_count


def _ladder_inputs(params: FusedParams, state: TrackerState, T_guess):
    """(radius, gate, motion guess) of each attempt of the registration
    retry ladder (pose_tracker_3d.cpp:300-419).  Localizing => the first
    attempt matches by appearance: window past the image, identity guess,
    maximum descriptor gate (pose_tracker_3d.cpp:87-92,227-239)."""
    dev = T_guess.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    appearance = state.localizing & state.has_prev
    return [
        (torch.where(appearance, 1e6, state.radius_px),
         torch.where(appearance, params.gate_max, state.desc_gate),
         torch.where(appearance, eye, T_guess)),
        (torch.clamp(2.0 * state.radius_px, max=params.radius_max),
         torch.clamp(state.desc_gate + 10.0, max=params.gate_max),
         T_guess),
        (torch.full((), params.radius_max, device=dev),
         torch.full((), params.gate_max, device=dev),
         eye),
    ][:max(params.retry_attempts, 1)]


def _accept(params: FusedParams, r) -> torch.Tensor:
    ratio = r.n_inliers.to(torch.float32) / torch.clamp(r.n_matches.to(torch.float32), min=1.0)
    return (r.converged & (r.n_inliers >= params.min_inliers)
            & (r.n_inliers >= params.min_landmarks_to_track)
            & (ratio >= params.min_inlier_ratio))


def _register(cam, params: FusedParams, state: TrackerState, cur, T_guess):
    """The retry ladder: attempt 1, then attempt 2 under a control.cond on
    attempt 1's rejection and attempt 3 under one on attempt 2's (the JAX
    package's nested lax.cond), each solved alone
    (frame.track_and_align_batch at A = 1).  The result is the first
    accepted attempt's, else the last's."""
    weights = lm_mod.landmark_weights(state.table, state.prev.landmark_slot)
    ladder = _ladder_inputs(params, state, T_guess)

    def attempt(k):
        radius, gate, guess = ladder[k]
        return frame_mod._one_attempt(cam, state.prev, cur, guess, radius,
                                      gate.to(torch.int32), weights, params.gn_config,
                                      depth=params.mode != "stereo")

    res = attempt(0)
    for k in range(1, len(ladder)):
        res = control.cond(_accept(params, res), lambda r: r,
                           lambda r, k=k: attempt(k), (res,), name=f"attempt {k + 1}")
    return res


def _step_tail(cam, params: FusedParams, state: TrackerState, cur, n_kp, n_fp,
               planes, img_l, img_r, motion_model_on: bool, T_odom=None):
    """Everything after the front-end; returns the new TrackerState.

    img_l, img_r: the frame's images (depth mode: the intensity image and
    the registered depth map in meters); motion_model_on: constant-
    velocity guess (else identity), a bool or a bool tensor on the device;
    T_odom: an external motion guess T_cur_prev that replaces both when
    given.  No value is read back to the host."""
    dev = state.T_world_cam.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    # Detector threshold controller (base_framepoint_generator.cpp:440-459)
    # with the reference's dead band.
    tk = float(params.target_keypoints)
    err = (n_kp.to(torch.float32) - tk) / tk
    err = torch.where(torch.abs(err) <= params.target_tolerance, 0.0, err)
    mc = params.threshold_max_change
    threshold = torch.clamp(state.threshold + torch.clamp(err * mc, -mc, mc),
                            params.threshold_min, params.threshold_max)

    if T_odom is not None:
        T_guess = T_odom
    elif isinstance(motion_model_on, torch.Tensor):
        T_guess = torch.where(motion_model_on, state.last_motion, eye)
    else:
        T_guess = state.last_motion if motion_model_on else eye

    res = _register(cam, params, state, cur, T_guess)
    ok = _accept(params, res) & state.has_prev

    motion = torch.where(ok, res.T_cur_prev, T_guess)
    motion = torch.where(state.has_prev, motion, T_guess)
    # Movement significance gate (pose_tracker_3d.cpp:145,378).
    stationary = (ok & (lie.rotation_angle(motion[:3, :3]) < params.min_delta_ang)
                  & (torch.linalg.vector_norm(motion[:3, 3]) < params.min_delta_trans))
    motion = torch.where(stationary, eye, motion)
    T_world_cam = state.T_world_cam @ lie.inverse(motion)

    # Track propagation only on success (reference breakTrack otherwise).
    prop = frame_mod.propagate_tracks(state.prev, cur, res.prev_to_cur)
    cur = frame_mod.FrameState(*(torch.where(ok, a, b) for a, b in zip(prop, cur)))
    cur, _ = frame_mod.promote_temporary_points(
        cam, state.prev, cur, motion, res.prev_to_cur, enabled=ok,
    )
    n_recovered = torch.zeros((), dtype=torch.int32, device=dev)
    if params.enable_recovery and params.mode == "stereo":
        cur, n_recovered = frame_mod.recover_lost_landmarks(
            cam, state.prev, cur, motion, res.prev_to_cur, planes, img_l, img_r,
            torch.clamp(state.desc_gate, max=params.max_recovery_gate),
            params.min_disparity, params.max_disparity,
            border=params.border, descriptor=params.descriptor, enabled=ok,
        )
    elif params.enable_recovery:
        cur, n_recovered = frame_mod.recover_lost_landmarks_depth(
            cam, state.prev, cur, motion, res.prev_to_cur, planes, img_l, img_r,
            torch.clamp(state.desc_gate, max=params.max_recovery_gate),
            params.min_depth, params.max_depth,
            border=params.border, descriptor=params.descriptor, enabled=ok,
        )

    table, cur, next_slot, n_spawned, free_count = _spawn_and_update(
        cam, params, state._replace(T_world_cam=T_world_cam), cur
    )

    # Local-map trigger + keyframe snapshot (world_map.cpp:108-111).
    dT = lie.inverse(state.T_last_kf) @ T_world_cam
    frames_since = state.frames_since_kf + 1
    geo_trigger = state.has_prev & (
        (lie.rotation_angle(dT[:3, :3]) > params.kf_min_radians)
        | ((torch.linalg.vector_norm(dT[:3, 3]) > params.kf_min_distance)
           & (frames_since >= params.kf_min_frames))
    )
    lm_backed = cur.valid & (cur.landmark_slot >= 0)
    n_lm_backed = lm_backed.sum(dtype=torch.int32)
    fire = geo_trigger & (n_lm_backed >= params.kf_min_landmarks)
    # The window resets whenever the geometric trigger fires, even when
    # too few landmarks exist to snapshot.
    T_last_kf = torch.where(geo_trigger, T_world_cam, state.T_last_kf)
    frames_since = torch.where(geo_trigger, 0, frames_since)
    table = _take_snapshot(params, state, table, cur, T_world_cam,
                           lm_backed, n_lm_backed, fire)
    kf_count = state.kf_count + fire.to(torch.int32)

    free_list = state.free_list
    if params.enable_eviction:
        table, free_list, free_count = _evict(params, state, table, cur,
                                              free_list, free_count)

    # Adaptive search window (pose_tracker_3d.cpp:251-288).
    n_prev = torch.clamp(state.prev.valid.sum(), min=1)
    poor = res.n_matches.to(torch.float32) / n_prev.to(torch.float32) < params.good_tracking_ratio
    radius = torch.where(
        poor,
        torch.clamp(state.radius_px * 1.2, max=params.radius_adaptive_max),
        torch.clamp(state.radius_px * 0.95, min=params.radius_min),
    )
    gate = torch.where(
        poor,
        torch.clamp(state.desc_gate + 5.0, max=params.gate_max),
        torch.clamp(state.desc_gate - 1.0, min=params.gate_min),
    )

    stats = torch.stack([
        t.to(torch.float32) for t in (
            n_kp, n_fp, res.n_matches, res.n_inliers, ok | ~state.has_prev,
            res.mean_chi2, n_spawned, state.frame_idx, kf_count, n_recovered,
            ok, torch.zeros((), device=dev),
        )
    ])
    ring_row = (state.frame_idx % params.ring_size).to(torch.int64).reshape(1)
    state.ring.index_copy_(0, ring_row, torch.cat([T_world_cam.reshape(16), stats])[None])

    return state._replace(
        prev=cur,
        table=table,
        T_world_cam=T_world_cam,
        last_motion=torch.where(state.has_prev, motion, state.last_motion),
        radius_px=radius,
        desc_gate=gate,
        threshold=threshold,
        next_slot=next_slot,
        frame_idx=state.frame_idx + 1,
        has_prev=torch.ones_like(state.has_prev),
        localizing=~ok,
        T_last_kf=T_last_kf,
        frames_since_kf=frames_since.to(torch.int32),
        kf_count=kf_count,
        free_list=free_list,
        free_count=free_count,
    )


def _chunk_images(cam, params: FusedParams, chunk: torch.Tensor, depth_calib=None):
    """(k, 2, H, W) frames as the front-end and the tails read them: f32,
    and in depth mode the depth registered and filtered frame by frame
    (the registration has no batched form)."""
    imgs = chunk.to(torch.float32)
    if params.mode != "depth":
        return imgs
    return torch.stack([
        torch.stack([f[0], _register_depth_input(cam, params, f[1], depth_calib)])
        for f in imgs])


def chunk_front_end(cam, params: FusedParams, threshold: torch.Tensor, imgs: torch.Tensor):
    """The front-end of k frames at one threshold (frame_mod.frontend_chunk):
    (FrameState with (k, ...) fields, n_kp (k,), n_fp (k,), planes or
    None); imgs from _chunk_images."""
    return frame_mod.frontend_chunk(
        cam, imgs, threshold, mode=params.mode,
        max_hamming_stereo=params.max_hamming_stereo, epipolar_tol=params.epipolar_tol,
        min_disparity=params.min_disparity, max_disparity=params.max_disparity,
        min_depth=params.min_depth, max_depth=params.max_depth,
        capacity=params.capacity, bin_size=params.bin_size, border=params.border,
        descriptor=params.descriptor, detector=params.detector,
        want_planes=params.enable_recovery and params.descriptor != "ORB256",
        octaves=params.octaves,
    )


def track_step(cam, params: FusedParams, state: TrackerState, frames_b, n_kp_b, n_fp_b,
               planes_b, imgs: torch.Tensor, idx: int, motion_model_on: bool,
               T_odom=None) -> TrackerState:
    """The split pipeline's sequential half: frame idx of a precomputed
    chunk front-end through the tracking and mapping tail, the same
    _step_tail as step() (the JAX package's make_track_step)."""
    cur = frame_mod.FrameState(*(f[idx] for f in frames_b))
    planes = None if planes_b is None else planes_b[idx]
    return _step_tail(cam, params, state, cur, n_kp_b[idx], n_fp_b[idx], planes,
                      imgs[idx, 0], imgs[idx, 1], motion_model_on, T_odom)


def chunk_step_split(cam, params: FusedParams, state: TrackerState, chunk: torch.Tensor,
                     k: int, motion_model_on: bool, odom_chunk=None, depth_calib=None,
                     threshold=None) -> TrackerState:
    """The split (chunk-batched) step of the JAX package's
    make_chunk_step_split: the front-end of frames 0..k-1 of chunk (C, 2,
    H, W) in one batched call at the detector threshold of the chunk's
    start (state.threshold unless `threshold` is given), then the k
    sequential tails.  The thresholds the tails compute are seen by the
    next chunk only -- the one intended difference from k step() calls.
    Padded rows of a tail chunk (k < C) are not computed.  odom_chunk:
    (C, 4, 4) per-frame motion guesses T_cur_prev, or None."""
    imgs = _chunk_images(cam, params, chunk[:k], depth_calib)
    front = chunk_front_end(cam, params, state.threshold if threshold is None else threshold,
                            imgs)
    for i in range(k):
        state = track_step(cam, params, state, *front, imgs, i, motion_model_on,
                           None if odom_chunk is None else odom_chunk[i])
    return state


def step(cam, params: FusedParams, state: TrackerState, imgs: torch.Tensor,
         motion_model_on: bool, T_odom=None, depth_calib=None) -> TrackerState:
    """One frame: imgs is (2, H, W) on the state's device, the stereo pair
    (uint8 or f32), or in depth mode the f32 intensity image and depth in
    meters; depth_calib (K_depth, T_rgb_depth) registers a misaligned
    depth sensor's image first."""
    img_l = imgs[0].to(torch.float32)
    img_r = imgs[1].to(torch.float32)
    if params.mode == "depth":
        img_r = _register_depth_input(cam, params, img_r, depth_calib)
    cur, n_kp, n_fp, planes = _front_end(cam, params, state, img_l, img_r)
    return _step_tail(cam, params, state, cur, n_kp, n_fp, planes, img_l, img_r,
                      motion_model_on, T_odom)


def state_tensors(state: TrackerState) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor of the state, the frame's and the
    table's fields as "prev.uv4", "table.valid"."""
    out = []
    for name, v in zip(state._fields, state):
        if isinstance(v, tuple):
            out.extend((f"{name}.{n}", t) for n, t in zip(v._fields, v))
        else:
            out.append((name, v))
    return out


def assign_state(dst: TrackerState, src: TrackerState) -> None:
    """Copy src into dst's tensors in place, field by field.

    dst is a FrameProgram's static buffers, which a captured graph reads
    and writes by address: a writer that rebound a field instead would
    leave the graph on stale buffers.  A field whose shape or dtype
    differs raises ValueError; a src field that is dst's own tensor (a
    ring written in place) is skipped; one that shares memory with
    another dst buffer is copied out first, so no write lands before the
    read it would spoil."""
    pairs = []
    for (name, d), (_, s) in zip(state_tensors(dst), state_tensors(src)):
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"tracker state {name}: {tuple(s.shape)} {s.dtype} does not "
                             f"fit the buffer's {tuple(d.shape)} {d.dtype}")
        if s is not d:
            pairs.append((d, s))
    owned = {d.untyped_storage().data_ptr() for _, d in state_tensors(dst)}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in owned else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


@contextlib.contextmanager
def withheld_launches(record: dict):
    """Counts the kernel launches the block's wrappers make into record
    (name -> (launches, launches by batch size)) and takes them off the
    counters again: a capture launches nothing, its replays do."""
    counters = dense_brief.kernel_counters()
    before = {k: (c.launches, Counter(c.batches)) for k, c in counters.items()}
    try:
        yield record
    finally:
        for k, c in counters.items():
            n0, b0 = before[k]
            record[k] = (c.launches - n0, c.batches - b0)
            c.launches = n0
            c.batches.clear()
            c.batches.update(b0)


# Frames run eagerly, captures and replays of every program (CUDA only).
EVENTS: Counter = Counter()


class _Program:
    """One frame's work as one device program over static buffers: the
    TrackerState (`state`), the motion flag, T_odom (4, 4) when odometry
    guesses are on, and each subclass's inputs.  A subclass's run()
    copies its inputs into its buffers and calls _execute(), whose body
    copies the new state back into the state buffers.

    On CUDA the first frame runs eagerly (it builds the kernels and makes
    every cache, cuBLAS handle and launcher attribute call outside any
    capture; its loops run to their caps and its conds compute both
    branches); the second captures one frame with control.graph_capture
    (which executes nothing, so the state does not advance; the conds
    become IF nodes and the loops WHILE nodes) and replays it, and every
    later frame is one replay: the host enqueues the graph and reads
    nothing.  A failed capture or replay raises.  On the CPU the same body
    runs into the same buffers, so only the replay differs.  `record`
    holds the capture's control.Record: after a replay, its loops'
    iterations and its conds' predicates.

    Kernel launch counts (dense_brief.kernel_counters) count Python
    calls; a replay adds the launches its capture made once each, and
    the capture itself counts none.  On CUDA, EVENTS counts the frames
    every program ran eagerly ("eager"), its captures ("capture") and its
    replays ("replay").

    A program of make_frame_step / make_track_step is shared by the
    trackers of equal keys; `holder` is a weak reference to the tracker
    whose state its buffers hold (None: nobody's)."""

    def __init__(self, cam, params: FusedParams, state: TrackerState, motion_model_on: bool,
                 odometry: bool):
        buffers = [t.untyped_storage().data_ptr() for _, t in state_tensors(state)]
        if len(set(buffers)) != len(buffers):
            raise ValueError(f"{type(self).__name__}: two state fields share memory (the "
                             "program writes each in place)")
        dev = state.T_world_cam.device
        self.cam, self.params, self.state = cam, params, state
        self._eye = torch.eye(4, dtype=torch.float32, device=dev)
        self.T_odom = self._eye.clone() if odometry else None
        self.motion = torch.full((), bool(motion_model_on), dtype=torch.bool, device=dev)
        self.graph = None
        self.frames = 0  # frames run
        self.capture_seconds = None
        self.record = None  # control.Record of the capture
        # Per replay: kernel name -> (launches, launches by batch size).
        self.replay_launches: dict[str, tuple[int, Counter]] = {}
        self.holder = None

    @property
    def device(self) -> torch.device:
        return self.state.T_world_cam.device

    def _body(self):
        raise NotImplementedError

    def capture(self):
        """Capture one frame into the CUDA graph (_execute does it at the
        second frame; a caller may do it earlier, after one frame)."""
        if self.device.type != "cuda" or self.frames == 0:
            raise RuntimeError(f"{type(self).__name__}.capture: needs one eager frame on "
                               "CUDA first")
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with withheld_launches(self.replay_launches), \
                control.graph_capture(graph, self.device) as record:
            self._body()
        self.record = record
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        EVENTS["capture"] += 1

    def _replay(self):
        self.graph.replay()
        counters = dense_brief.kernel_counters()
        for k, (n, batches) in self.replay_launches.items():
            counters[k].launches += n
            counters[k].batches.update(batches)

    def _execute(self, T_odom: torch.Tensor | None):
        if self.T_odom is not None:
            self.T_odom.copy_(self._eye if T_odom is None else T_odom)
        if self.device.type != "cuda":
            self._body()
        elif self.frames == 0:
            self._body()
            EVENTS["eager"] += 1
        else:
            if self.graph is None:
                self.capture()
            self._replay()
            EVENTS["replay"] += 1
        self.frames += 1


class FrameProgram(_Program):
    """The per-frame step as one device program (the JAX package's
    make_frame_step; run_chunk is its make_chunk_step), with the frame's
    images (2, H, W) as its input buffer."""

    def __init__(self, cam, params: FusedParams, state: TrackerState, motion_model_on: bool,
                 frame_dtype: torch.dtype, odometry: bool = False, depth_calib=None):
        super().__init__(cam, params, state, motion_model_on, odometry)
        self.depth_calib = depth_calib
        self.imgs = torch.zeros((2, cam.rows, cam.cols), dtype=frame_dtype,
                                device=self.device)

    def _body(self):
        assign_state(self.state, step(self.cam, self.params, self.state, self.imgs,
                                      self.motion, self.T_odom, self.depth_calib))

    def run(self, imgs: torch.Tensor, T_odom: torch.Tensor | None = None) -> None:
        """One frame: imgs (2, H, W) as step() takes them (on any device;
        from the state's device the copy reads nothing back); T_odom the
        frame's motion guess T_cur_prev (identity when None) if the
        program takes odometry guesses."""
        self.imgs.copy_(imgs)
        self._execute(T_odom)

    def run_chunk(self, chunk: torch.Tensor, k: int, odom_chunk=None) -> None:
        """Frames 0..k-1 of chunk (C, 2, H, W) (a tail chunk has k < C),
        with odom_chunk (C, 4, 4) per-frame motion guesses or None: k
        replays back to back, nothing read back in between (the JAX
        package's fori_loop over the same body)."""
        for i in range(k):
            self.run(chunk[i], None if odom_chunk is None else odom_chunk[i])


def make_frame_step(cam, params: FusedParams, landmark_capacity: int,
                    frame_dtype: torch.dtype, odometry: bool = False,
                    depth_calib=None) -> FrameProgram:
    """The process's FrameProgram for these values (the JAX package's
    memoized make_frame_step): equal keys (_memo_key) give the same
    program, so a later tracker replays the graph an earlier one captured.
    The program owns its camera, calibration and state buffers; trackers
    take turns on it through a hand-off (FusedPoseTracker._hold_program).
    Code that holds a program against the eager step builds an unshared
    FrameProgram itself."""
    key = ("frame",) + _memo_key(cam, params, landmark_capacity, frame_dtype, odometry,
                                 depth_calib)
    if key not in _PROGRAMS:
        cam, depth_calib = _own_copy(cam), _own_copy(depth_calib)
        _PROGRAMS[key] = FrameProgram(cam, params, init_state(cam, params, landmark_capacity, 0.0),
                                      False, frame_dtype, odometry, depth_calib)
    return _PROGRAMS[key]


class TrackProgram(_Program):
    """The split pipeline's sequential half as one device program a frame
    (the JAX package's make_track_step): the tracking and mapping tail of
    frame idx of a chunk front-end (chunk_front_end).  Its input buffers
    -- the frame's FrameState, n_kp, n_fp, dense planes and images -- are
    made at its first frame in the shapes and types the front-end gives."""

    def __init__(self, cam, params: FusedParams, state: TrackerState, motion_model_on: bool,
                 odometry: bool = False):
        super().__init__(cam, params, state, motion_model_on, odometry)
        self.inputs = None  # (cur, n_kp, n_fp, planes or None, imgs)

    def _body(self):
        cur, n_kp, n_fp, planes, imgs = self.inputs
        assign_state(self.state, _step_tail(self.cam, self.params, self.state, cur, n_kp,
                                            n_fp, planes, imgs[0], imgs[1], self.motion,
                                            self.T_odom))

    def run(self, front, imgs: torch.Tensor, idx: int,
            T_odom: torch.Tensor | None = None) -> None:
        """Frame idx of front = chunk_front_end(...) over imgs (k, 2, H, W)
        from _chunk_images; T_odom as FrameProgram.run's."""
        frames_b, n_kp_b, n_fp_b, planes_b = front
        values = (frame_mod.FrameState(*(f[idx] for f in frames_b)), n_kp_b[idx],
                  n_fp_b[idx], None if planes_b is None else planes_b[idx], imgs[idx])
        if self.inputs is None:
            self.inputs = (frame_mod.FrameState(*map(torch.empty_like, values[0])),
                           *(None if v is None else torch.empty_like(v) for v in values[1:]))
        for dst, src in zip((*self.inputs[0], *self.inputs[1:]), (*values[0], *values[1:])):
            if dst is not None:
                dst.copy_(src)
        self._execute(T_odom)


def make_track_step(cam, params: FusedParams, landmark_capacity: int,
                    odometry: bool = False) -> TrackProgram:
    """The process's TrackProgram for these values (the JAX package's
    memoized make_track_step; see make_frame_step)."""
    key = ("track",) + _memo_key(cam, params, landmark_capacity, None, odometry, None)
    if key not in _PROGRAMS:
        cam = _own_copy(cam)
        _PROGRAMS[key] = TrackProgram(cam, params, init_state(cam, params, landmark_capacity, 0.0),
                                      False, odometry)
    return _PROGRAMS[key]


# The programs of make_frame_step and make_track_step, by _memo_key.
_PROGRAMS: dict[tuple, _Program] = {}


def _values(t) -> tuple:
    return tuple(t.detach().cpu().reshape(-1).tolist())


def _memo_key(cam, params: FusedParams, landmark_capacity: int, frame_dtype, odometry: bool,
              depth_calib) -> tuple:
    """Everything a captured program bakes in, by value: the camera's
    tensors and sizes, the parameters, the landmark capacity, the frame
    dtype, the odometry flag, the depth calibration and the device.  The
    motion flag is a buffer of the program, set by the tracker holding it."""
    return (_values(cam.K), _values(cam.baseline_m), cam.rows, cam.cols,
            _values(cam.T_cam_robot), _values(cam.K_inv), cam.depth_scale, params,
            int(landmark_capacity), frame_dtype, bool(odometry),
            None if depth_calib is None else tuple(map(_values, depth_calib)), cam.device)


def _own_copy(x):
    """A camera (or calibration pair) whose tensors are the program's own:
    a captured graph reads them by address."""
    if x is None:
        return None
    if isinstance(x, cam_ops.CameraParams):
        return x._replace(K=x.K.clone(), baseline_m=x.baseline_m.clone(),
                          T_cam_robot=x.T_cam_robot.clone(), K_inv=x.K_inv.clone())
    return tuple(t.clone() for t in x)


def clear_programs() -> None:
    """Forget every shared program (the next tracker builds its own)."""
    _PROGRAMS.clear()


def clone_state(state: TrackerState) -> TrackerState:
    """A copy of the state in tensors of its own, field by field."""
    return TrackerState(*(type(v)(*(t.clone() for t in v)) if isinstance(v, tuple)
                          else v.clone() for v in state))
