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

Host syncs: three decisions the JAX package takes with lax.cond are
Python `if`s on a device scalar here — the retry ladder (one read per
frame, two when the first attempt fails), the keyframe snapshot and the
eviction sweep (one read each per frame).  Everything else stays on the
device.  The keyframe snapshot rings and the result ring are updated in
place (they are large and only ever appended to); every other field of
the state is replaced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.frontend import depth as depth_mod
from vslam_tpu_torch.mapping import frame as frame_mod
from vslam_tpu_torch.mapping import landmarks as lm_mod
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.ops import lie
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
    FusedParams without the split front-end's switch; same names and
    defaults)."""

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
    return TrackerState(
        prev=frame_mod.empty_frame(params.capacity, dev),
        table=lm_mod.empty_table(landmark_capacity, dev),
        T_world_cam=eye,
        last_motion=eye,
        radius_px=torch.tensor(params.radius_min, **f32),
        desc_gate=torch.tensor(params.gate_min, **f32),
        threshold=torch.tensor(threshold0, **f32),
        next_slot=torch.tensor(0, **i32),
        frame_idx=torch.tensor(0, **i32),
        has_prev=torch.tensor(False, device=dev),
        localizing=torch.tensor(True, device=dev),
        ring=torch.zeros((params.ring_size, RING_W), **f32),
        T_last_kf=eye,
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
    None when recovery is off.  In depth mode img_r is the registered
    depth map in meters."""
    if params.mode == "stereo":
        out = frame_mod.stereo_frontend_core(
            cam, img_l, img_r, state.threshold,
            params.max_hamming_stereo, params.epipolar_tol,
            params.min_disparity, params.max_disparity,
            capacity=params.capacity, bin_size=params.bin_size,
            border=params.border, descriptor=params.descriptor,
            detector=params.detector, want_planes=params.enable_recovery,
            octaves=params.octaves,
        )
    else:
        out = frame_mod.process_depth_frame(
            cam, img_l, img_r, state.threshold, params.min_depth, params.max_depth,
            capacity=params.capacity, bin_size=params.bin_size, border=params.border,
            descriptor=params.descriptor, detector=params.detector,
            want_planes=params.enable_recovery, octaves=params.octaves,
        )
    return out if params.enable_recovery else out + (None,)


def _register_depth_input(cam, params: FusedParams, depth_m, depth_calib=None):
    """The depth image as the front-end reads it: reprojected into the
    RGB camera when the sensors are not aligned (depth_calib = (K_depth,
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


def _take_snapshot(params, state, table, cur, T_world_cam, lm_backed, n_lm_backed):
    """Write keyframe snapshot row kf_count % KR in place; returns the
    table with the snapshotted slots protected from recycling."""
    KW = state.kf_slots.shape[1]
    n_snap = torch.clamp(n_lm_backed, max=KW)
    perm = frame_mod.stable_partition_perm(lm_backed)[:KW]
    rank = torch.arange(KW, device=perm.device)
    slots_s = torch.where(rank < n_snap, cur.landmark_slot[perm], -1)
    g = torch.clamp(slots_s, min=0).to(torch.int64)
    row = (state.kf_count % params.kf_ring_size).to(torch.int64).reshape(1)
    state.kf_pose.index_copy_(0, row, T_world_cam[None])
    state.kf_frame_idx.index_copy_(0, row, state.frame_idx.reshape(1))
    state.kf_n.index_copy_(0, row, n_snap.reshape(1))
    state.kf_slots.index_copy_(0, row, slots_s[None])
    state.kf_xyz.index_copy_(0, row, table.xyz_w[g][None])
    state.kf_desc.index_copy_(0, row, table.desc[g][None])
    state.kf_uv4.index_copy_(0, row, cur.uv4[perm][None])
    return table._replace(
        protected=frame_mod._put_rows(table.protected, g, slots_s >= 0, True))


def _evict(params, state, table, cur, free_list, free_count):
    """Invalidate stale low-quality unprotected slots (and protected ones
    unseen for much longer), none referenced by the live frame, and push
    them on the free stack in slot order."""
    F = free_list.shape[0]
    cap = table.capacity
    dev = free_list.device
    age = state.frame_idx - table.last_seen
    referenced = frame_mod._put_rows(
        torch.zeros(cap, dtype=torch.bool, device=dev),
        torch.clamp(cur.landmark_slot, min=0).to(torch.int64),
        cur.landmark_slot >= 0, True,
    )
    cand_unprot = (~table.protected & (age > params.evict_age_frames)
                   & (table.n_updates <= params.evict_max_updates))
    cand_prot = table.protected & (age > params.evict_protected_age_frames)
    cand = table.valid & ~referenced & (cand_unprot | cand_prot)
    dest = free_count + torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32) - 1
    push = cand & (dest < F)
    n_push = push.sum(dtype=torch.int32)
    ids = torch.arange(cap, dtype=torch.int32, device=dev)
    pushed_ids = torch.sort(torch.where(push, ids, cap)).values
    pos = torch.arange(F, dtype=torch.int32, device=dev)
    appended = pushed_ids[torch.clamp(pos - free_count, 0, cap - 1).to(torch.int64)]
    in_window = (pos >= free_count) & (pos < free_count + n_push)
    table = table._replace(valid=table.valid & ~push,
                           protected=table.protected & ~push)
    return table, torch.where(in_window, appended, free_list), free_count + n_push


def _step_tail(cam, params: FusedParams, state: TrackerState, cur, n_kp, n_fp,
               planes, motion_model_on: bool, T_odom=None, depth_m=None):
    """Everything after the front-end; returns the new TrackerState.

    motion_model_on: constant-velocity guess (else identity); T_odom: an
    external motion guess T_cur_prev that replaces both when given;
    depth_m: the registered depth map (depth mode)."""
    dev = state.T_world_cam.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    img_shape = (cam.rows, cam.cols)

    # Detector threshold controller (base_framepoint_generator.cpp:440-459)
    # with the reference's dead band.
    tk = float(params.target_keypoints)
    err = (n_kp.to(torch.float32) - tk) / tk
    err = torch.where(torch.abs(err) <= params.target_tolerance, 0.0, err)
    mc = params.threshold_max_change
    threshold = torch.clamp(state.threshold + torch.clamp(err * mc, -mc, mc),
                            params.threshold_min, params.threshold_max)

    weights = lm_mod.landmark_weights(state.table, state.prev.landmark_slot)
    if T_odom is not None:
        T_guess = T_odom
    else:
        T_guess = state.last_motion if motion_model_on else eye

    track_fn = (frame_mod.track_and_align if params.mode == "stereo"
                else frame_mod.track_and_align_uvd)

    def attempt(radius, gate, guess):
        return track_fn(
            cam, state.prev, cur, guess, radius, gate.to(torch.int32),
            weights, params.gn_config,
        )

    def accept(r):
        ratio = r.n_inliers.to(torch.float32) / torch.clamp(
            r.n_matches.to(torch.float32), min=1.0)
        return (r.converged & (r.n_inliers >= params.min_inliers)
                & (r.n_inliers >= params.min_landmarks_to_track)
                & (ratio >= params.min_inlier_ratio))

    # Localizing => match by appearance: window past the image, identity
    # guess, maximum descriptor gate (pose_tracker_3d.cpp:87-92,227-239).
    appearance = state.localizing & state.has_prev
    res = attempt(
        torch.where(appearance, 1e6, state.radius_px),
        torch.where(appearance, params.gate_max, state.desc_gate),
        torch.where(appearance, eye, T_guess),
    )
    # Retry ladder (pose_tracker_3d.cpp:300-419): host decisions.
    if params.retry_attempts >= 2 and not bool(accept(res)):
        res = attempt(
            torch.clamp(2.0 * state.radius_px, max=params.radius_max),
            torch.clamp(state.desc_gate + 10.0, max=params.gate_max),
            T_guess,
        )
        if params.retry_attempts >= 3 and not bool(accept(res)):
            res = attempt(
                torch.tensor(params.radius_max, device=dev),
                torch.tensor(params.gate_max, device=dev),
                eye,
            )
    ok = accept(res) & state.has_prev

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
            cam, state.prev, cur, motion, res.prev_to_cur, planes, img_shape,
            torch.clamp(state.desc_gate, max=params.max_recovery_gate),
            params.min_disparity, params.max_disparity,
            border=params.border, enabled=ok,
        )
    elif params.enable_recovery:
        cur, n_recovered = frame_mod.recover_lost_landmarks_depth(
            cam, state.prev, cur, motion, res.prev_to_cur, planes, depth_m,
            torch.clamp(state.desc_gate, max=params.max_recovery_gate),
            params.min_depth, params.max_depth,
            border=params.border, enabled=ok,
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
    if bool(fire):
        table = _take_snapshot(params, state, table, cur, T_world_cam,
                               lm_backed, n_lm_backed)
    kf_count = state.kf_count + fire.to(torch.int32)

    free_list = state.free_list
    if params.enable_eviction and (
        int(state.frame_idx) % params.evict_every == params.evict_every - 1
    ):
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


def step(cam, params: FusedParams, state: TrackerState, imgs: torch.Tensor,
         motion_model_on: bool, T_odom=None, depth_calib=None) -> TrackerState:
    """One frame: imgs is (2, H, W) on the state's device, the stereo pair
    (uint8 or f32), or in depth mode the f32 intensity image and depth in
    meters; depth_calib (K_depth, T_rgb_depth) registers a misaligned
    depth sensor's image first."""
    img_l = imgs[0].to(torch.float32)
    img_r = imgs[1].to(torch.float32)
    depth_m = None
    if params.mode == "depth":
        img_r = depth_m = _register_depth_input(cam, params, img_r, depth_calib)
    cur, n_kp, n_fp, planes = _front_end(cam, params, state, img_l, img_r)
    return _step_tail(cam, params, state, cur, n_kp, n_fp, planes,
                      motion_model_on, T_odom, depth_m)
