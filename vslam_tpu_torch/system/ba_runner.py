"""Windowed full bundle adjustment inside the live SLAM loop (port of
vslam_tpu/system/ba_runner.py).

Every `number_of_frames_per_bundle_adjustment` frames the reference
re-optimizes recent keyframe poses and landmark positions
(GraphOptimizer::addPoseWithFactors + optimizeFactorGraph,
graph_optimizer.cpp:319-409, 459-488).  The factor graph is assembled on
the host from the keyframe snapshots the tracker harvests (each LocalMap
carries the f32 stereo observation [uL, vL, uR, vR] of every snapshotted
landmark: one BA measurement row), solved by backend/ba.py on the
engine's device (or landmark-sharded by parallel/sharded_ba.py over the
engine's process group), and scattered back into the landmark table and the
keyframe / trajectory bookkeeping.

Against the JAX runner: the landmark count is the true one (JAX pads it
to a power of two for its compile cache; padded rows are masked and
change nothing), there is no warm-up compile, and the observations always
ride the harvest in f32, so no archive fetch exists.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_tpu_torch.backend import ba as ba_mod
from vslam_tpu_torch.mapping import landmarks as lm_mod
from vslam_tpu_torch.parallel import mesh as mesh_mod
from vslam_tpu_torch.parallel import sharded_ba

# The window covers the last WINDOW keyframes; each landmark keeps up to
# OMAX observations (its most recent ones).
WINDOW = 16
OMAX = 16
MIN_OBS = 2  # landmarks observed once constrain nothing jointly


def build_window_problem(engine, window: int = WINDOW, omax: int = OMAX):
    """Assemble a BAProblem (on the engine's device) over the last
    `window` keyframes, reading the landmark table once.

    Returns (problem, kf_ids (P,) global keyframe ids, slots (L,) table
    slots), or None if the window holds too few observations."""
    maps = [m for m in engine.world_map.local_maps[-window:] if m.uv4 is not None]
    if len(maps) < 2:
        return None
    kf_ids = [m.map_id for m in maps]
    P = len(maps)
    table = engine.tracker.table
    xyz_all = table.xyz_w.cpu().numpy()
    nup_all = table.n_updates.cpu().numpy()

    # Group observations by slot, dropping stale rows first: a slot
    # recycled by eviction (or re-targeted by a merge) since the snapshot
    # pairs an old measurement with another landmark.  The witness is the
    # snapshot's keyframe-frame position: the current table position
    # projected into the keyframe must still agree with it.
    cam_col, slot_col, uv4_col = [], [], []
    for local_cam, m in enumerate(maps):
        slots_m = np.asarray(m.landmark_slots)
        sel = slots_m >= 0
        if not sel.any():
            continue
        R = m.T_world_kf[:3, :3]
        t = m.T_world_kf[:3, 3]
        p_now = (xyz_all[slots_m[sel]] - t) @ R
        p_snap = np.asarray(m.xyz_kf)[sel]
        d = np.linalg.norm(p_now - p_snap, axis=1)
        tol = np.maximum(0.2, 0.02 * np.linalg.norm(p_snap, axis=1))
        rows = np.flatnonzero(sel)[d < tol]
        if len(rows):
            cam_col.append(np.full(len(rows), local_cam, np.int64))
            slot_col.append(slots_m[rows])
            uv4_col.append(np.asarray(m.uv4)[rows])
    if not cam_col:
        return None
    all_cam = np.concatenate(cam_col)
    all_slot = np.concatenate(slot_col)
    all_uv4 = np.concatenate(uv4_col).astype(np.float32)

    # Group by slot: stable sort, rank within the group, keep the LAST
    # omax observations of each slot with >= MIN_OBS of them.
    uniq, inv, counts = np.unique(all_slot, return_inverse=True, return_counts=True)
    order = np.argsort(inv, kind="stable")
    inv_s = inv[order]
    starts = np.r_[0, np.cumsum(counts)[:-1]]
    cum = np.arange(len(inv_s)) - starts[inv_s]
    from_end = counts[inv_s] - 1 - cum
    keep = from_end < omax
    oi = np.minimum(counts[inv_s], omax) - 1 - from_end
    eligible = counts >= MIN_OBS
    keep &= eligible[inv_s]
    lm_ids = np.cumsum(eligible) - 1
    slots = uniq[eligible].astype(np.int64)
    if len(slots) < 16:
        return None

    L = len(slots)
    obs_cam = np.zeros((L, omax), np.int64)
    obs_uv4 = np.zeros((L, omax, 4), np.float32)
    obs_w = np.zeros((L, omax), np.float32)
    obs_mask = np.zeros((L, omax), bool)
    rows_kept = order[keep]
    li, oj = lm_ids[inv_s[keep]], oi[keep]
    obs_cam[li, oj] = all_cam[rows_kept]
    obs_uv4[li, oj] = all_uv4[rows_kept]
    obs_w[li, oj] = 1.0 + np.log1p(
        nup_all[all_slot[rows_kept]].astype(np.float64)).astype(np.float32)
    obs_mask[li, oj] = True

    T_wc = np.stack([m.T_world_kf for m in maps]).astype(np.float32)
    cam_fixed = np.zeros(P, bool)
    cam_fixed[0] = True  # gauge: the oldest keyframe of the window

    # Pose-pose factors between consecutive window keyframes, measured
    # from the CURRENT estimates (the reference measures its edges from
    # the vertex estimates at insertion and clears the graph after every
    # optimization): they hold BA to the present, closure-corrected
    # trajectory instead of re-fighting the pose graph.
    gopt = engine.cfg.graph_optimization
    info_rot = gopt.base_information_frame
    info_trans = (info_rot / gopt.base_information_frame_factor_for_translation
                  if gopt.free_translation_for_poses else info_rot)
    odo_T = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    odo_w = np.zeros(P, np.float32)
    for ci in range(P - 1):
        a, b = kf_ids[ci], kf_ids[ci + 1]
        odo_T[ci] = (np.linalg.inv(engine.kf_poses[a]) @ engine.kf_poses[b]).astype(np.float32)
        ws = np.asarray(engine.kf_odom_weight[a:b], np.float32)
        odo_w[ci] = 1.0 / float(np.sum(1.0 / np.maximum(ws, 1e-9)))

    dev = engine.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    prob = ba_mod.BAProblem(
        T_wc=t(T_wc), xyz=t(xyz_all[slots]), obs_cam=t(obs_cam), obs_uv4=t(obs_uv4),
        obs_weight=t(obs_w), obs_mask=t(obs_mask), lm_valid=t(np.ones(L, bool)),
        cam_fixed=t(cam_fixed), odo_T=t(odo_T), odo_weight=t(odo_w),
        odo_info=t(np.asarray([info_trans] * 3 + [info_rot] * 3, np.float32)),
    )
    return prob, kf_ids, slots


def ba_config(engine, iterations: int | None = None) -> ba_mod.BAConfig:
    """The BAConfig of the engine's configuration: its iteration count and
    the landmark robust kernel (enable_robust_kernel_for_landmarks off =
    no reweighting)."""
    gopt = engine.cfg.graph_optimization
    return ba_mod.BAConfig(
        iterations=iterations or gopt.maximum_number_of_iterations,
        robust_chi2=(engine.cfg.tracking.aligner_maximum_error_kernel
                     if gopt.enable_robust_kernel_for_landmarks else 1e12),
    )


def solve_window(engine, prob: ba_mod.BAProblem, config: ba_mod.BAConfig):
    """Solve a window problem: on one device, or with the engine's
    landmark mesh (parallelism.shard_landmarks under a process group of
    more than one rank) landmark-sharded, every rank its block, the
    blocks gathered back.  Returns (T_wc, xyz)."""
    mesh = engine.landmark_mesh
    if mesh is None:
        return ba_mod.bundle_adjust(engine.cam, prob, config)[:2]
    block, L = sharded_ba.shard_problem(prob, mesh)
    T_opt, xyz_block, _ = sharded_ba.bundle_adjust_sharded(engine.cam, block, mesh, config)
    return T_opt, mesh_mod.all_gather_rows(xyz_block, mesh)[:L]


def run_windowed_ba(engine, iterations: int | None = None) -> np.ndarray | None:
    """Build and solve the windowed problem, write the landmarks back and
    propagate the pose corrections.  Returns the correction applied to the
    newest keyframe (and the live pose, and the landmarks spawned after
    that keyframe), or None if no BA ran."""
    built = build_window_problem(engine)
    if built is None:
        return None
    prob, kf_ids, slots = built
    T_opt, xyz_opt = solve_window(engine, prob, ba_config(engine, iterations))
    T_opt = T_opt.cpu().numpy()
    if not (np.all(np.isfinite(T_opt)) and bool(torch.isfinite(xyz_opt).all())):
        return None

    tracker = engine.tracker
    # Landmark write-back (graph_optimizer.cpp:478-486).
    tracker.table = lm_mod.scatter_xyz(
        tracker.table, prob.obs_cam.new_tensor(slots), xyz_opt,
        torch.ones(len(slots), dtype=torch.bool, device=xyz_opt.device))

    # Pose write-back with the delta gate (minimum_estimation_delta_for_
    # update_meters, graph_optimizer.cpp:430-450; the full matrix-
    # difference norm): corrections at the tracking-noise level are
    # jitter, so those keyframes keep their tracker pose.
    gate = engine.cfg.graph_optimization.minimum_estimation_delta_for_update_meters
    corrections = {}
    for ci, k in enumerate(kf_ids):
        C = (T_opt[ci] @ np.linalg.inv(engine.kf_poses[k])).astype(np.float32)
        if np.linalg.norm(C - np.eye(4, dtype=np.float32)) < gate:
            continue
        corrections[k] = C
        engine.kf_poses[k] = T_opt[ci].astype(np.float32).copy()
        engine.world_map.local_maps[k].T_world_kf = engine.kf_poses[k].copy()
    if not corrections:
        return np.eye(4, dtype=np.float32)

    # Frame f belongs to the first keyframe with frame index >= f.
    traj = tracker.trajectory
    if traj:
        kf_frames = np.asarray(engine.kf_frame_indices)
        owner = np.clip(np.searchsorted(kf_frames, np.arange(len(traj)), side="left"),
                        0, len(kf_frames) - 1)
        stacked = np.stack(traj).astype(np.float32)
        for k, C in corrections.items():
            sel = owner == k
            if sel.any():
                stacked[sel] = np.einsum("ij,fjk->fik", C, stacked[sel])
        tracker.trajectory = list(stacked)

    C_last = corrections.get(kf_ids[-1], np.eye(4, dtype=np.float32))
    if kf_ids[-1] in corrections:
        # Landmarks spawned after the newest window keyframe k (origin_kf
        # > k: on the card, by the later frames of the drain being
        # registered) ride with the live pose.  Identity rows for 0..k
        # leave every other landmark's bits as they are.
        k = kf_ids[-1]
        C = torch.eye(4, dtype=torch.float32, device=xyz_opt.device).repeat(k + 2, 1, 1)
        C[k + 1] = torch.from_numpy(C_last).to(xyz_opt.device)
        tracker.table = lm_mod.apply_kf_corrections(tracker.table, C)
    tracker.apply_world_correction(C_last)
    if engine.world_map._last_T is not None:
        engine.world_map._last_T = (C_last @ engine.world_map._last_T).astype(np.float32)
    return C_last
