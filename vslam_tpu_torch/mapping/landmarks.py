"""Device-resident landmark table (port of vslam_tpu/mapping/landmarks.py):
fixed-capacity SoA columns with batched information-form GN updates, the
pose graph's rigid corrections, and the modular tracker's host-side slot
allocator."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vslam_tpu_torch.mapping.frame import _add_delta, _put_rows
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.ops import lie
from vslam_tpu_torch.solve import aligners
from vslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class LandmarkTable(NamedTuple):
    xyz_w: torch.Tensor  # (M, 3) world positions
    H_acc: torch.Tensor  # (M, 3, 3) accumulated information
    desc: torch.Tensor  # (M, 8) int32 most recent descriptor
    n_updates: torch.Tensor  # (M,) int32
    last_seen: torch.Tensor  # (M,) int32 frame index
    valid: torch.Tensor  # (M,) bool
    origin_kf: torch.Tensor  # (M,) int32 local map that spawned the landmark
    protected: torch.Tensor  # (M,) bool: referenced by a local-map snapshot

    @property
    def capacity(self):
        return self.xyz_w.shape[0]


def empty_table(capacity: int, device=DEFAULT_DEVICE) -> LandmarkTable:
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return LandmarkTable(
        xyz_w=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        H_acc=torch.zeros((capacity, 3, 3), dtype=torch.float32, device=device),
        desc=torch.zeros((capacity, 8), **i32),
        n_updates=torch.zeros(capacity, **i32),
        last_seen=torch.full((capacity,), -1, **i32),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        origin_kf=torch.zeros(capacity, **i32),
        protected=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def landmark_weights(table: LandmarkTable, slots: torch.Tensor) -> torch.Tensor:
    """Per-framepoint pose-solver weight: 1 + log(1 + n_updates) for
    landmark-backed points, 1 otherwise (stereouv_aligner.cpp:40-46)."""
    has_lm = slots >= 0
    n = table.n_updates[torch.where(has_lm, slots, 0).to(torch.int64)]
    return torch.where(has_lm, 1.0 + torch.log1p(n.to(torch.float32)), 1.0)


def apply_kf_corrections(table: LandmarkTable, C: torch.Tensor) -> LandmarkTable:
    """Rigidly move every valid landmark with the pose-graph correction of
    its origin local map (reference back-propagation, graph_optimizer.cpp:
    430-450 + local_map.cpp:129-142).

    C: (n_kf, 4, 4) one correction per local map (the JAX package pads it
    to a compile bucket with identity rows; here it is the true size).
    origin_kf is clipped into [0, n_kf - 1].  H_acc is position
    information in world coordinates, so it is conjugated by R."""
    owner = torch.clamp(table.origin_kf, 0, max(C.shape[0] - 1, 0)).to(torch.int64)
    Co = C[owner]
    R = Co[:, :3, :3]
    xyz = torch.einsum("nij,nj->ni", R, table.xyz_w) + Co[:, :3, 3]
    H = torch.einsum("nij,njk,nlk->nil", R, table.H_acc, R)
    return table._replace(
        xyz_w=torch.where(table.valid[:, None], xyz, table.xyz_w),
        H_acc=torch.where(table.valid[:, None, None], H, table.H_acc),
    )


def spawn_and_update_observed(
    cam: cam_ops.CameraParams,
    table: LandmarkTable,
    T_world_cam: torch.Tensor,
    slots: torch.Tensor,  # (K,) slot per framepoint incl. fresh ones (-1 none)
    fresh: torch.Tensor,  # (K,) True where the slot was assigned this frame
    p_cam: torch.Tensor,  # (K, 3) current-camera positions (spawn init)
    uv4: torch.Tensor,  # (K, 4)
    desc: torch.Tensor,  # (K, 8) int32
    point_valid: torch.Tensor,  # (K,)
    frame_idx: torch.Tensor,
    origin_kf: torch.Tensor,
    mode: str = "stereo",
    min_forced_updates: int = 0,
    min_meas_for_opt: int = 0,
    max_t_err_depth_ratio: float = 0.0,
) -> LandmarkTable:
    """Landmark spawn + batched GN refinement in one pass: fresh rows are
    initialized (n_updates=1, H=0, origin, unprotected) and then receive
    their first observation update like every other observed landmark.
    mode "stereo" refines on [uL, vL, uR, vR]; "depth" on [u, v, z] (the
    LandmarkParameters knobs apply to the stereo refinement only, as in
    the JAX package).

    Distinct framepoints hold distinct slots, so observed rows hit
    distinct table rows; unobserved rows alias row 0 and add zero deltas
    (index_add), as the JAX package's predicated add-delta scatters do."""
    obs = point_valid & (slots >= 0)
    tgt = torch.where(obs, slots, 0).to(torch.int64)
    obs = obs & (table.valid[tgt] | fresh)

    xyz_spawn = lie.transform_point_cloud(T_world_cam, p_cam)
    base_xyz = torch.where(fresh[:, None], xyz_spawn, table.xyz_w[tgt])
    base_H = torch.where(fresh[:, None, None], 0.0, table.H_acc[tgt])
    n_up_t = table.n_updates[tgt]
    base_nup = torch.where(fresh, 1, n_up_t)
    if mode == "stereo":
        xyz_n, H_n, _, _ = aligners.update_landmarks(
            cam, base_xyz, base_H, T_world_cam, uv4, obs,
            n_updates=base_nup,
            min_forced_updates=min_forced_updates,
            min_meas_for_opt=min_meas_for_opt,
            max_t_err_depth_ratio=max_t_err_depth_ratio,
        )
    else:
        xyz_n, H_n, _, _ = aligners.update_landmarks_uvd(
            cam, base_xyz, base_H, T_world_cam, uv4[:, :3], obs)

    seen_t = table.last_seen[tgt]
    new_seen = torch.where(obs, torch.maximum(seen_t, frame_idx), seen_t)
    valid_t = table.valid[tgt]
    prot_t = table.protected[tgt]
    every = torch.ones_like(obs)
    return LandmarkTable(
        xyz_w=_add_delta(table.xyz_w, tgt, obs, xyz_n),
        H_acc=_add_delta(table.H_acc, tgt, obs, H_n),
        desc=_put_rows(table.desc, tgt, obs, desc),
        n_updates=_add_delta(table.n_updates, tgt, obs, base_nup + 1),
        last_seen=_add_delta(table.last_seen, tgt, every, new_seen),
        valid=_add_delta(table.valid.to(torch.int32), tgt, every,
                         (valid_t | obs).to(torch.int32)) > 0,
        origin_kf=_add_delta(table.origin_kf, tgt, obs,
                             torch.where(fresh, origin_kf, table.origin_kf[tgt])),
        protected=_add_delta(table.protected.to(torch.int32), tgt, every,
                             (prot_t & ~(fresh & obs)).to(torch.int32)) > 0,
    )


def spawn_landmarks(table: LandmarkTable, new_slots: torch.Tensor, xyz_w: torch.Tensor,
                    desc: torch.Tensor, frame_idx, origin_kf=0) -> LandmarkTable:
    """The modular tracker's spawn: initialize the slots new_slots (-1 =
    unused row) at xyz_w with n_updates 1, no information, the given
    origin local map, unprotected.  The allocator hands out distinct
    slots; unused rows alias slot 0 and add zero, as the JAX package's
    predicated add-delta scatters do."""
    use = new_slots >= 0
    tgt = torch.where(use, new_slots, 0).to(torch.int64)
    i32 = dict(dtype=torch.int32, device=tgt.device)
    seen_t = table.last_seen[tgt]
    return table._replace(
        xyz_w=_add_delta(table.xyz_w, tgt, use, xyz_w),
        H_acc=_add_delta(table.H_acc, tgt, use, 0.0),
        desc=_put_rows(table.desc, tgt, use, desc),
        n_updates=_add_delta(table.n_updates, tgt, use, 1),
        last_seen=_add_delta(table.last_seen, tgt, use,
                             torch.maximum(seen_t, torch.as_tensor(frame_idx, **i32))),
        valid=_put_rows(table.valid, tgt, use, True),
        origin_kf=_add_delta(table.origin_kf, tgt, use, torch.as_tensor(origin_kf, **i32)),
        protected=_put_rows(table.protected, tgt, use, False),
    )


def update_observed(cam: cam_ops.CameraParams, table: LandmarkTable,
                    T_world_cam: torch.Tensor, slots: torch.Tensor, uv4: torch.Tensor,
                    desc: torch.Tensor, point_valid: torch.Tensor, frame_idx,
                    mode: str = "stereo", min_forced_updates: int = 0,
                    min_meas_for_opt: int = 0,
                    max_t_err_depth_ratio: float = 0.0) -> LandmarkTable:
    """The modular tracker's batched GN refinement of every valid landmark
    observed this frame: gather the K observed rows, one information-form
    step each (stereo [uL, vL, uR, vR] or depth [u, v, z]), scatter back
    with the descriptor and counters refreshed.  spawn_landmarks followed
    by this equals spawn_and_update_observed."""
    obs = point_valid & (slots >= 0)
    tgt = torch.where(obs, slots, 0).to(torch.int64)
    obs = obs & table.valid[tgt]
    xyz_g, H_g, n_up_g = table.xyz_w[tgt], table.H_acc[tgt], table.n_updates[tgt]
    if mode == "stereo":
        xyz_n, H_n, _, _ = aligners.update_landmarks(
            cam, xyz_g, H_g, T_world_cam, uv4, obs, n_updates=n_up_g,
            min_forced_updates=min_forced_updates, min_meas_for_opt=min_meas_for_opt,
            max_t_err_depth_ratio=max_t_err_depth_ratio)
    else:
        xyz_n, H_n, _, _ = aligners.update_landmarks_uvd(
            cam, xyz_g, H_g, T_world_cam, uv4[:, :3], obs)
    seen_t = table.last_seen[tgt]
    fi = torch.as_tensor(frame_idx, dtype=torch.int32, device=tgt.device)
    return table._replace(
        xyz_w=_add_delta(table.xyz_w, tgt, obs, xyz_n),
        H_acc=_add_delta(table.H_acc, tgt, obs, H_n),
        desc=_put_rows(table.desc, tgt, obs, desc),
        n_updates=_add_delta(table.n_updates, tgt, obs, n_up_g + 1),
        last_seen=_add_delta(table.last_seen, tgt, obs, torch.maximum(seen_t, fi)),
    )


def scatter_xyz(table: LandmarkTable, slots: torch.Tensor, xyz_new: torch.Tensor,
                use: torch.Tensor) -> LandmarkTable:
    """Write back externally optimized landmark positions (bundle
    adjustment's back-propagation, graph_optimizer.cpp:478-486); slots
    with use set must be distinct.  The JAX package's predicated add-delta
    scatter: unused rows alias slot 0 and add zero."""
    tgt = torch.where(use, slots, 0).to(torch.int64)
    return table._replace(xyz_w=_add_delta(table.xyz_w, tgt, use, xyz_new))


class SlotAllocator:
    """Host-side free list over table slots for the modular tracker
    (world_map.cpp:74-92): LIFO reuse of released slots, then fresh slots
    in order, then -1 once the table is full."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._next = 0
        self._free: list[int] = []

    def allocate(self, n: int) -> np.ndarray:
        out = []
        while n > 0 and self._free:
            out.append(self._free.pop())
            n -= 1
        take = min(n, self.capacity - self._next)
        out.extend(range(self._next, self._next + take))
        self._next += take
        out.extend([-1] * (n - take))
        return np.asarray(out, np.int32)

    def release(self, slots) -> None:
        self._free.extend(int(s) for s in np.asarray(slots) if s >= 0)

    @property
    def num_allocated(self) -> int:
        return self._next - len(self._free)
