"""Device-resident landmark table (port of the slice's part of
vslam_tpu/mapping/landmarks.py): fixed-capacity SoA columns with batched
information-form GN updates and the pose graph's rigid corrections."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.mapping.frame import _put_rows
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

    def add(col, new, mask):
        m = mask.reshape((-1,) + (1,) * (col.dim() - 1))
        cur = col[tgt]
        return col.index_add(0, tgt, torch.where(m, new - cur, torch.zeros_like(cur)))

    seen_t = table.last_seen[tgt]
    new_seen = torch.where(obs, torch.maximum(seen_t, frame_idx), seen_t)
    valid_t = table.valid[tgt]
    prot_t = table.protected[tgt]
    return LandmarkTable(
        xyz_w=add(table.xyz_w, xyz_n, obs),
        H_acc=add(table.H_acc, H_n, obs),
        desc=_put_rows(table.desc, tgt, obs, desc),
        n_updates=add(table.n_updates, base_nup + 1, obs),
        last_seen=add(table.last_seen, new_seen, torch.ones_like(obs)),
        valid=add(table.valid.to(torch.int32), (valid_t | obs).to(torch.int32),
                  torch.ones_like(obs)) > 0,
        origin_kf=add(table.origin_kf, torch.where(fresh, origin_kf, table.origin_kf[tgt]),
                      obs),
        protected=add(table.protected.to(torch.int32),
                      (prot_t & ~(fresh & obs)).to(torch.int32),
                      torch.ones_like(obs)) > 0,
    )


def scatter_xyz(table: LandmarkTable, slots: torch.Tensor, xyz_new: torch.Tensor,
                use: torch.Tensor) -> LandmarkTable:
    """Write back externally optimized landmark positions (bundle
    adjustment's back-propagation, graph_optimizer.cpp:478-486); slots
    with use set must be distinct.  The JAX package's predicated add-delta
    scatter: unused rows alias slot 0 and add zero."""
    tgt = torch.where(use, slots, 0).to(torch.int64)
    cur = table.xyz_w[tgt]
    delta = torch.where(use[:, None], xyz_new - cur, torch.zeros_like(cur))
    return table._replace(xyz_w=table.xyz_w.index_add(0, tgt, delta))
