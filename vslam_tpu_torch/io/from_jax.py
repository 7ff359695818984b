"""Carry state across from the JAX package (numpy only, no jax import):
tracker state, local maps, the relocalizer database and pose graphs.

Each converter takes the JAX package's arrays after np.asarray — a dict
of field name -> array, nested for the frame and the landmark table of a
TrackerState (e.g. `{k: np.asarray(v) for k, v in state._asdict().items()}`
with `prev` and `table` converted the same way) — and returns the port's
state on `device`.  uint32 descriptor words become int32 by a bit view.
The *_to_numpy inverses give the JAX layout back (int32 -> uint32 view).
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_tpu_torch.mapping.frame import FrameState
from vslam_tpu_torch.mapping.landmarks import LandmarkTable
from vslam_tpu_torch.ops.camera import CameraParams
from vslam_tpu_torch.tracking.fused import TrackerState

_DESC_FIELDS = ("desc", "kf_desc")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in _DESC_FIELDS else a


def camera_from_numpy(K, baseline, rows, cols, T_cam_robot=None,
                      device="cpu") -> CameraParams:
    if T_cam_robot is None:
        T_cam_robot = np.eye(4, dtype=np.float32)
    K = _tensor(np.asarray(K, np.float32), device)
    return CameraParams(
        K=K,
        baseline_m=_tensor(np.asarray(baseline, np.float32), device),
        rows=int(rows),
        cols=int(cols),
        T_cam_robot=_tensor(np.asarray(T_cam_robot, np.float32), device),
        K_inv=torch.linalg.inv(K),
    )


def frame_state_from_numpy(d: dict, device="cpu") -> FrameState:
    return FrameState(**{k: _tensor(d[k], device) for k in FrameState._fields})


def landmark_table_from_numpy(d: dict, device="cpu") -> LandmarkTable:
    return LandmarkTable(**{k: _tensor(d[k], device) for k in LandmarkTable._fields})


def tracker_state_from_numpy(d: dict, device="cpu") -> TrackerState:
    fields = {k: _tensor(d[k], device) for k in TrackerState._fields
              if k not in ("prev", "table")}
    return TrackerState(prev=frame_state_from_numpy(d["prev"], device),
                        table=landmark_table_from_numpy(d["table"], device),
                        **fields)


def frame_state_to_numpy(f: FrameState) -> dict:
    return {k: _numpy(k, v) for k, v in f._asdict().items()}


def landmark_table_to_numpy(t: LandmarkTable) -> dict:
    return {k: _numpy(k, v) for k, v in t._asdict().items()}


def tracker_state_to_numpy(s: TrackerState) -> dict:
    out = {k: _numpy(k, v) for k, v in s._asdict().items()
           if k not in ("prev", "table")}
    out["prev"] = frame_state_to_numpy(s.prev)
    out["table"] = landmark_table_to_numpy(s.table)
    return out


def local_map_from_numpy(d: dict):
    """A JAX LocalMap's fields (numpy) -> the port's LocalMap (host
    descriptors as int32 words; no device block)."""
    from vslam_tpu_torch.mapping.local_maps import LocalMap

    desc = d.get("desc")
    return LocalMap(
        map_id=int(d["map_id"]),
        keyframe_index=int(d["keyframe_index"]),
        T_world_kf=np.asarray(d["T_world_kf"], np.float32).copy(),
        landmark_slots=np.asarray(d["landmark_slots"], np.int32).copy(),
        xyz_kf=np.asarray(d["xyz_kf"], np.float32).copy(),
        desc=None if desc is None else np.asarray(desc).view(np.int32).copy(),
        uv4=None if d.get("uv4") is None else np.asarray(d["uv4"], np.float32).copy(),
        ring_row=int(d.get("ring_row", -1)),
    )


def relocalizer_state_from_numpy(reloc, d: dict, maps: dict | None = None):
    """Load a JAX Relocalizer's database into the port's `reloc` in place:
    d holds db_desc (uint32 words, viewed as int32), db_map_id, row_slot,
    n_rows, _slot_maps and _slot_in_db; maps: map id -> port LocalMap."""
    db_desc = np.asarray(d["db_desc"])
    reloc.capacity = db_desc.shape[0]
    reloc.db_desc = _tensor(db_desc, reloc.device)
    reloc.db_map_id = _tensor(np.asarray(d["db_map_id"], np.int32), reloc.device)
    reloc.row_slot = np.asarray(d["row_slot"], np.int32).copy()
    reloc.n_rows = int(d["n_rows"])
    reloc._slot_maps = {int(k): [int(m) for m in v] for k, v in d["_slot_maps"].items()}
    reloc._slot_in_db = {int(s) for s in d["_slot_in_db"]}
    reloc._map_slot_row = {}
    if maps is not None:
        reloc.maps = dict(maps)
    return reloc


def pose_graph_edges_from_numpy(edges) -> list:
    """A JAX engine's closure-edge list -> [(ref_id, query_id, T (4,4) f32)]."""
    return [(int(i), int(j), np.asarray(T, np.float32).copy()) for i, j, T in edges]


def pose_graph_from_numpy(d: dict, device="cpu"):
    """A JAX PoseGraph's fields (numpy) -> the port's PoseGraph."""
    from vslam_tpu_torch.backend.pose_graph import PoseGraph

    return PoseGraph(**{
        k: (torch.from_numpy(np.asarray(d[k]).astype(np.int64)).to(device)
            if k in ("edge_i", "edge_j") else _tensor(d[k], device))
        for k in PoseGraph._fields})


_BA_INDEX_FIELDS = ("obs_cam",)


def ba_problem_from_numpy(d: dict, device="cpu"):
    """A JAX BAProblem's fields (numpy; the odometry fields may be None)
    -> the port's BAProblem; camera indices become int64."""
    from vslam_tpu_torch.backend.ba import BAProblem

    return BAProblem(**{
        k: (None if d.get(k) is None
            else torch.from_numpy(np.asarray(d[k]).astype(np.int64)).to(device)
            if k in _BA_INDEX_FIELDS else _tensor(d[k], device))
        for k in BAProblem._fields})


def ba_problem_to_numpy(prob) -> dict:
    """The port's BAProblem -> numpy fields in the JAX layout (int32
    camera indices)."""
    return {k: (None if v is None
                else v.detach().cpu().numpy().astype(np.int32) if k in _BA_INDEX_FIELDS
                else v.detach().cpu().numpy())
            for k, v in prob._asdict().items()}
