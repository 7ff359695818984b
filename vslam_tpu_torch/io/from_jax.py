"""Carry state across from the JAX package (numpy only, no jax import).

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
    return CameraParams(
        K=_tensor(np.asarray(K, np.float32), device),
        baseline_m=_tensor(np.asarray(baseline, np.float32), device),
        rows=int(rows),
        cols=int(cols),
        T_cam_robot=_tensor(np.asarray(T_cam_robot, np.float32), device),
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
