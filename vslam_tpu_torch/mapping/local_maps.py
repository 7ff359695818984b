"""Keyframes / local maps and the world-map bookkeeping (port of
vslam_tpu/mapping/local_maps.py; host-side numpy)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _rotation_angle(R: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)))


@dataclass
class LocalMap:
    map_id: int
    keyframe_index: int  # frame index of the anchoring keyframe
    T_world_kf: np.ndarray  # (4, 4) keyframe pose at creation
    landmark_slots: np.ndarray  # (K,) int32 table slots
    xyz_kf: np.ndarray  # (K, 3) landmark positions in the keyframe frame
    # Landmark descriptors: None while they stay in the device snapshot
    # ring (row `ring_row`).
    desc: np.ndarray | None  # (K, 8) int32, or None
    uv4: np.ndarray | None = None  # (K, 4) keyframe stereo observations
    # (query_cap, 8) int32 device block gathered from the snapshot ring
    # for the relocalizer (fused.gather_kf_desc), or None.
    desc_dev: object = None
    ring_row: int = -1  # device snapshot-ring row (-1: not ring-backed)


@dataclass
class Closure:
    """A verified loop closure (reference src/relocalization/closure.h)."""

    query_id: int
    reference_id: int
    T_ref_query: np.ndarray  # (4, 4) aligning the query keyframe into the reference
    n_correspondences: int
    inlier_ratio: float
    correspondences: np.ndarray  # (C, 2) [query_slot, reference_slot]


class WorldMap:
    """Host-side global map owner (reference src/types/world_map.cpp)."""

    def __init__(self, min_distance: float = 0.5, min_degrees: float = 30.0,
                 min_frames: int = 4):
        self.local_maps: list[LocalMap] = []
        self.closures: list[Closure] = []
        self.min_distance = min_distance
        self.min_radians = np.deg2rad(min_degrees)
        self.min_frames = min_frames
        # Pose at the last trigger; the pose graph's corrections move it
        # with the live pose (SlamEngine._propagate_corrections).
        self._last_T = None
        self._frames_since = 0

    def should_create_local_map(self, T_world_cam: np.ndarray) -> bool:
        """Reference trigger: rotation > threshold OR (distance AND >= N
        frames) since the last local map (world_map.cpp:108-111)."""
        self._frames_since += 1
        if self._last_T is None:
            return True
        dT = np.linalg.inv(self._last_T) @ T_world_cam
        if _rotation_angle(dT[:3, :3]) > self.min_radians:
            return True
        return (float(np.linalg.norm(dT[:3, 3])) > self.min_distance
                and self._frames_since >= self.min_frames)

    def note_trigger(self, T_world_cam: np.ndarray) -> None:
        self._last_T = T_world_cam.copy()
        self._frames_since = 0

    def create_local_map(self, T_world_cam: np.ndarray, frame_index: int,
                         landmark_slots: np.ndarray, xyz_world: np.ndarray,
                         desc: np.ndarray | None,
                         uv4: np.ndarray | None = None) -> LocalMap:
        T_kf_world = np.linalg.inv(T_world_cam)
        lm = LocalMap(
            map_id=len(self.local_maps),
            keyframe_index=frame_index,
            T_world_kf=T_world_cam.copy(),
            landmark_slots=np.array(landmark_slots, np.int32),
            xyz_kf=(xyz_world @ T_kf_world[:3, :3].T + T_kf_world[:3, 3]).astype(np.float32),
            desc=None if desc is None else np.asarray(desc, np.int32),
            uv4=None if uv4 is None else np.asarray(uv4, np.float32),
        )
        self.local_maps.append(lm)
        self.note_trigger(T_world_cam)
        return lm

    def add_closure(self, closure: Closure):
        self.closures.append(closure)

    def __len__(self):
        return len(self.local_maps)
