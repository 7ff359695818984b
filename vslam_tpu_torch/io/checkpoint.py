"""Map-state checkpoint / resume (port of vslam_tpu/io/checkpoint.py,
format version 2, for the fused and the modular tracker).

A checkpoint captures the SLAM state — landmark table, slot allocator,
tracker pose / motion / adaptive state, keyframe local maps and
pose-graph bookkeeping — as one compressed npz of arrays plus a JSON meta
record.  The relocalizer database is not stored: it is a function of the
local maps, rebuilt by re-adding them in map-id order.  The layout is the
JAX package's: descriptors are stored as uint32 (the port carries the same
bits as int32), so a checkpoint written by either package loads into the
other.  The fused tracker's fields are read from and written to its
device TrackerState, and the engine is flushed before saving; the modular
tracker's live on the host (its slot free list is the allocator's).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from vslam_tpu_torch.mapping import landmarks as lm_mod
from vslam_tpu_torch.mapping.local_maps import LocalMap
from vslam_tpu_torch.tracking.tracker import LOCALIZING

FORMAT_VERSION = 2


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _u32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32).view(np.uint32)


def _tracker_fields(engine):
    """(T_world_cam, last_motion, free slots, meta fields) of the engine's
    tracker, fused or modular."""
    tracker = engine.tracker
    if not engine.fused:
        al = tracker.allocator
        return (tracker.T_world_cam, tracker.last_motion, np.asarray(al._free, np.int32),
                {"frame_idx": tracker.frame_idx, "radius_px": tracker.radius_px,
                 "desc_gate": tracker.desc_gate, "threshold": tracker.controller.threshold,
                 "allocator_next": al._next, "allocator_free": [int(v) for v in al._free]})
    st = tracker.state
    return (_host(st.T_world_cam), _host(st.last_motion),
            _host(st.free_list[:int(st.free_count)]),
            {"frame_idx": int(st.frame_idx), "radius_px": float(st.radius_px),
             "desc_gate": float(st.desc_gate), "threshold": float(st.threshold),
             "allocator_next": int(st.next_slot), "allocator_free": []})


def save_checkpoint(engine, path: str) -> None:
    # Harvest every stepped frame, register its keyframes and resolve the
    # closure work in flight: the file then holds a local map for every
    # keyframe the device made (the card harvests every 32 frames).
    engine._flush_tracker()
    tracker = engine.tracker
    table = tracker.table
    T_world_cam, last_motion, free_slots, fields = _tracker_fields(engine)
    maps = engine.world_map.local_maps
    arrays = {
        "table_xyz_w": _host(table.xyz_w),
        "table_H_acc": _host(table.H_acc),
        "table_desc": _u32(_host(table.desc)),
        "table_n_updates": _host(table.n_updates),
        "table_last_seen": _host(table.last_seen),
        "table_valid": _host(table.valid),
        "table_origin_kf": _host(table.origin_kf),
        "table_protected": _host(table.protected),
        "T_world_cam": T_world_cam,
        "last_motion": last_motion,
        "trajectory": (np.stack(tracker.trajectory) if tracker.trajectory
                       else np.zeros((0, 4, 4))),
        "kf_poses": np.stack(engine.kf_poses) if engine.kf_poses else np.zeros((0, 4, 4)),
        "kf_odometry": (np.stack(engine.kf_odometry) if engine.kf_odometry
                        else np.zeros((0, 4, 4))),
        "free_slots": free_slots,
        # Local maps flattened, with per-map counts in the meta record.
        "lm_slots": (np.concatenate([m.landmark_slots for m in maps]) if maps
                     else np.zeros(0, np.int32)),
        "lm_xyz": (np.concatenate([m.xyz_kf for m in maps]) if maps
                   else np.zeros((0, 3), np.float32)),
        "lm_desc": (np.concatenate([_u32(m.desc if m.desc is not None
                                         else _host(m.desc_dev)[:len(m.landmark_slots)])
                                    for m in maps]) if maps else np.zeros((0, 8), np.uint32)),
        "lm_kf_poses": (np.stack([m.T_world_kf for m in maps]) if maps
                        else np.zeros((0, 4, 4), np.float32)),
    }
    meta = {
        "version": FORMAT_VERSION,
        "status": tracker.status,
        **fields,
        "local_maps": [{"map_id": m.map_id, "keyframe_index": m.keyframe_index,
                        "n": len(m.landmark_slots)} for m in maps],
        "closure_edges": [{"i": int(i), "j": int(j), "T": np.asarray(T).tolist()}
                          for (i, j, T) in engine.closure_edges],
        "n_optimizations": engine.n_optimizations,
        "n_merges": engine.n_merges,
        "kf_frame_indices": [int(v) for v in engine.kf_frame_indices],
        "kf_odom_weight": [float(v) for v in engine.kf_odom_weight],
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_checkpoint(engine, path: str) -> None:
    """Restore a checkpoint into a freshly built engine of the same
    configuration and landmark capacity; the next frame re-seeds tracking
    (Localizing), as the reference resumes."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != {FORMAT_VERSION}")
    tracker = engine.tracker
    dev = tracker.device
    cap = tracker.table.capacity
    stored = data["table_xyz_w"].shape[0]
    if stored != cap:
        raise ValueError(f"landmark capacity mismatch: checkpoint {stored}, engine {cap}")

    def on_dev(name, dtype):
        a = data[name]
        if dtype == torch.int32 and a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    table = lm_mod.LandmarkTable(
        xyz_w=on_dev("table_xyz_w", torch.float32),
        H_acc=on_dev("table_H_acc", torch.float32),
        desc=on_dev("table_desc", torch.int32),
        n_updates=on_dev("table_n_updates", torch.int32),
        last_seen=on_dev("table_last_seen", torch.int32),
        valid=on_dev("table_valid", torch.bool),
        origin_kf=on_dev("table_origin_kf", torch.int32),
        protected=on_dev("table_protected", torch.bool),
    )
    n_maps = len(meta["local_maps"])
    frame_idx = int(meta["frame_idx"])
    free_slots = data["free_slots"].astype(np.int32)
    if engine.fused:
        _load_fused_tracker(tracker, data, meta, table, n_maps, free_slots)
    else:
        tracker.table = table
        tracker.T_world_cam = data["T_world_cam"].astype(np.float32)
        tracker.last_motion = data["last_motion"].astype(np.float32)
        tracker.frame_idx = frame_idx
        tracker.status = meta.get("status", LOCALIZING)
        tracker.radius_px = meta["radius_px"]
        tracker.desc_gate = meta["desc_gate"]
        tracker.controller.threshold = meta["threshold"]
        tracker.allocator._next = meta["allocator_next"]
        tracker.allocator._free = [int(v) for v in free_slots]
        tracker.prev_frame = None  # the next frame re-seeds tracking (Localizing)
        tracker.kf_count = n_maps
        tracker._break_frames = []
    tracker.trajectory = [T.astype(np.float32) for T in data["trajectory"]]
    tracker.stats.n_frames = frame_idx
    _load_engine(engine, data, meta)


def _load_fused_tracker(tracker, data, meta, table, n_maps, free_slots):
    st = tracker.state
    dev = tracker.device

    def on_dev(name):
        return torch.from_numpy(np.ascontiguousarray(data[name])).to(dev, torch.float32)

    last_kf = (data["lm_kf_poses"][-1] if n_maps else np.eye(4)).astype(np.float32)
    F = st.free_list.shape[0]
    fc = min(len(free_slots), F)
    free_list = torch.zeros(F, dtype=torch.int32, device=dev)
    free_list[:fc] = torch.from_numpy(free_slots[:fc]).to(dev)

    def scalar(v, like):
        return torch.full_like(like, v)

    frame_idx = int(meta["frame_idx"])
    tracker.state = st._replace(
        table=table,
        T_world_cam=on_dev("T_world_cam"),
        last_motion=on_dev("last_motion"),
        radius_px=scalar(meta["radius_px"], st.radius_px),
        desc_gate=scalar(meta["desc_gate"], st.desc_gate),
        threshold=scalar(meta["threshold"], st.threshold),
        next_slot=scalar(meta["allocator_next"], st.next_slot),
        frame_idx=scalar(frame_idx, st.frame_idx),
        has_prev=scalar(False, st.has_prev),  # the next frame re-seeds tracking
        localizing=scalar(True, st.localizing),  # the reference resumes in Localizing
        kf_count=scalar(n_maps, st.kf_count),
        T_last_kf=torch.from_numpy(last_kf).to(dev),
        frames_since_kf=scalar(0, st.frames_since_kf),
        free_list=free_list,
        free_count=scalar(fc, st.free_count),
    )
    # The host's harvest counters index the result ring by frame.
    tracker._dispatched = tracker._harvested = frame_idx
    tracker._kf_harvested = n_maps
    tracker._pending_keyframes = []
    tracker._pending_corrections = []
    tracker._break_frames = []
    tracker._last_pose = (data["trajectory"][-1].astype(np.float32) if len(data["trajectory"])
                          else np.eye(4, dtype=np.float32))
    tracker._last_status = meta.get("status", LOCALIZING)


def _load_engine(engine, data, meta):
    """The engine's pose-graph bookkeeping and local maps, and the
    relocalizer database rebuilt from them."""
    engine.kf_poses = [T.astype(np.float32) for T in data["kf_poses"]]
    engine.kf_odometry = [T.astype(np.float32) for T in data["kf_odometry"]]
    engine.kf_frame_indices = list(meta["kf_frame_indices"])
    engine.kf_odom_weight = list(meta["kf_odom_weight"])
    engine._breaks_consumed = 0
    engine.closure_edges = [(e["i"], e["j"], np.asarray(e["T"], np.float32))
                            for e in meta["closure_edges"]]
    engine.n_optimizations = meta["n_optimizations"]
    engine.n_merges = meta["n_merges"]
    engine._inflight_queries, engine._inflight_icp = [], []

    # Rebuild the local maps, then the relocalizer database from them.
    engine.world_map.local_maps = []
    off = 0
    for m, T_kf in zip(meta["local_maps"], data["lm_kf_poses"]):
        n = m["n"]
        engine.world_map.local_maps.append(LocalMap(
            map_id=m["map_id"], keyframe_index=m["keyframe_index"],
            T_world_kf=T_kf.astype(np.float32),
            landmark_slots=data["lm_slots"][off:off + n].astype(np.int32),
            xyz_kf=data["lm_xyz"][off:off + n].astype(np.float32),
            desc=data["lm_desc"][off:off + n].view(np.int32)))
        off += n
    if engine.world_map.local_maps:
        engine.world_map._last_T = engine.world_map.local_maps[-1].T_world_kf.copy()

    reloc = engine.relocalizer
    reloc.db_desc = torch.zeros_like(reloc.db_desc)
    reloc.db_map_id = torch.full_like(reloc.db_map_id, -1)
    reloc.row_slot[:] = -1
    reloc.n_rows = 0
    reloc.maps = {}
    reloc._slot_in_db = set()
    reloc._slot_maps = {}
    reloc._map_slot_row = {}
    for m in engine.world_map.local_maps:
        reloc.add_local_map(m)
