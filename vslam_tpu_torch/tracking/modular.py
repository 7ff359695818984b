"""The modular tracker's per-frame device programs: the port's counterpart
of the JAX package's jitted process_stereo_pair / process_depth_frame,
track_and_align / track_and_align_uvd, propagate_tracks +
promote_temporary_points and spawn_landmarks + update_observed.

`ModularPrograms` holds the modular tracker's device state in static
buffers -- the landmark table, the previous frame (`prev`), the current
frame (`cur`) and the last registration attempt's motion and matches --
and one ops/program.StaticProgram for each step:

* `front`: the frame's front-end into `cur` (the stereo pair, or the
  intensity image and the depth map, registered to the intensity camera
  here when the configuration calibrates the depth sensor); inputs the
  two images and the detector threshold; the stereo gates (or the depth
  range) are buffers set by the tracker that holds the programs.  Returns
  (n_keypoints, n_framepoints) as one int32 pair;
* `track`: one attempt of the registration ladder (landmark_weights, the
  projective match and the GN solve, whose loops are WHILE nodes under a
  capture); inputs the motion guess, the search radius and the
  descriptor gate.  Writes `T_cur_prev` / `prev_to_cur` and returns the
  verdict packed in one f32 vector (VERDICT_*), so each attempt is one
  host read;
* `propagate`: after a registration, propagate_tracks and
  promote_temporary_points on `cur`;
* `spawn` and `update`: spawn_landmarks (slots the host allocator chose,
  `assigned`, one fixed-capacity array) then update_observed, or the
  update alone, at the frame's pose, index and local map; each writes
  the table and makes `cur` the next frame's `prev`.

The host logic between the programs -- the ladder's verdicts, the spawn
mask and the slot allocator -- stays on the host, as in the JAX package.
Every value that changes from call to call is a buffer, so a captured
graph replays with the new values.

One ModularPrograms per key (make_programs: the camera's values, the
front-end's static settings, the GN configuration, the landmark
capacity, the tracking mode, the depth calibration and the device), as
the JAX package's jit caches key its programs by static arguments and
shapes.  Trackers of one key take turns on it (PoseTracker._hold):
`holder` is a weak reference to the tracker whose state the buffers
hold.  EVENTS counts the programs' eager runs, captures and replays on
CUDA, by program ("front-end eager", "track replay", ...).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from vslam_tpu_torch.frontend import depth as depth_mod
from vslam_tpu_torch.mapping import frame as frame_mod
from vslam_tpu_torch.mapping import landmarks as lm_mod
from vslam_tpu_torch.ops import lie, program
from vslam_tpu_torch.solve import gn
from vslam_tpu_torch.tracking.fused import _own_copy, _values

# The track program's packed verdict: converged, inliers, matches, the
# previous frame's valid points, then T_cur_prev row-major (16).
VERDICT_CONVERGED, VERDICT_INLIERS, VERDICT_MATCHES, VERDICT_PREV_VALID = range(4)
VERDICT_T = 4

# Eager runs, captures and replays of every modular program (CUDA only).
EVENTS: Counter = Counter()


class FrontEndSettings(NamedTuple):
    """The front-end's static arguments (a key of the programs)."""

    capacity: int
    bin_size: int
    border: int
    descriptor: str
    detector: str
    octaves: int


class ModularState(NamedTuple):
    """What a tracker keeps across frames on the device."""

    table: lm_mod.LandmarkTable
    prev: frame_mod.FrameState


def assign(dst, src) -> None:
    """Copy the tensors of src into those of dst in place, field by field
    (a captured graph reads and writes dst by address).  A field whose
    shape or dtype differs raises ValueError; a field that is dst's own
    tensor is skipped."""
    for name, d, s in zip(getattr(dst, "_fields", range(len(dst))), dst, src):
        if s is d:
            continue
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"{type(dst).__name__}.{name}: {tuple(s.shape)} {s.dtype} does "
                             f"not fit the buffer's {tuple(d.shape)} {d.dtype}")
        d.copy_(s)


def spawn_mask(cur: frame_mod.FrameState, min_track: int) -> torch.Tensor:
    """Framepoints that become landmarks: valid, reliable, no landmark yet
    and tracked for min_track frames (_updatePoints)."""
    return (cur.valid & cur.reliable & (cur.landmark_slot < 0)
            & (cur.track_len >= min_track))


class ModularPrograms:
    def __init__(self, cam, mode: str, front: FrontEndSettings, gn_config: gn.GNConfig,
                 landmark_capacity: int, depth_calib=None):
        dev = cam.K.device
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
        K = front.capacity
        self.cam, self.mode, self.settings, self.gn_config = cam, mode, front, gn_config
        self.depth_calib = depth_calib
        self.table = lm_mod.empty_table(landmark_capacity, dev)
        self.prev = frame_mod.empty_frame(K, dev)
        self.cur = frame_mod.empty_frame(K, dev)
        self.T_cur_prev = torch.eye(4, **f32)
        self.prev_to_cur = torch.full((K,), -1, **i32)
        # The gates the holding tracker sets: stereo (max Hamming distance,
        # epipolar tolerance, min and max disparity) or depth (min and max
        # depth in meters).
        if mode == "stereo":
            self.gates = (torch.zeros((), **i32), torch.zeros((), **f32),
                          torch.zeros((), **f32), torch.zeros((), **f32))
        else:
            self.gates = (torch.zeros((), **f32), torch.zeros((), **f32))
        rows, cols = cam.rows, cam.cols
        self.front = program.StaticProgram(
            self._front, (torch.zeros((rows, cols), **f32), torch.zeros((rows, cols), **f32),
                          torch.zeros((), **f32)), EVENTS, label="front-end")
        self.track = program.StaticProgram(
            self._track, (torch.eye(4, **f32), torch.zeros((), **f32), torch.zeros((), **i32)),
            EVENTS, label="track")
        self.propagate = program.StaticProgram(
            self._propagate, (self.T_cur_prev, self.prev_to_cur), EVENTS, label="propagate")
        self.spawn = program.StaticProgram(
            self._spawn_update, (torch.full((K,), -1, **i32), torch.eye(4, **f32),
                                 torch.zeros((), **i32), torch.zeros((), **i32)),
            EVENTS, label="spawn")
        self.update = program.StaticProgram(
            self._update, (torch.eye(4, **f32), torch.zeros((), **i32)), EVENTS, label="update")
        self.holder = None

    @property
    def programs(self) -> dict:
        return {"front-end": self.front, "track": self.track, "propagate": self.propagate,
                "spawn": self.spawn, "update": self.update}

    @property
    def state(self) -> ModularState:
        return ModularState(self.table, self.prev)

    def _front(self, bufs):
        img_l, img_r, threshold = bufs
        s = self.settings
        common = dict(capacity=s.capacity, bin_size=s.bin_size, border=s.border,
                      descriptor=s.descriptor, detector=s.detector, octaves=s.octaves)
        if self.mode == "stereo":
            frame, n_kp, n_fp = frame_mod.process_stereo_pair(
                self.cam, img_l, img_r, threshold, *self.gates, **common)
        else:
            depth = img_r
            if self.depth_calib is not None:
                depth = depth_mod.register_depth(self.cam, depth, *self.depth_calib)
            frame, n_kp, n_fp = frame_mod.process_depth_frame(
                self.cam, img_l, depth, threshold, *self.gates, **common)
        assign(self.cur, frame)
        return torch.stack([n_kp, n_fp])

    def _track(self, bufs):
        T_guess, radius, gate = bufs
        weights = lm_mod.landmark_weights(self.table, self.prev.landmark_slot)
        track_fn = (frame_mod.track_and_align if self.mode == "stereo"
                    else frame_mod.track_and_align_uvd)
        res = track_fn(self.cam, self.prev, self.cur, T_guess, radius, gate, weights,
                       self.gn_config)
        self.T_cur_prev.copy_(res.T_cur_prev)
        self.prev_to_cur.copy_(res.prev_to_cur)
        counts = torch.stack([res.converged.to(torch.int32), res.n_inliers, res.n_matches,
                              self.prev.valid.sum(dtype=torch.int32)])
        return torch.cat([counts.to(torch.float32), res.T_cur_prev.reshape(16)])

    def _propagate(self, bufs):
        T_cur_prev, prev_to_cur = bufs
        cur = frame_mod.propagate_tracks(self.prev, self.cur, prev_to_cur)
        cur, _ = frame_mod.promote_temporary_points(self.cam, self.prev, cur, T_cur_prev,
                                                    prev_to_cur)
        assign(self.cur, cur)
        return ()

    def _observe(self, table, cur, T_wc, frame_idx):
        """update_observed at the frame's pose; cur becomes prev."""
        table = lm_mod.update_observed(self.cam, table, T_wc, cur.landmark_slot, cur.uv4,
                                       cur.desc, cur.valid, frame_idx, mode=self.mode)
        assign(self.table, table)
        assign(self.prev, cur)

    def _spawn_update(self, bufs):
        assigned, T_wc, frame_idx, origin_kf = bufs
        cur = self.cur
        table = lm_mod.spawn_landmarks(self.table, assigned,
                                       lie.transform_point_cloud(T_wc, cur.p_cam), cur.desc,
                                       frame_idx, origin_kf=origin_kf)
        cur = cur._replace(landmark_slot=torch.where(assigned >= 0, assigned,
                                                     cur.landmark_slot))
        self._observe(table, cur, T_wc, frame_idx)
        return ()

    def _update(self, bufs):
        T_wc, frame_idx = bufs
        self._observe(self.table, self.cur, T_wc, frame_idx)
        return ()


# The process's programs, by key (make_programs).
_PROGRAMS: dict[tuple, ModularPrograms] = {}


def make_programs(cam, mode: str, front: FrontEndSettings, gn_config: gn.GNConfig,
                  landmark_capacity: int, depth_calib=None) -> ModularPrograms:
    """The process's modular programs for these values: equal keys give
    the same programs, so a later tracker replays the graphs an earlier
    one captured.  The programs own their camera and calibration (a graph
    reads them by address)."""
    key = (_values(cam.K), _values(cam.baseline_m), cam.rows, cam.cols,
           _values(cam.T_cam_robot), _values(cam.K_inv), cam.depth_scale, mode, front,
           gn_config, int(landmark_capacity),
           None if depth_calib is None else tuple(map(_values, depth_calib)), cam.K.device)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = ModularPrograms(_own_copy(cam), mode, front, gn_config,
                                         landmark_capacity, _own_copy(depth_calib))
    return _PROGRAMS[key]


def clear_programs() -> None:
    """Forget every shared modular program (the next tracker builds its own)."""
    _PROGRAMS.clear()
