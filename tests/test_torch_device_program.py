"""The fused tracker's device program on the CPU: the per-frame step with
its decisions taken on the device (tracking/fused.py: the retry ladder,
the keyframe snapshot and the eviction sweep), the FrameProgram that
make_frame_step builds over static state buffers, and its run_chunk.

  (a) no host reads: after one frame, fused.step on every per-frame route
      (K1, the staged front-end at 2 octaves, BRIEF256R, ORB256, the four
      float detectors, RGB-D, RGB-D with ORB256 and bilateral depth, a
      misaligned depth sensor) makes no aten._local_scalar_dense call (a
      read of a tensor's value on the host) and no aten.lift_fresh call
      (a tensor made from host data) -- on the card either would
      synchronize the frame, and a captured graph cannot hold it;
  (b) the ladder: attempt 1, then attempts 2 and 3 each under a cond
      (ops/control.py) on the earlier attempt's rejection, equal to the
      card's eager route (both branches, selected) bit for bit; a batched
      solve keeps each attempt's solo bits; on frames that force
      attempts 2 and 3 (motion guesses off by 0.15 and 0.25 rad of yaw,
      then a frame of noise) the device ladder selects, bit for bit, the
      result of a host ladder that stops at the first accepted attempt;
      the steps on those frames against
      JAX's make_frame_step: integer state and per-frame counts exact,
      recovered landmarks within one a frame and poses within 1e-4
      (tests/test_torch_split.py's tolerances for the same world with
      odometry guesses);
  (c) FrameProgram against the eager step over 20 frames: every state
      tensor equal; run_chunk over a chunk of 4 and a tail of 2 with
      odometry guesses against JAX's make_chunk_step (k traced), to (b)'s
      tolerances;
  (d) the state's writers (world corrections, landmark merges, a
      checkpoint reload between drains, BA write-back) write the
      program's buffers in place: the closed loop and the BA corridor at
      the card's drain cadence (every 8 frames) give the events
      tests/test_torch_closed_loop.py and tests/test_torch_ba_engine.py
      expect, and no buffer is ever rebound;
  (e) make_transform's bits with no lift_fresh;
plus the launch bookkeeping of replays and assign_state's refusals.
"""

import os
from collections import Counter
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.ops import camera as jcam
from vslam_tpu.tracking import fused as jfused
from vslam_tpu.tracking.tracker import FusedPoseTracker as JTracker
from vslam_tpu_torch.eval import trajectory as ttraj
from vslam_tpu_torch.io import checkpoint
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.ops import control, cuda_build, lie, program
from vslam_tpu_torch.system.engine import SlamEngine
from vslam_tpu_torch.tracking import fused as tfused
from vslam_tpu_torch.tracking import tracker as ttracker

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = torch.device("cpu")
POSE_ATOL = 1e-4


class NoHostData(TorchDispatchMode):
    """Raises on a host read of a tensor's value or a tensor from host data."""

    FORBIDDEN = ("aten::_local_scalar_dense", "aten::lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.FORBIDDEN:
            raise AssertionError(f"{func._schema.name} inside the step")
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# (a) no host reads on any per-frame route
# ---------------------------------------------------------------------------

ROUTES = {
    "k1": {},
    "staged-2-octaves": dict(detector_number_of_octaves=2),
    "brief256r": dict(descriptor_type="BRIEF256R", border_pixels=12),
    "orb256": dict(descriptor_type="ORB256"),
    "harris": dict(detector_type="HARRIS"),
    "gftt": dict(detector_type="GFTT"),
    "dog": dict(detector_type="DOG"),
    "kaze": dict(detector_type="KAZE"),
    "rgbd": dict(depth=True),
    "rgbd-orb256-bilateral": dict(depth=True, descriptor_type="ORB256",
                                  enable_bilateral_filtering=True),
    "rgbd-misaligned-sensor": dict(
        depth=True, depth_camera_intrinsics=[300, 0, 128, 0, 300, 64, 0, 0, 1],
        depth_camera_to_rgb=[1, 0, 0, 0.02, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]),
}


@pytest.fixture(scope="module")
def small_world():
    cam = tcam.make_camera(fx=300, fy=300, cx=128, cy=64, baseline_m=0.4, rows=128,
                           cols=256, device="cpu")
    world = tsyn.make_world(cam, n_points=800, seed=3,
                            poses=tsyn.circle_trajectory(8, radius=5.0))
    return cam, world


@pytest.mark.parametrize("route", list(ROUTES))
def test_step_reads_nothing_back_after_its_first_frame(small_world, route):
    cam, world = small_world
    opts = dict(ROUTES[route])
    depth = opts.pop("depth", False)
    cfg = TConfig()
    fp = cfg.framepoint_generation
    fp.capacity, fp.bin_size_pixels, fp.border_pixels = 128, 16, 20
    for k, v in opts.items():
        setattr(fp, k, v)
    if depth:
        cfg.command_line.tracker_mode = "RGB_DEPTH"
    params = ttracker.params_from_config(cam, cfg, CPU)
    calib = ttracker._depth_calibration(fp, CPU)
    render = tsyn.render_depth_frame if depth else tsyn.render_frame
    frames = [torch.from_numpy(np.stack(render(world, t)[:2]).astype(
        np.float32 if depth else np.uint8)) for t in range(3)]
    state = tfused.init_state(cam, params, 2048, 20.0)
    state = tfused.step(cam, params, state, frames[0], True, None, calib)
    with NoHostData():
        for imgs in frames[1:]:
            state = tfused.step(cam, params, state, imgs, True, None, calib)
    assert int(state.frame_idx) == 3


# ---------------------------------------------------------------------------
# (b), (c): the ladder, the program and the chunk against JAX
# ---------------------------------------------------------------------------

CAM_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=160.0, baseline_m=0.4, rows=320, cols=640)


def _fused_config(cls):
    cfg = cls()
    cfg.framepoint_generation.capacity = 512
    cfg.framepoint_generation.bin_size_pixels = 12
    cfg.framepoint_generation.border_pixels = 12  # both packages: the staged route
    return cfg


def _yaw(a):
    T = np.eye(4, dtype=np.float32)
    T[0, 0] = T[2, 2] = np.cos(a)
    T[0, 2], T[2, 0] = np.sin(a), -np.sin(a)
    return T


@pytest.fixture(scope="module")
def guided():
    """Eight frames of tests/test_fused.py's world (320 x 640) with
    odometry guesses T_cur_prev from the ground truth, but frame 5's off
    by 0.15 rad of yaw (attempt 1 fails, attempt 2 is accepted), frame
    6's by 0.25 rad (attempts 1 and 2 fail, 3 is accepted) and frame 7 a
    pair of uniform noise (every attempt fails)."""
    cam = tcam.make_camera(**CAM_ARGS, device="cpu")
    world = tsyn.make_world(cam, n_frames=16, n_points=2200, seed=19, step=0.4)
    noise = np.random.default_rng(0).integers(0, 256, (2, 320, 640)).astype(np.uint8)
    frames, odom = [], []
    for t in range(8):
        frames.append(noise if t == 7 else
                      np.stack(tsyn.render_frame(world, t)[:2]).astype(np.uint8))
        T = (np.linalg.inv(world.poses[t]) @ world.poses[max(t - 1, 0)]).astype(np.float32)
        odom.append({5: _yaw(0.15), 6: _yaw(0.25)}.get(t, np.eye(4, dtype=np.float32)) @ T)
    return cam, np.stack(frames), np.stack(odom).astype(np.float32)


def test_device_ladder_selects_the_host_ladders_attempt(guided):
    cam, frames, odom = guided
    params = ttracker.params_from_config(cam, _fused_config(TConfig), CPU)
    state = tfused.init_state(cam, params, 16384, 20.0)
    reached = []
    for imgs, T in zip(torch.from_numpy(frames), torch.from_numpy(odom)):
        cur = tfused._front_end(cam, params, state, imgs[0].float(), imgs[1].float())[0]
        weights = tfused.lm_mod.landmark_weights(state.table, state.prev.landmark_slot)
        for k, (radius, gate, guess) in enumerate(tfused._ladder_inputs(params, state, T)):
            host = tfused.frame_mod.track_and_align(cam, state.prev, cur, guess, radius,
                                                    gate.to(torch.int32), weights,
                                                    params.gn_config)
            if bool(tfused._accept(params, host)):
                break
        reached.append(k + 1)
        device = tfused._register(cam, params, state, cur, T)
        for name, a, b in zip(host._fields, device, host):
            assert torch.equal(a, b), (len(reached) - 1, name)
        state = tfused.step(cam, params, state, imgs, True, T)
    # Frame 0 has no previous frame; frames 5-7 force the retries.
    assert reached[1:] == [1, 1, 1, 1, 2, 3, 3], reached


def test_ladder_conds_equal_the_masked_route_on_the_guided_frames(guided):
    """_register's conds (ops/control.py) on the guided frames: the CPU's
    early exit and plain branches equal, bit for bit, the card's eager
    route (every loop to its cap, both branches computed and selected:
    control.masked), and the conds decide as the host ladder stops --
    attempt 2's retry runs exactly where the ladder reaches attempt 2,
    attempt 3's where it reaches 3."""
    cam, frames, odom = guided
    params = ttracker.params_from_config(cam, _fused_config(TConfig), CPU)
    state = tfused.init_state(cam, params, 16384, 20.0)
    reached = []
    for imgs, T in zip(torch.from_numpy(frames), torch.from_numpy(odom)):
        cur = tfused._front_end(cam, params, state, imgs[0].float(), imgs[1].float())[0]
        with control.recording() as rec:
            early = tfused._register(cam, params, state, cur, T)
        with control.masked():
            masked = tfused._register(cam, params, state, cur, T)
        for name, a, b in zip(early._fields, early, masked):
            assert torch.equal(a, b), (len(reached), name)
        value = dict(zip(rec.names(), (v for _, _, v in rec.read())))
        reached.append(1 + (value["attempt 2"] == 0) + (value["attempt 3"] == 0))
        state = tfused.step(cam, params, state, imgs, True, T)
    assert reached[1:] == [1, 1, 1, 1, 2, 3, 3], reached


def test_snapshot_and_eviction_conds_equal_the_masked_route():
    """fused.step with its conds on the CPU's route against the card's
    eager route (control.masked) over 20 frames of the closed-loop circle
    with an eviction sweep every 5 frames: every state tensor equal after
    every frame; the eviction cond sweeps on frames 4, 9, 14 and 19
    alone, and the snapshot cond fires as often as kf_count says."""
    cam = tcam.make_camera(fx=300, fy=300, cx=256, cy=96, baseline_m=0.4, rows=192,
                           cols=512, device="cpu")
    world = tsyn.make_world(cam, n_points=1500, seed=21,
                            poses=tsyn.circle_trajectory(48, radius=7.0))
    cfg = TConfig()
    cfg.framepoint_generation.capacity = 256
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.8
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    params = ttracker.params_from_config(cam, cfg, CPU)._replace(
        evict_every=5, evict_age_frames=2, evict_max_updates=100)
    early = tfused.init_state(cam, params, 8192, 20.0)
    masked = tfused.init_state(cam, params, 8192, 20.0)
    sweeps, fired = [], 0
    for t in range(20):
        imgs = torch.from_numpy(np.stack(tsyn.render_frame(world, t)[:2]).astype(np.uint8))
        with control.recording() as rec:
            early = tfused.step(cam, params, early, imgs, True)
        with control.masked():
            masked = tfused.step(cam, params, masked, imgs, True)
        for (name, a), (_, b) in zip(tfused.state_tensors(early), tfused.state_tensors(masked)):
            assert torch.equal(a, b), (t, name)
        value = dict(zip(rec.names(), (v for _, _, v in rec.read())))
        if value["eviction"]:
            sweeps.append(t)
        fired += value["snapshot"]
    assert sweeps == [4, 9, 14, 19]
    assert fired == int(early.kf_count) >= 2 and int(early.free_count) > 0


@pytest.mark.parametrize("depth", [False, True])
def test_batched_attempts_equal_solo_solves(small_world, depth):
    """frame.track_and_align_batch, which the device ladder runs, solves
    each of its attempts to the bits of that attempt solved alone (a
    batch of one, as the host ladder and the modular tracker run it):
    three attempts from three guesses (the true motion, it off by 0.02
    rad of yaw, the identity), windows and gates, on frame 2 of a
    48-frame circle at the small world's camera, stereo and RGB-D."""
    cam = small_world[0]
    world = tsyn.make_world(cam, n_points=800, seed=3,
                            poses=tsyn.circle_trajectory(48, radius=5.0))
    cfg = TConfig()
    cfg.framepoint_generation.capacity, cfg.framepoint_generation.bin_size_pixels = 128, 16
    if depth:
        cfg.command_line.tracker_mode = "RGB_DEPTH"
    params = ttracker.params_from_config(cam, cfg, CPU)
    render = tsyn.render_depth_frame if depth else tsyn.render_frame
    state = tfused.init_state(cam, params, 2048, 20.0)
    for t in range(3):
        imgs = torch.from_numpy(np.stack(render(world, t)[:2]).astype(
            np.float32 if depth else np.uint8))
        if t < 2:
            state = tfused.step(cam, params, state, imgs, True)
    cur = tfused._front_end(cam, params, state, imgs[0].float(), imgs[1].float())[0]
    weights = tfused.lm_mod.landmark_weights(state.table, state.prev.landmark_slot)
    T = np.linalg.inv(world.poses[2]) @ world.poses[1]
    guess = torch.from_numpy(np.stack([T, _yaw(0.02) @ T, np.eye(4)]).astype(np.float32))
    radius = torch.tensor([12.0, 30.0, 1e6])
    gate = torch.tensor([40, 50, 90], dtype=torch.int32)
    batch = tfused.frame_mod.track_and_align_batch(cam, state.prev, cur, guess, radius, gate,
                                                   weights, params.gn_config, depth=depth)
    solo_fn = (tfused.frame_mod.track_and_align_uvd if depth
               else tfused.frame_mod.track_and_align)
    for a in range(3):
        solo = solo_fn(cam, state.prev, cur, guess[a], radius[a], gate[a], weights,
                       params.gn_config)
        for name, x, y in zip(solo._fields, solo, batch):
            assert torch.equal(x, y[a]), (a, name)
    assert int(batch.n_inliers.min()) > 0


def _jax_ring_matches(ts, js, recovered_slack):
    ring_t, ring_j = ts.ring.numpy(), np.asarray(js.ring)
    counts = [tfused._R_NKP, tfused._R_NFP, tfused._R_NMATCH, tfused._R_NINL, tfused._R_OK,
              tfused._R_NSPAWN, tfused._R_FIDX, tfused._R_KFCOUNT, tfused._R_STATUS]
    np.testing.assert_array_equal(ring_t[:, counts], ring_j[:, counts])
    rec = np.abs(ring_t[:, tfused._R_NRECOVER] - ring_j[:, tfused._R_NRECOVER])
    assert rec.max() <= recovered_slack, rec
    np.testing.assert_allclose(ring_t[:, :16], ring_j[:, :16], atol=POSE_ATOL)
    for name in ("next_slot", "free_count", "kf_count", "frame_idx", "kf_n", "kf_slots",
                 "threshold", "localizing"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_allclose(ts.T_world_cam.numpy(), np.asarray(js.T_world_cam),
                               atol=POSE_ATOL)


@pytest.fixture(scope="module")
def jax_setup():
    jc = jcam.make_camera(**CAM_ARGS)
    return jc, JTracker(jc, _fused_config(JConfig), landmark_capacity=16384).params


def test_forced_retries_match_jax_make_frame_step(guided, jax_setup):
    cam, frames, odom = guided
    jc, jparams = jax_setup
    jstep = jfused.make_frame_step(jparams)
    js = jfused.init_state(jc, jparams, 16384, 20.0)
    for imgs, T in zip(frames, odom):
        js, _ = jstep(jc, js, jnp.asarray(imgs[None]), 0, jnp.asarray(True),
                      jnp.asarray(T[None]), jnp.asarray(True))
    params = ttracker.params_from_config(cam, _fused_config(TConfig), CPU)
    prog = tfused.FrameProgram(cam, params, tfused.init_state(cam, params, 16384, 20.0),
                                  True, torch.uint8, odometry=True)
    for imgs, T in zip(torch.from_numpy(frames), torch.from_numpy(odom)):
        prog.run(imgs, T)
    ring = prog.state.ring.numpy()
    assert list(ring[5:8, tfused._R_OK]) == [1.0, 1.0, 0.0]  # retried, retried, lost
    _jax_ring_matches(prog.state, js, recovered_slack=1)


def test_program_equals_the_eager_step():
    """20 frames of tests/test_torch_closed_loop.py's circle, with an
    eviction sweep every 5 frames (of landmarks unseen for 2), so that
    sweeps, snapshots and recycled slots all run."""
    cam = tcam.make_camera(fx=300, fy=300, cx=256, cy=96, baseline_m=0.4, rows=192,
                           cols=512, device="cpu")
    world = tsyn.make_world(cam, n_points=1500, seed=21,
                            poses=tsyn.circle_trajectory(48, radius=7.0))
    cfg = TConfig()
    cfg.framepoint_generation.capacity = 256
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.8
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    params = ttracker.params_from_config(cam, cfg, CPU)._replace(
        evict_every=5, evict_age_frames=2, evict_max_updates=100)
    eager = tfused.init_state(cam, params, 8192, 20.0)
    prog = tfused.FrameProgram(cam, params, tfused.init_state(cam, params, 8192, 20.0),
                                  True, torch.uint8)
    buffers = [t for _, t in tfused.state_tensors(prog.state)]
    freed = 0
    for t in range(20):
        imgs = torch.from_numpy(np.stack(tsyn.render_frame(world, t)[:2]).astype(np.uint8))
        eager = tfused.step(cam, params, eager, imgs, True)
        prog.run(imgs)
        for (name, a), (_, b) in zip(tfused.state_tensors(eager),
                                     tfused.state_tensors(prog.state)):
            assert torch.equal(a, b), (t, name)
        freed = max(freed, int(prog.state.free_count))
    assert freed > 0  # a sweep pushed slots on the free stack
    assert all(a is b for a, b in zip(buffers, (t for _, t in tfused.state_tensors(prog.state))))
    assert int(prog.state.kf_count) >= 2 and prog.uses == 20


def test_run_chunk_matches_jax_make_chunk_step(guided, jax_setup):
    """A chunk of 4 and a tail of 2 (the true odometry guesses of frames
    0-5): JAX's one program with k traced, the port's k replays."""
    cam, frames, odom = guided
    jc, jparams = jax_setup
    C = 4
    true_odom = odom.copy()
    true_odom[5] = _yaw(-0.15) @ odom[5]
    jchunk = jfused.make_chunk_step(jparams)
    js = jfused.init_state(jc, jparams, 16384, 20.0)
    params = ttracker.params_from_config(cam, _fused_config(TConfig), CPU)
    prog = tfused.FrameProgram(cam, params, tfused.init_state(cam, params, 16384, 20.0),
                                  True, torch.uint8, odometry=True)
    for start, k in ((0, 4), (4, 2)):
        buf = np.zeros((C,) + frames.shape[1:], np.uint8)
        buf[:k] = frames[start:start + k]
        o = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        o[:k] = true_odom[start:start + k]
        js = jchunk(jc, js, jnp.asarray(buf), jnp.int32(k), jnp.asarray(True), jnp.asarray(o),
                    jnp.asarray(True))
        prog.run_chunk(torch.from_numpy(buf), k, torch.from_numpy(o))
    assert int(prog.state.frame_idx) == 6 and prog.uses == 6
    _jax_ring_matches(prog.state, js, recovered_slack=1)


# ---------------------------------------------------------------------------
# (d) the state's writers on the program's buffers
# ---------------------------------------------------------------------------

def _closed_loop_config():
    cfg = TConfig()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.framepoint_generation.border_pixels = 12
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.8
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.relocalization.preliminary_minimum_interspace_queries = 6
    cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
    cfg.relocalization.icp_minimum_number_of_inliers = 8
    cfg.relocalization.icp_minimum_inlier_ratio = 0.3
    return cfg


def _buffers(engine):
    tr = engine.tracker
    assert tr.program.state is tr.state
    return [t.data_ptr() for _, t in tfused.state_tensors(tr.state)]


def test_closed_loop_writers_at_the_card_cadence_keep_the_buffers(tmp_path):
    """tests/test_torch_closed_loop.py's 48-frame circle, harvested every
    8 frames through prestage + process_prestaged (world corrections and
    merges land between drains), with a checkpoint saved at frame 20 (mid
    drain) and loaded into a fresh engine that runs frames 20-47: the
    events test_card_drain_cadence_on_the_cpu expects (24 local maps, the
    JAX engine's count; >= 1 closure and optimization; 0 breaks; ATE <=
    0.10 m), and neither engine's tracker ever rebinds a buffer."""
    cam = tcam.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4, rows=192,
                           cols=512, device="cpu")
    world = tsyn.make_world(cam, n_points=1500, seed=21,
                            poses=tsyn.circle_trajectory(48, radius=7.0))
    frames = [tsyn.render_frame(world, t)[:2] for t in range(48)]

    def engine():
        eng = SlamEngine(cam, _closed_loop_config(), landmark_capacity=8192, device="cpu")
        eng.tracker.harvest_every = 8
        return eng

    first = engine()
    ptrs = _buffers(first)
    for h in first.tracker.prestage(frames[:20]):
        first.process_prestaged(h)
    path = str(tmp_path / "mid.npz")
    checkpoint.save_checkpoint(first, path)
    assert _buffers(first) == ptrs

    resumed = engine()
    ptrs = _buffers(resumed)
    checkpoint.load_checkpoint(resumed, path)
    assert int(resumed.tracker.state.frame_idx) == 20
    for h in resumed.tracker.prestage(frames[20:]):
        resumed.process_prestaged(h)
    traj = resumed.trajectory
    rep = resumed.report()
    assert _buffers(resumed) == ptrs
    assert rep["tracker_step"] == "program"
    assert traj.shape == (48, 4, 4) and np.all(np.isfinite(traj))
    assert rep["n_local_maps"] == 24
    assert rep["n_closures"] >= 1 and rep["n_optimizations"] >= 1
    assert rep["n_merged_landmarks"] > 0
    ate = ttraj.ate_rmse(traj, world.poses)[0]
    assert rep["n_track_breaks"] == 0 and ate <= 0.10, ate


def test_ba_write_back_at_the_card_cadence_keeps_the_buffers():
    """tests/test_torch_ba_engine.py's 36-frame corridor with BA every 8
    frames, harvested every 8: BA writes landmarks and the live pose back
    between drains.  The JAX engine's BA count (4) and ATE <= 0.05 m, as
    that file holds the port to; no buffer rebound."""
    cam = tcam.make_camera(fx=400.0, fy=400.0, cx=160.0, cy=80.0, baseline_m=0.3, rows=160,
                           cols=320, device="cpu")
    w = tsyn.make_world(cam, n_frames=36, n_points=2500, seed=8, step=0.4, turn_rate=0.004)
    cfg = TConfig()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 10
    cfg.local_map.minimum_number_of_landmarks = 20
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.6
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.command_line.option_disable_relocalization = True
    cfg.graph_optimization.enable_full_bundle_adjustment = True
    cfg.graph_optimization.number_of_frames_per_bundle_adjustment = 8
    eng = SlamEngine(cam, cfg, landmark_capacity=16384, device="cpu")
    eng.tracker.harvest_every = 8
    ptrs = _buffers(eng)
    for t in range(36):
        eng.process(*tsyn.render_frame(w, t)[:2])
    traj = eng.trajectory
    assert _buffers(eng) == ptrs
    assert eng.n_ba_runs == 4
    assert ttraj.ate_rmse(traj, w.poses)[0] <= 0.05


def _split_cam_world():
    cam = tcam.make_camera(fx=300, fy=300, cx=128, cy=64, baseline_m=0.4, rows=128, cols=256,
                           device="cpu")
    world = tsyn.make_world(cam, n_points=800, seed=3,
                            poses=tsyn.circle_trajectory(24, radius=5.0))
    return cam, [tsyn.render_frame(world, t)[:2] for t in range(12)]


def _split_config():
    cfg = TConfig()
    cfg.framepoint_generation.capacity = 128
    cfg.framepoint_generation.detector_threshold_starting_value = 60.0  # it moves
    cfg.tracking.batch_frontend = True
    return cfg


def test_track_program_equals_chunk_step_split():
    """The split pipeline's tails through the TrackProgram (the tracker's
    route) against the eager chunk_step_split on one 8-frame chunk: every
    state tensor equal."""
    cam, frames = _split_cam_world()
    params = ttracker.params_from_config(cam, _split_config(), CPU)
    chunk = torch.from_numpy(np.stack([np.stack(f) for f in frames[:8]]).astype(np.uint8))
    eager = tfused.chunk_step_split(cam, params, tfused.init_state(cam, params, 2048, 60.0),
                                    chunk, 8, True)
    prog = tfused.TrackProgram(cam, params, tfused.init_state(cam, params, 2048, 60.0), True)
    imgs = tfused._chunk_images(cam, params, chunk)
    front = tfused.chunk_front_end(cam, params, prog.state.threshold.clone(), imgs)
    for i in range(8):
        prog.run(front, imgs, i)
    for (name, a), (_, b) in zip(tfused.state_tensors(eager), tfused.state_tensors(prog.state)):
        assert torch.equal(a, b), name
    assert float(prog.state.threshold) != 60.0


def test_split_chunk_keeps_its_threshold_across_a_flush():
    """A flush in the middle of a chunk: the chunk's rest keeps the
    detector threshold of its first frame, which the tracker must copy out
    of the state buffer (that moves on with every tail) -- the same state
    as without the flush."""
    cam, frames = _split_cam_world()
    states = []
    for flush_at in (None, 4):
        tr = ttracker.FusedPoseTracker(cam, _split_config(), landmark_capacity=2048,
                                       device="cpu")
        tr.harvest_every = 8
        for t, (left, right) in enumerate(frames):
            if t == flush_at:
                tr.flush()
            tr.compute(left, right)
        tr.flush()
        states.append(tr.state)
    assert float(states[0].threshold) != 60.0
    for (name, a), (_, b) in zip(tfused.state_tensors(states[0]),
                                 tfused.state_tensors(states[1])):
        assert torch.equal(a, b), name


def test_state_writers_refuse_another_shape_or_dtype():
    cam = tcam.make_camera(fx=300, fy=300, cx=64, cy=32, baseline_m=0.4, rows=64, cols=128,
                           device="cpu")
    tr = ttracker.FusedPoseTracker(cam, TConfig(), landmark_capacity=256, device="cpu")
    st = tr.state
    with pytest.raises(ValueError, match="threshold"):
        tr.state = st._replace(threshold=st.threshold.double())
    with pytest.raises(ValueError, match="table.valid"):
        tr.table = st.table._replace(valid=st.table.valid[:10])
    # A field given another field's tensor is copied out before any write.
    tr.state = st._replace(T_world_cam=st.T_world_cam + 1.0, T_last_kf=st.T_world_cam)
    assert torch.equal(tr.state.T_last_kf, torch.eye(4))
    with pytest.raises(ValueError, match="share memory"):
        tfused.FrameProgram(cam, tr.params, st._replace(last_motion=st.T_world_cam), True,
                               torch.uint8)


# ---------------------------------------------------------------------------
# launch counts under replay, (e) make_transform
# ---------------------------------------------------------------------------

class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _launch_on_the_cpu(monkeypatch, kernel):
    """kernel._launch, the counting call of every CUDA kernel, with a
    library and a stream that do nothing (the CPU has neither)."""
    monkeypatch.setattr(kernel, "build", lambda: None)
    monkeypatch.setattr(kernel, "_entries", (lambda *args: 0, None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return lambda batch: kernel._launch(CPU, batch)


@pytest.mark.parametrize("name", ["K3", "made here"])
def test_replays_add_the_launches_their_capture_withheld(name, monkeypatch):
    """A capture counts none of its launches and each replay adds them:
    K1 and a front-end kernel (K3), or a CudaKernel made here, outside
    the front end, which registers its counter itself."""
    monkeypatch.setattr(cuda_build, "_KERNELS", dict(cuda_build._KERNELS))
    if name == "made here":
        cuda_build.CudaKernel(name, "box_blur.cu", "box_blur", "piiiip", "i")
    counters = cuda_build.counters()
    assert name in counters and "K1" in counters
    launch = _launch_on_the_cpu(monkeypatch, counters[name])
    saved = {k: (c.launches, Counter(c.batches)) for k, c in counters.items()}
    try:
        for c in counters.values():
            c.launches = 0
            c.batches.clear()
        counters["K1"].launches = 5  # earlier runs' launches stay
        record = {}
        with program.withheld_launches(record):  # what a capture's kernels count
            counters["K1"].launches += 1
            counters["K1"].batches[2] += 1
            launch(1)
            launch(1)
        assert counters["K1"].launches == 5 and counters[name].launches == 0
        assert record["K1"] == (1, Counter({2: 1})) and record[name] == (2, Counter({1: 2}))
        assert all(record[k][0] == 0 for k in counters if k not in ("K1", name))

        cam = tcam.make_camera(fx=300, fy=300, cx=64, cy=32, baseline_m=0.4, rows=64,
                               cols=128, device="cpu")
        params = ttracker.params_from_config(cam, TConfig(), CPU)
        prog = tfused.FrameProgram(cam, params, tfused.init_state(cam, params, 256, 20.0),
                                   True, torch.uint8)
        assert isinstance(prog, program.StaticProgram)
        prog.graph, prog.replay_launches, prog.events = _FakeGraph(), record, Counter()
        prog.device, prog.uses = torch.device("cuda"), 1  # a replay's route, with no card
        n = 7
        for _ in range(n):
            assert prog.evaluate() is None  # the frame writes its buffers: nothing to clone
        assert prog.graph.replays == n and prog.events == Counter({"replay": n})
        assert counters["K1"].launches == 5 + n and counters["K1"].batches == Counter({2: n})
        assert counters[name].launches == 2 * n
        assert counters[name].batches == Counter({1: 2 * n})
        assert all(c.launches == 0 for k, c in counters.items() if k not in ("K1", name))
    finally:
        for k, c in counters.items():
            c.launches = saved[k][0]
            c.batches.clear()
            c.batches.update(saved[k][1])


def _make_transform_with_host_row(R, t):
    """make_transform as it was: the bottom row copied from host data."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
def test_make_transform_keeps_its_bits_without_host_data(batch):
    rng = np.random.default_rng(7)
    R = lie.exp_so3(torch.from_numpy(rng.normal(size=batch + (3,)).astype(np.float32)))
    t = torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))
    want = _make_transform_with_host_row(R, t)
    with NoHostData():
        got = lie.make_transform(R, t)
    assert got.dtype == want.dtype and torch.equal(got, want)
