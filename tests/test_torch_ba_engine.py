"""Windowed bundle adjustment in the live engine (system/ba_runner.py,
SlamEngine's BA cadence) against the JAX engine on the CPU, with the
settings of tests/test_ba_engine.py: 36 frames at 160 x 320, BA every 8
frames, relocalization off.

Tolerances:
  * BA on, border 20 (the port takes K1's plain version, whose intra-bin
    tie order differs from JAX's staged path): the same number of BA
    runs and local maps, ATE within 1e-3 m of JAX's (measured 2.4e-4);
  * the window problem: the JAX runner's on the port engine's state is
    the port's, exactly (padding included: both pad P to the window and
    L to a power of two, floor 64 on the CPU); one BA on each: poses
    within 1e-4, positions within 1e-3 m.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vslam_tpu.backend import ba as jba
from vslam_tpu.eval import trajectory as jtraj
from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.ops import camera as jcam
from vslam_tpu.system import ba_runner as jrunner
from vslam_tpu.system.engine import SlamEngine as JEngine
from vslam_tpu_torch.backend import ba as tba
from vslam_tpu_torch.eval import trajectory as ttraj
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.system import ba_runner as trunner
from vslam_tpu_torch.system.engine import SlamEngine as TEngine

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAM_ARGS = dict(fx=400.0, fy=400.0, cx=160.0, cy=80.0, baseline_m=0.3, rows=160, cols=320)
N_FRAMES = 36


def make_cfg(cls, ba: bool):
    cfg = cls()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 10
    cfg.local_map.minimum_number_of_landmarks = 20
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.6
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.command_line.option_disable_relocalization = True  # isolate BA
    cfg.graph_optimization.enable_full_bundle_adjustment = ba
    cfg.graph_optimization.number_of_frames_per_bundle_adjustment = 8
    # One device, as the port (the harness gives JAX 8 virtual devices).
    cfg.parallelism.shard_descriptor_db = False
    cfg.parallelism.shard_landmarks = False
    return cfg


@pytest.fixture(scope="module")
def world_frames():
    w = tsyn.make_world(tcam.make_camera(**CAM_ARGS, device="cpu"), n_frames=N_FRAMES,
                        n_points=2500, seed=8, step=0.4, turn_rate=0.004)
    return w, [tsyn.render_frame(w, t)[:2] for t in range(N_FRAMES)]


@pytest.fixture(scope="module")
def engines(world_frames):
    """The JAX and the port engine, BA on, frame by frame."""
    _, frames = world_frames
    jeng = JEngine(jcam.make_camera(**CAM_ARGS), make_cfg(JConfig, True),
                   landmark_capacity=16384)
    teng = TEngine(tcam.make_camera(**CAM_ARGS, device="cpu"), make_cfg(TConfig, True),
                   landmark_capacity=16384, device="cpu")
    for left, right in frames:
        jeng.process(left, right)
        teng.process(left, right)
    jeng._flush_tracker()
    teng._flush_tracker()
    return jeng, teng


def test_ba_engine_matches_jax(world_frames, engines):
    w, _ = world_frames
    jeng, teng = engines
    assert jeng.n_ba_runs >= 1
    assert teng.n_ba_runs == jeng.n_ba_runs
    rep = teng.report()
    assert rep["n_ba_runs"] == teng.n_ba_runs
    assert rep["stage_table"]["bundle_adjustment"]["calls"] >= teng.n_ba_runs
    assert len(teng.world_map.local_maps) == len(jeng.world_map.local_maps)
    ate_j = jtraj.ate_rmse(np.stack(jeng.tracker.trajectory), w.poses)[0]
    ate_t = ttraj.ate_rmse(np.stack(teng.tracker.trajectory), w.poses)[0]
    assert ate_t <= 0.05 and abs(ate_t - ate_j) <= 1e-3, (ate_t, ate_j)
    t = teng.tracker.state.table
    assert torch.isfinite(t.xyz_w[t.valid]).all()


def test_window_problem_matches_jax(engines):
    """The JAX runner's build_window_problem on the port engine's final
    state (local maps, pose-graph bookkeeping, landmark table) gives the
    port's problem exactly, padding included; one BA on each agrees as in
    tests/test_torch_ba.py."""
    _, teng = engines
    t = teng.tracker.state.table
    view = SimpleNamespace(
        world_map=teng.world_map, cfg=teng.cfg, kf_poses=teng.kf_poses,
        kf_odom_weight=teng.kf_odom_weight,
        tracker=SimpleNamespace(state=None, table=SimpleNamespace(
            xyz_w=t.xyz_w.numpy(), n_updates=t.n_updates.numpy())))
    jprob, jkf, jslots, n = jrunner.build_window_problem(view)
    tprob, tkf, tslots = trunner.build_window_problem(teng)
    assert tkf == jkf and len(tkf) >= 2 and n >= 16
    np.testing.assert_array_equal(tslots, np.asarray(jslots)[:n])
    P = len(tkf)
    for name in ("xyz", "obs_cam", "obs_uv4", "obs_weight", "obs_mask", "lm_valid", "T_wc",
                 "cam_fixed", "odo_T", "odo_weight", "odo_info"):
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)), err_msg=name)
    # The JAX runner pads P to its window and L to a power of two: frozen,
    # unlinked cameras and invalid landmarks.
    assert np.asarray(jprob.cam_fixed)[P:].all() and not np.asarray(jprob.odo_weight)[P - 1:].any()
    assert not np.asarray(jprob.lm_valid)[n:].any()
    config = trunner.ba_config(teng)
    Tj, Xj, _ = jba.bundle_adjust(jcam.make_camera(**CAM_ARGS), jprob, jba.BAConfig(
        iterations=config.iterations, robust_chi2=config.robust_chi2))
    Tt, Xt, _ = tba.bundle_adjust(teng.cam, tprob, config)
    assert np.abs(Tt.numpy() - np.asarray(Tj)).max() <= 1e-4
    assert np.abs(Xt.numpy() - np.asarray(Xj)).max() <= 1e-3


def test_ba_at_the_card_drain_cadence(world_frames):
    """Harvest every 8 frames, as the card does every frames_per_chunk: a
    drain then holds several keyframes, and BA runs while registering one
    of them.  Its correction must reach the drain's later snapshots too,
    so every keyframe pose stays the trajectory's pose at that frame."""
    w, frames = world_frames
    eng = TEngine(tcam.make_camera(**CAM_ARGS, device="cpu"), make_cfg(TConfig, True),
                  landmark_capacity=16384, device="cpu")
    eng.tracker.harvest_every = 8
    for h in eng.tracker.prestage(frames):
        eng.process_prestaged(h)
    traj = eng.trajectory
    assert eng.n_ba_runs >= 1
    assert ttraj.ate_rmse(traj, w.poses)[0] <= 0.05
    for k, m in enumerate(eng.world_map.local_maps):
        np.testing.assert_allclose(m.T_world_kf, eng.kf_poses[k], atol=1e-6)
        np.testing.assert_allclose(traj[eng.kf_frame_indices[k]], eng.kf_poses[k], atol=1e-4)


def test_ba_moves_the_drain_later_landmarks_with_the_live_pose(world_frames, monkeypatch):
    """Harvest every 8 frames: BA runs while one keyframe k of a drain is
    registered, and the tracker has already spawned landmarks from the
    drain's later frames (origin_kf > k).  The correction that moves the
    live pose must move them too: each keeps its position in the live
    camera frame across the BA call, within 1e-5 m."""
    _, frames = world_frames
    eng = TEngine(tcam.make_camera(**CAM_ARGS, device="cpu"), make_cfg(TConfig, True),
                  landmark_capacity=16384, device="cpu")
    eng.tracker.harvest_every = 8
    build, run = trunner.build_window_problem, trunner.run_windowed_ba
    windows, checked = [], []

    def build_and_record(engine, *args, **kwargs):
        built = build(engine, *args, **kwargs)
        windows.append(None if built is None else built[1][-1])
        return built

    def in_live_camera(state):
        # The f32 correction is orthonormal only to ~1e-7, so invert the
        # pose exactly rather than by its transpose.
        t = state.table
        T_cw = torch.linalg.inv(state.T_world_cam.double())
        p = t.xyz_w.double() @ T_cw[:3, :3].T + T_cw[:3, 3]
        return p.numpy(), (t.valid & (t.origin_kf > windows[-1])).numpy()

    def run_and_check(engine, *args, **kwargs):
        before = engine.tracker.state
        C = run(engine, *args, **kwargs)
        if C is not None and not np.allclose(C, np.eye(4), atol=1e-4):
            p0, later = in_live_camera(before)
            p1, _ = in_live_camera(engine.tracker.state)
            assert later.sum() > 20
            assert np.abs(p1[later] - p0[later]).max() <= 1e-5
            checked.append(int(later.sum()))
        return C

    monkeypatch.setattr(trunner, "build_window_problem", build_and_record)
    monkeypatch.setattr(trunner, "run_windowed_ba", run_and_check)
    for h in eng.tracker.prestage(frames):
        eng.process_prestaged(h)
    eng.trajectory
    assert checked, (eng.n_ba_runs, windows)


def test_ba_with_rgb_depth_is_refused():
    """The JAX engine with BA and RGB_DEPTH optimizes [u, v, z, 0]
    observations as stereo [uL, vL, uR, vR]; the port refuses the pair."""
    cfg = make_cfg(TConfig, True)
    cfg.command_line.tracker_mode = "RGB_DEPTH"
    with pytest.raises(ValueError, match="RGB_DEPTH"):
        TEngine(tcam.make_camera(**CAM_ARGS, device="cpu"), cfg, landmark_capacity=1024,
                device="cpu")
