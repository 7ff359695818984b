"""The programs bench.py keeps out of its timed loop, on the port: one
tracker program a configuration for the whole process (the JAX package's
memoized make_frame_step / make_track_step), trackers taking turns on it,
the shared closure ICP buckets and the three warm-ups.

  * memo keys: equal keys give the same program; each field of the key
    changed gives another.
  * hand-off: trackers stepped alternately on one shared program give
    every state tensor and every pose bit for bit as each run alone (a
    third tracker built while two are live, too), on the per-frame and
    the split route.
  * a warmed engine: bench.py's order (an engine with BA over the first
    frames, then the warm-ups) and then a fresh engine over the closed
    loop at the card's drain cadence (every 8 frames) give the bits,
    closures and events of an engine in an empty cache, at borders 12 and
    20 (tests/test_torch_closed_loop.py's 48-frame circle); its closure
    ICP batches make no new ICPProgram.
  * warm_icp_batches: a warmed bucket solves a batch bit for bit as a
    fresh program; warm_windowed_ba does nothing on the CPU or with BA
    off (as the JAX package's), and the BA engine after both warm-ups
    gives the unwarmed engine's bits.

bench.py's JSON line itself is tests/test_torch_cli.py's
test_cli_bench_runs_the_workload.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vslam_tpu_torch.backend import ba as tba
from vslam_tpu_torch.backend import pose_graph as tpg
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.loop import relocalizer as trl
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.system import ba_runner
from vslam_tpu_torch.system.engine import SlamEngine
from vslam_tpu_torch.tracking import fused as tfused
from vslam_tpu_torch.tracking.tracker import FusedPoseTracker, params_from_config

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SMALL_CAM = dict(fx=300.0, fy=300.0, cx=128.0, cy=64.0, baseline_m=0.4, rows=128, cols=256)


@pytest.fixture(autouse=True)
def empty_caches():
    """Each test starts, and leaves, with no shared program."""
    tfused.clear_programs()
    trl.clear_icp_programs()
    yield
    tfused.clear_programs()
    trl.clear_icp_programs()


def _cam(**changes):
    return tcam.make_camera(**{**SMALL_CAM, **changes}, device="cpu")


def _frame_key_args(field):
    """make_frame_step's arguments with one key field changed."""
    cam = _cam()
    params = params_from_config(cam, TConfig(), torch.device("cpu"))
    calib = (torch.eye(3), torch.eye(4))
    args = dict(cam=cam, params=params, landmark_capacity=1024, frame_dtype=torch.uint8,
                odometry=False, depth_calib=None)
    changed = {
        "same": {},
        "camera": dict(cam=_cam(fx=301.0)),
        "baseline": dict(cam=_cam(baseline_m=0.5)),
        "image size": dict(cam=_cam(rows=96)),
        "params": dict(params=params._replace(capacity=512)),
        "landmark capacity": dict(landmark_capacity=2048),
        "frame dtype": dict(frame_dtype=torch.float32),
        "odometry": dict(odometry=True),
        "depth calibration": dict(depth_calib=calib),
    }[field]
    return {**args, **changed}


@pytest.mark.parametrize("field", ["same", "camera", "baseline", "image size", "params",
                                   "landmark capacity", "frame dtype", "odometry",
                                   "depth calibration"])
def test_one_program_per_key(field):
    first = tfused.make_frame_step(**_frame_key_args("same"))
    again = tfused.make_frame_step(**_frame_key_args(field))
    assert (again is first) == (field == "same")
    if field == "same":
        # A key by value: a camera equal in every value but made anew.
        assert tfused.make_frame_step(**{**_frame_key_args("same"), "cam": _cam()}) is first
    # The program owns its camera: a caller's tensors are not its buffers.
    assert again.cam.K.data_ptr() != _frame_key_args(field)["cam"].K.data_ptr()
    track = tfused.make_track_step(first.cam, first.params, 1024)
    assert track is tfused.make_track_step(_cam(), first.params, 1024)
    assert track is not first and track is not tfused.make_track_step(_cam(), first.params, 2048)


def _tracker_runs(split):
    """Three 12-frame sequences (three worlds) and the configuration."""
    cam = _cam()
    cfg = TConfig()
    cfg.framepoint_generation.capacity = 128
    cfg.framepoint_generation.detector_threshold_starting_value = 40.0
    cfg.tracking.batch_frontend = split
    seqs = []
    for seed in (3, 4, 5):
        world = tsyn.make_world(cam, n_points=800, seed=seed,
                                poses=tsyn.circle_trajectory(24, radius=5.0))
        seqs.append([tsyn.render_frame(world, t)[:2] for t in range(12)])
    return cam, cfg, seqs


def _tracker(cam, cfg, split):
    tr = FusedPoseTracker(cam, cfg, landmark_capacity=2048, device="cpu")
    if split:
        tr.harvest_every = 4
    return tr


def _finish(tr):
    tr.flush()
    return np.stack(tr.trajectory), [(n, t.clone()) for n, t in tfused.state_tensors(tr.state)]


@pytest.mark.parametrize("split", [False, True], ids=["per-frame", "split"])
def test_trackers_taking_turns_equal_each_alone(split):
    """A and B alternate frame by frame; C is built after frame 5, while
    both are live, and joins the rotation.  Each ends with the bits it
    gets alone in an empty cache."""
    cam, cfg, seqs = _tracker_runs(split)
    alone = []
    for seq in seqs:
        tfused.clear_programs()
        tr = _tracker(cam, cfg, split)
        for left, right in seq:
            tr.compute(left, right)
        alone.append(_finish(tr))

    tfused.clear_programs()
    trackers = [_tracker(cam, cfg, split), _tracker(cam, cfg, split)]
    steps = [0, 0, 0]
    for t in range(12):
        if t == 6:
            trackers.append(_tracker(cam, cfg, split))
        for k, tr in enumerate(trackers):
            tr.compute(*seqs[k][steps[k]])
            steps[k] += 1
    for k in (2,):  # C catches up
        while steps[k] < 12:
            trackers[k].compute(*seqs[k][steps[k]])
            steps[k] += 1
    assert len({id(tr.program) for tr in trackers}) == 1
    for tr, (traj, state) in zip(trackers, alone):
        got_traj, got_state = _finish(tr)
        np.testing.assert_array_equal(got_traj, traj)
        for (name, a), (_, b) in zip(got_state, state):
            assert torch.equal(a, b), name
    # Two trackers never share a buffer: only the holder's state is the program's.
    holders = [tr for tr in trackers if tr.state is tr.program.state]
    assert len(holders) == 1
    ptrs = {t.data_ptr() for tr in trackers for _, t in tfused.state_tensors(tr.state)}
    assert len(ptrs) == 3 * len(tfused.state_tensors(trackers[0].state))


# ---------------------------------------------------------------------------
# A fresh engine after a warm one (bench.py's order)
# ---------------------------------------------------------------------------

CLOSED_CAM = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4, rows=192, cols=512)
CLOSED_FRAMES = 48
WARM_FRAMES = 16


def _closed_config(border, ba=False):
    cfg = TConfig()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.framepoint_generation.border_pixels = border
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.8
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.relocalization.preliminary_minimum_interspace_queries = 6
    cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
    cfg.relocalization.icp_minimum_number_of_inliers = 8
    cfg.relocalization.icp_minimum_inlier_ratio = 0.3
    cfg.graph_optimization.enable_full_bundle_adjustment = ba
    cfg.graph_optimization.number_of_frames_per_bundle_adjustment = 8
    return cfg


@pytest.fixture(scope="module")
def closed_world():
    cam = tcam.make_camera(**CLOSED_CAM, device="cpu")
    world = tsyn.make_world(cam, n_points=1500, seed=21,
                            poses=tsyn.circle_trajectory(CLOSED_FRAMES, radius=7.0))
    return cam, [tsyn.render_frame(world, t)[:2] for t in range(CLOSED_FRAMES)]


def _engine_run(cam, cfg, frames):
    eng = SlamEngine(cam, cfg, landmark_capacity=8192, device="cpu")
    eng.tracker.harvest_every = 8  # the card's cadence: prestaged handles of 8
    for h in eng.tracker.prestage(frames):
        eng.process_prestaged(h)
    eng._flush_tracker()
    rep = eng.report()
    return dict(traj=np.stack(eng.tracker.trajectory),
                closures=[(c.query_id, c.reference_id, c.T_ref_query.tobytes())
                          for c in eng.world_map.closures],
                events={k: rep[k] for k in ("n_local_maps", "n_closures", "n_optimizations",
                                            "n_merged_landmarks", "n_track_breaks")},
                table=[(n, t.clone()) for n, t in tfused.state_tensors(eng.tracker.state)],
                db_rows=eng.relocalizer.n_rows)


@pytest.mark.parametrize("border", [12, 20])
def test_engine_after_a_warm_engine_equals_one_in_an_empty_cache(closed_world, border):
    cam, frames = closed_world
    cfg = _closed_config(border)
    want = _engine_run(cam, cfg, frames)
    assert want["events"]["n_closures"] >= 1 and want["events"]["n_optimizations"] >= 1

    tfused.clear_programs()
    trl.clear_icp_programs()
    warm = SlamEngine(cam, _closed_config(border, ba=True), landmark_capacity=8192,
                      device="cpu")
    warm.tracker.harvest_every = 8
    ba_runner.warm_windowed_ba(warm)
    for h in warm.tracker.prestage(frames[:WARM_FRAMES]):
        warm.process_prestaged(h)
    warm._flush_tracker()
    tpg.warm_hierarchical_buckets(max_keyframes=64, device="cpu")
    trl.warm_icp_batches(cfg.relocalization, device="cpu")
    programs = (dict(tfused._PROGRAMS), dict(trl._PROGRAMS))
    assert len(programs[1]) == 2  # buckets 8 and 16
    got = _engine_run(cam, cfg, frames)
    del warm

    assert (dict(tfused._PROGRAMS), dict(trl._PROGRAMS)) == programs  # nothing new built
    assert got["events"] == want["events"] and got["db_rows"] == want["db_rows"]
    assert got["closures"] == want["closures"]
    np.testing.assert_array_equal(got["traj"], want["traj"])
    for (name, a), (_, b) in zip(got["table"], want["table"]):
        assert torch.equal(a, b), name


def test_warmed_icp_bucket_solves_as_a_fresh_program():
    p = TConfig().relocalization
    trl.warm_icp_batches(p, device="cpu")
    keys = set(trl._PROGRAMS)
    assert {k[1] for k in keys} == set(trl.ICP_BUCKETS)
    trl.warm_icp_batches(p, device="cpu")
    assert set(trl._PROGRAMS) == keys
    rng = np.random.default_rng(2)
    cap = int(p.icp_correspondence_cap)
    n = 5
    fix = rng.uniform(-5, 5, (n, cap, 3)).astype(np.float32)
    fix[..., 2] += 10.0
    mov = fix + rng.normal(0, 0.01, fix.shape).astype(np.float32)
    mask = np.arange(cap)[None, :] < rng.integers(40, cap, n)[:, None]
    args = [torch.from_numpy(a) for a in (mov, fix, mask)]
    args.append(torch.eye(4).repeat(n, 1, 1))
    warmed = trl.icp_program(p, 8, "cpu")
    fresh = trl.ICPProgram(warmed.solve, warmed.config, 8, cap, "cpu")
    for a, b in zip(warmed.run(*args), fresh.run(*args)):
        assert torch.equal(a, b)


def test_ba_warm_ups_leave_a_later_engine_unchanged(monkeypatch):
    """tests/test_torch_ba_engine.py's corridor with BA every 8 frames:
    the BA engine after warm_hierarchical_buckets and warm_windowed_ba
    gives the unwarmed engine's bits and BA count.  On the CPU, and with
    BA off, warm_windowed_ba solves nothing (the JAX package's returns
    early on the CPU too)."""
    cam = tcam.make_camera(fx=400.0, fy=400.0, cx=160.0, cy=80.0, baseline_m=0.3, rows=160,
                           cols=320, device="cpu")
    w = tsyn.make_world(cam, n_frames=24, n_points=2500, seed=8, step=0.4, turn_rate=0.004)
    frames = [tsyn.render_frame(w, t)[:2] for t in range(24)]
    cfg = TConfig()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 10
    cfg.local_map.minimum_number_of_landmarks = 20
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.6
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.command_line.option_disable_relocalization = True
    cfg.graph_optimization.enable_full_bundle_adjustment = True
    cfg.graph_optimization.number_of_frames_per_bundle_adjustment = 8

    def run(warm):
        tfused.clear_programs()
        eng = SlamEngine(cam, cfg, landmark_capacity=16384, device="cpu")
        if warm:
            solves = []
            monkeypatch.setattr(tba, "bundle_adjust", lambda *a, **k: solves.append(a))
            ba_runner.warm_windowed_ba(eng)
            monkeypatch.undo()
            assert solves == []
            tpg.warm_hierarchical_buckets(max_keyframes=64, device="cpu")
        for left, right in frames:
            eng.process(left, right)
        return eng.trajectory, eng.n_ba_runs

    cfg_off = TConfig()
    cfg_off.graph_optimization.enable_full_bundle_adjustment = False
    # BA off: nothing, before the device is looked at.
    assert ba_runner.warm_windowed_ba(SimpleNamespace(cfg=cfg_off, device=None)) is None

    want_traj, want_runs = run(warm=False)
    got_traj, got_runs = run(warm=True)
    assert want_runs >= 2 and got_runs == want_runs
    np.testing.assert_array_equal(got_traj, want_traj)
