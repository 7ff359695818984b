"""The modular tracker's pieces and the modular PoseTracker
(tracking.use_fused_tracker: false) against the JAX package's on the CPU.

  * ThresholdController and SlotAllocator sequences: exact;
  * spawn_landmarks and update_observed: integer and flag columns exact,
    positions within 1e-5 m, information within 1e-5 of its value (~50
    here); spawn then update equals the
    port's fused spawn_and_update_observed (integers exact, floats 1e-5:
    the fused form starts the fresh rows from the spawn position itself,
    not from its add-delta);
  * process_stereo_pair at border 12 and a width that is a multiple of
    16 (the staged front-end in both packages): keypoints, descriptors,
    validity and counts bit-exact, points within rtol 1e-6;
  * PoseTracker, tests/test_tracker_e2e.py's settings (320 x 640,
    capacity 512, bin 12) at border 12, 20 frames: per frame the keypoint
    count, detector threshold, status, break count and allocation count
    equal, every position within 1e-4 m;
  * RGB-D, tests/test_torch_rgbd.py's 16-frame scene, held the same way;
  * the port's FusedPoseTracker against its PoseTracker on the stereo
    frames: positions within 0.1 m (tests/test_fused.py's bound; the two
    differ in the retry ladder and the controller's dead band).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.frontend import detect as jdetect
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.mapping import frame as jframe
from vslam_tpu.mapping import landmarks as jlm
from vslam_tpu.ops import camera as jcam
from vslam_tpu.tracking.tracker import PoseTracker as JTracker
from vslam_tpu_torch.frontend import detect as tdetect
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.mapping import frame as tframe
from vslam_tpu_torch.mapping import landmarks as tlm
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.tracking.tracker import TRACKING, FusedPoseTracker
from vslam_tpu_torch.tracking.tracker import PoseTracker as TTracker

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAM_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=160.0, baseline_m=0.4, rows=320, cols=640)
N_FRAMES = 20
RGBD_ARGS = dict(fx=300.0, fy=300.0, cx=160.0, cy=96.0, baseline_m=0.075, rows=192, cols=320)
RGBD_FRAMES = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_threshold_controller_sequences_are_exact(seed):
    rng = np.random.default_rng(seed)
    kw = dict(initial=25.0, target_count=312, max_change=10.0, minimum=5.0, maximum=100.0)
    jc, tc = jdetect.ThresholdController(**kw), tdetect.ThresholdController(**kw)
    for n in rng.integers(0, 900, 200):
        assert tc.update(int(n)) == jc.update(int(n))
        assert tc.threshold == jc.threshold


def test_slot_allocator_sequences_are_exact():
    rng = np.random.default_rng(2)
    ja, ta = jlm.SlotAllocator(300), tlm.SlotAllocator(300)
    live = []
    for _ in range(120):
        if live and rng.uniform() < 0.4:
            k = int(rng.integers(1, len(live) + 1))
            rel = [live.pop(int(rng.integers(len(live)))) for _ in range(k)]
            rel_arr = np.asarray(rel + [-1], np.int32)  # -1 is skipped
            ja.release(rel_arr)
            ta.release(rel_arr)
        else:
            n = int(rng.integers(0, 40))
            a, b = ja.allocate(n), ta.allocate(n)
            np.testing.assert_array_equal(b, a)
            assert b.dtype == np.int32
            live += [int(s) for s in b if s >= 0]
        assert ta.num_allocated == ja.num_allocated and ta._next == ja._next
        assert ta._free == ja._free
    assert (ta.allocate(400) == -1).any()  # past the capacity


def _tables(seed, cap=64):
    """The same random landmark table in both packages (JAX's, the port's)."""
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=cap) < 0.6
    cols = dict(
        xyz_w=np.stack([rng.uniform(-4, 4, cap), rng.uniform(-2, 2, cap),
                        rng.uniform(5, 20, cap)], 1).astype(np.float32),
        H_acc=(np.eye(3, dtype=np.float32)[None] * rng.uniform(1, 50, (cap, 1, 1))
               ).astype(np.float32),
        desc=rng.integers(0, 2**32, (cap, 8), dtype=np.uint64).astype(np.uint32),
        n_updates=np.where(valid, rng.integers(1, 9, cap), 0).astype(np.int32),
        last_seen=np.where(valid, rng.integers(0, 5, cap), -1).astype(np.int32),
        valid=valid,
        origin_kf=rng.integers(0, 4, cap).astype(np.int32),
        protected=valid & (rng.uniform(size=cap) < 0.3),
    )
    jt = jlm.LandmarkTable(**{k: jnp.asarray(v) for k, v in cols.items()})
    tt = tlm.LandmarkTable(**{k: _t(v.view(np.int32) if k == "desc" else v)
                              for k, v in cols.items()})
    return jt, tt, valid


def _assert_tables(tt, jt, atol=1e-5):
    for k in tlm.LandmarkTable._fields:
        got, ref = getattr(tt, k).numpy(), np.asarray(getattr(jt, k))
        if k == "desc":
            ref = ref.view(np.int32)
        if got.dtype.kind == "f":
            # Information entries reach ~50: 1e-5 of them (a few f32 ulps;
            # JAX takes the refinement's Jacobian by jacfwd, the port in
            # closed form).
            np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)


def _frame_obs(seed, valid, K=32):
    """K framepoints: some observe valid landmarks, some spawn, some are
    invalid; returns (slots, assigned, p_cam, uv4, desc, point_valid)."""
    rng = np.random.default_rng(seed)
    live = rng.permutation(np.flatnonzero(valid))[:12]
    free = rng.permutation(np.flatnonzero(~valid))[:8]
    slots = np.full(K, -1, np.int32)
    slots[:len(live)] = live
    assigned = np.full(K, -1, np.int32)
    assigned[len(live):len(live) + len(free)] = free
    p_cam = np.stack([rng.uniform(-3, 3, K), rng.uniform(-1, 1, K),
                      rng.uniform(4, 18, K)], 1).astype(np.float32)
    uv_l = np.stack([500 * p_cam[:, 0] / p_cam[:, 2] + 320,
                     500 * p_cam[:, 1] / p_cam[:, 2] + 160], 1)
    uv4 = np.concatenate([uv_l, uv_l - [500 * 0.4, 0] / p_cam[:, 2:]], 1)
    uv4 = (uv4 + rng.normal(0, 0.5, uv4.shape)).astype(np.float32)
    desc = rng.integers(0, 2**32, (K, 8), dtype=np.uint64).astype(np.uint32)
    # A spawning row is a valid point (the tracker spawns valid ones only).
    point_valid = (rng.uniform(size=K) < 0.9) | (assigned >= 0)
    return slots, assigned, p_cam, uv4, desc, point_valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spawn_and_update_observed_match_jax(seed):
    jt, tt, valid = _tables(seed)
    slots, assigned, p_cam, uv4, desc, pv = _frame_obs(seed + 10, valid)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.05, 0.3]
    xyz_spawn = p_cam @ T[:3, :3].T + T[:3, 3]
    jcam_, tcam_ = jcam.make_camera(**CAM_ARGS), tcam.make_camera(**CAM_ARGS, device="cpu")

    jt1 = jlm.spawn_landmarks(jt, jnp.asarray(assigned), jnp.asarray(xyz_spawn),
                              jnp.asarray(desc), jnp.int32(7), origin_kf=jnp.int32(3))
    tt1 = tlm.spawn_landmarks(tt, _t(assigned), _t(xyz_spawn), _t(desc.view(np.int32)), 7,
                              origin_kf=3)
    _assert_tables(tt1, jt1)
    all_slots = np.where(assigned >= 0, assigned, slots)
    jt2 = jlm.update_observed(jcam_, jt1, jnp.asarray(T), jnp.asarray(all_slots),
                              jnp.asarray(uv4), jnp.asarray(desc), jnp.asarray(pv), jnp.int32(7))
    tt2 = tlm.update_observed(tcam_, tt1, _t(T), _t(all_slots), _t(uv4),
                              _t(desc.view(np.int32)), _t(pv), 7)
    _assert_tables(tt2, jt2)
    assert (tt2.n_updates.numpy() != tt.n_updates.numpy()).sum() >= 10  # real updates

    fused = tlm.spawn_and_update_observed(
        tcam_, tt, _t(T), _t(all_slots), _t(assigned >= 0), _t(p_cam), _t(uv4),
        _t(desc.view(np.int32)), _t(pv), torch.tensor(7, dtype=torch.int32),
        torch.tensor(3, dtype=torch.int32))
    for k in tlm.LandmarkTable._fields:
        if k == "protected":  # the fused form also unprotects a fresh row only when observed
            continue
        got, ref = getattr(fused, k).numpy(), getattr(tt2, k).numpy()
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)


def _cfg(cls, **over):
    cfg = cls()
    fp = cfg.framepoint_generation
    fp.capacity = 512
    fp.bin_size_pixels = 12
    fp.border_pixels = 12
    fp.detector_threshold_starting_value = 25.0
    for k, v in over.items():
        setattr(fp, k, v)
    return cfg


@pytest.fixture(scope="module")
def stereo_frames():
    world = jsyn.make_world(jcam.make_camera(**CAM_ARGS), n_frames=N_FRAMES, n_points=3000,
                            seed=9, step=0.4, turn_rate=0.003)
    return world, [jsyn.render_frame(world, t)[:2] for t in range(N_FRAMES)]


@pytest.mark.parametrize("frame_idx", [0, 5])
def test_process_stereo_pair_matches_jax(stereo_frames, frame_idx):
    _, frames = stereo_frames
    left, right = (np.asarray(a, np.float32) for a in frames[frame_idx])
    kw = dict(capacity=512, bin_size=12, border=12)
    jf, jnk, jnf = jframe.process_stereo_pair(
        jcam.make_camera(**CAM_ARGS), jnp.asarray(left), jnp.asarray(right), jnp.float32(25.0),
        jnp.int32(50), jnp.float32(1.0), jnp.float32(1.0), jnp.float32(200.0), **kw)
    tf, tnk, tnf = tframe.process_stereo_pair(
        tcam.make_camera(**CAM_ARGS, device="cpu"), _t(left), _t(right), torch.tensor(25.0),
        50, 1.0, 1.0, 200.0, **kw)
    assert int(tnk) == int(jnk) and int(tnf) == int(jnf) and int(tnk) > 100
    for k in ("uv4", "valid", "track_len", "landmark_slot", "reliable"):
        np.testing.assert_array_equal(getattr(tf, k).numpy(), np.asarray(getattr(jf, k)), k)
    np.testing.assert_array_equal(tf.desc.numpy(), np.asarray(jf.desc).view(np.int32))
    np.testing.assert_allclose(tf.p_cam.numpy(), np.asarray(jf.p_cam), rtol=1e-6)


def _run(tracker, frames):
    """Per-frame (keypoints, threshold, status, breaks, allocated) and the
    trajectory."""
    rows, n_kp = [], 0
    for f in frames:
        tracker.compute(*f)
        rows.append((tracker.stats.n_keypoints - n_kp, tracker.controller.threshold,
                     tracker.status, tracker.stats.n_breaks, tracker.allocator.num_allocated))
        n_kp = tracker.stats.n_keypoints
    return rows, np.stack(tracker.trajectory)


@pytest.fixture(scope="module")
def stereo_runs(stereo_frames):
    _, frames = stereo_frames
    jt = JTracker(jcam.make_camera(**CAM_ARGS), _cfg(JConfig), landmark_capacity=16384)
    tt = TTracker(tcam.make_camera(**CAM_ARGS, device="cpu"), _cfg(TConfig),
                  landmark_capacity=16384, device="cpu")
    return _run(jt, frames), _run(tt, frames), tt


def test_pose_tracker_matches_jax(stereo_frames, stereo_runs):
    world, _ = stereo_frames
    (jrows, jtraj), (trows, ttraj), tt = stereo_runs
    assert trows == jrows
    assert trows[-1][2] == TRACKING and trows[-1][3] == 0 and trows[-1][4] > 500
    assert np.abs(ttraj[:, :3, 3] - jtraj[:, :3, 3]).max() <= 1e-4
    assert np.abs(ttraj[-1, :3, 3] - world.poses[-1][:3, 3]).max() <= 0.1
    assert tt.stats.n_spawned == tt.allocator.num_allocated
    assert int(tt.table.valid.sum()) == tt.allocator.num_allocated


def test_fused_tracker_close_to_modular(stereo_frames, stereo_runs):
    _, frames = stereo_frames
    _, (_, modular), _ = stereo_runs
    fused = FusedPoseTracker(tcam.make_camera(**CAM_ARGS, device="cpu"), _cfg(TConfig),
                             landmark_capacity=16384, device="cpu")
    for f in frames:
        fused.compute(*f)
    fused.flush()
    gap = np.linalg.norm(np.stack(fused.trajectory)[:, :3, 3] - modular[:, :3, 3], axis=1)
    assert fused.stats.n_breaks == 0 and gap.max() < 0.1, gap


def test_rgbd_pose_tracker_matches_jax():
    world = tsyn.make_world(tcam.make_camera(**RGBD_ARGS, device="cpu"), n_frames=RGBD_FRAMES,
                            n_points=2500, seed=7, step=0.3)
    frames = [tsyn.render_depth_frame(world, t) for t in range(RGBD_FRAMES)]

    def cfg(cls):
        c = cls()
        c.command_line.tracker_mode = "RGB_DEPTH"
        c.framepoint_generation.capacity = 256
        c.framepoint_generation.bin_size_pixels = 10
        c.framepoint_generation.maximum_depth_meters = 30.0
        return c

    jt = JTracker(jcam.make_camera(**RGBD_ARGS), cfg(JConfig), landmark_capacity=8192)
    tt = TTracker(tcam.make_camera(**RGBD_ARGS, device="cpu"), cfg(TConfig),
                  landmark_capacity=8192, device="cpu")
    assert tt.mode == "depth"
    (jrows, jtraj), (trows, ttraj) = _run(jt, frames), _run(tt, frames)
    assert trows == jrows
    assert trows[-1][2] == TRACKING and trows[-1][3] == 0 and trows[-1][4] > 100
    assert np.abs(ttraj[:, :3, 3] - jtraj[:, :3, 3]).max() <= 1e-4
    assert np.abs(ttraj[-1, :3, 3] - world.poses[-1][:3, 3]).max() <= 0.05
