"""The split (chunk-batched) front-end: tracking.batch_frontend.

  * frame.frontend_chunk against k per-frame front-ends at the same
    threshold, bit for bit (every FrameState field, n_kp, n_fp, planes),
    on each route: K1's plain version (BRIEF256, one octave, border 20),
    the staged path at two octaves, BRIEF256R, ORB256 and RGB-D; and the
    staged route against the JAX package's make_chunk_frontend, bit for
    bit (JAX on the CPU takes its staged route too).
  * fused.chunk_step_split against the JAX package's make_chunk_step_split
    on tests/test_fused.py's setup (10 frames in chunks of 4, a tail chunk
    of 2), border 12 so that both packages take the staged route, with
    the constant-velocity guess and with a (C, 4, 4) odometry chunk:
    integer state exact (but one recovered landmark a frame with
    odometry), poses within 1e-4 (the pose solve sums in another order).
  * At chunks of one frame the split tracker is the unsplit tracker, bit
    for bit.
  * The split engine at chunks of 8 gives the same results from
    compute(), prestage() and a run with a checkpoint saved mid-chunk
    (a flush dispatches the partial chunk and the rest keeps its
    threshold), and at chunks of 1 the unsplit engine's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.ops import camera as jcam
from vslam_tpu.tracking import fused as jfused
from vslam_tpu.tracking.tracker import FusedPoseTracker as JTracker
from vslam_tpu_torch.eval import trajectory as ttraj
from vslam_tpu_torch.io import checkpoint
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.mapping import frame as tframe
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.system.engine import SlamEngine
from vslam_tpu_torch.tracking import fused as tfused
from vslam_tpu_torch.tracking import tracker as ttracker

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

POSE_ATOL = 1e-4
STEREO = dict(max_hamming_stereo=60, epipolar_tol=1.5, min_disparity=1.0,
              max_disparity=200.0)


@pytest.fixture(scope="module")
def small():
    """Three frames of a 128 x 256 circle (widths multiples of 16)."""
    cam = tcam.make_camera(fx=300, fy=300, cx=128, cy=64, baseline_m=0.4, rows=128,
                           cols=256, device="cpu")
    world = tsyn.make_world(cam, n_points=800, seed=3,
                            poses=tsyn.circle_trajectory(8, radius=5.0))
    frames = [tsyn.render_frame(world, t)[:2] for t in range(3)]
    chunk = torch.from_numpy(np.stack([np.stack(f) for f in frames]).astype(np.uint8))
    return cam, chunk.to(torch.float32)


ROUTES = {
    "k1": dict(descriptor="BRIEF256", octaves=1, border=20),
    "staged-2-octaves": dict(descriptor="BRIEF256", octaves=2, border=20),
    "brief256r": dict(descriptor="BRIEF256R", octaves=1, border=12),
    "orb256": dict(descriptor="ORB256", octaves=1, border=20),
    "rgbd": dict(descriptor="BRIEF256", octaves=2, border=20),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_chunk_front_end_equals_per_frame_front_ends(small, route):
    cam, chunk = small
    r = ROUTES[route]
    kw = dict(capacity=128, bin_size=16, detector="FAST",
              want_planes=r["descriptor"] != "ORB256", **r)
    thr = torch.tensor(15.0)
    if route == "rgbd":
        depth = torch.from_numpy(np.random.default_rng(0).uniform(
            0.5, 12.0, chunk.shape[:1] + chunk.shape[2:]).astype(np.float32))
        chunk = torch.stack([chunk[:, 0], depth], 1)
        got = tframe.frontend_chunk(cam, chunk, thr, mode="depth", min_depth=0.3,
                                    max_depth=10.0, **kw)
        want = [tframe.process_depth_frame(cam, f[0], f[1], thr, 0.3, 10.0, **kw)
                for f in chunk]
    else:
        got = tframe.frontend_chunk(cam, chunk, thr, **STEREO, **kw)
        want = [tframe.stereo_frontend_core(cam, f[0], f[1], thr, *STEREO.values(), **kw)
                for f in chunk]
    frames, n_kp, n_fp, planes = got
    for i, w in enumerate(want):
        for name, a, b in zip(tframe.FrameState._fields, w[0], frames):
            assert torch.equal(a, b[i]), (route, i, name)
        assert int(w[1]) == int(n_kp[i]) > 0 and int(w[2]) == int(n_fp[i])
        if kw["want_planes"]:
            assert torch.equal(w[3], planes[i])
    if not kw["want_planes"]:
        assert planes is None


def test_k1_batch_beyond_the_grid_is_refused():
    from vslam_tpu_torch.frontend import fast_brief as fb

    with pytest.raises(ValueError, match="65535"):
        fb.fast_brief_frontend_pair(torch.zeros((65536, 1, 1)), torch.tensor(10.0))


# tests/test_fused.py's setup for the chunk program.
CAM_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=160.0, baseline_m=0.4, rows=320, cols=640)
N_FRAMES = 10
C = 4


def _fused_config(cls):
    cfg = cls()
    cfg.framepoint_generation.capacity = 512
    cfg.framepoint_generation.bin_size_pixels = 12
    cfg.framepoint_generation.border_pixels = 12  # both packages: the staged route
    cfg.tracking.batch_frontend = True
    return cfg


@pytest.fixture(scope="module")
def fused_setup():
    from vslam_tpu.io import synthetic as jsyn

    jc = jcam.make_camera(**CAM_ARGS)
    world = jsyn.make_world(jc, n_frames=N_FRAMES, n_points=2200, seed=19, step=0.4)
    frames = [jsyn.render_frame(world, t)[:2] for t in range(N_FRAMES)]
    chunks = []
    for i in range(0, N_FRAMES, C):
        group = frames[i:i + C]
        buf = np.zeros((C, 2) + group[0][0].shape, np.uint8)
        for j, (left, right) in enumerate(group):
            buf[j] = np.stack([left, right]).astype(np.uint8)
        odom = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        for j in range(len(group)):  # T_cur_prev from the ground truth
            t = i + j
            prev = world.poses[max(t - 1, 0)]
            odom[j] = np.linalg.inv(world.poses[t]) @ prev
        chunks.append((buf, len(group), odom))
    return jc, tcam.make_camera(**CAM_ARGS, device="cpu"), chunks


def test_chunk_front_end_matches_jax_make_chunk_frontend(fused_setup):
    jc, tc, chunks = fused_setup
    jparams = JTracker(jc, _fused_config(JConfig), landmark_capacity=4096).params
    tparams = ttracker.params_from_config(tc, _fused_config(TConfig), torch.device("cpu"))
    buf = chunks[0][0]
    jf, jn_kp, jn_fp, jplanes = jfused.make_chunk_frontend(jparams)(
        jc, jnp.float32(20.0), jnp.asarray(buf))
    tf, tn_kp, tn_fp, tplanes = tfused.chunk_front_end(
        tc, tparams, torch.tensor(20.0), tfused._chunk_images(tc, tparams, torch.from_numpy(buf)))
    np.testing.assert_array_equal(tn_kp.numpy(), np.asarray(jn_kp))
    np.testing.assert_array_equal(tn_fp.numpy(), np.asarray(jn_fp))
    np.testing.assert_array_equal(tplanes.numpy(), np.asarray(jplanes).view(np.int32))
    for name in ("uv4", "valid", "track_len", "landmark_slot", "reliable"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tf.desc.numpy(), np.asarray(jf.desc).view(np.int32))
    np.testing.assert_allclose(tf.p_cam.numpy(), np.asarray(jf.p_cam), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("motion", ["constant-velocity", "odometry"])
def test_chunk_step_split_matches_jax(fused_setup, motion):
    """The odometry case feeds a (C, 4, 4) chunk of ground-truth motion
    guesses T_cur_prev (CAMERA_ODOMETRY)."""
    jc, tc, chunks = fused_setup
    use_odom = motion == "odometry"
    jparams = JTracker(jc, _fused_config(JConfig), landmark_capacity=16384).params
    jstep = jfused.make_chunk_step_split(jparams)
    js = jfused.init_state(jc, jparams, 16384, 20.0)
    for buf, k, odom in chunks:
        js = jstep(jc, js, jnp.asarray(buf), jnp.int32(k), jnp.asarray(True),
                   jnp.asarray(odom) if use_odom else jnp.tile(jnp.eye(4), (C, 1, 1)),
                   jnp.asarray(use_odom))
    tparams = ttracker.params_from_config(tc, _fused_config(TConfig), torch.device("cpu"))
    ts = tfused.init_state(tc, tparams, 16384, 20.0)
    for buf, k, odom in chunks:
        ts = tfused.chunk_step_split(tc, tparams, ts, torch.from_numpy(buf), k, True,
                                     torch.from_numpy(odom) if use_odom else None)

    assert int(ts.frame_idx) == N_FRAMES and int(ts.kf_count) >= 1
    for name in ("next_slot", "free_count", "kf_count", "frame_idx", "kf_n", "kf_slots",
                 "threshold"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    ring_t, ring_j = ts.ring.numpy(), np.asarray(js.ring)
    counts = [tfused._R_NKP, tfused._R_NFP, tfused._R_NMATCH, tfused._R_NINL, tfused._R_OK,
              tfused._R_NSPAWN, tfused._R_FIDX, tfused._R_KFCOUNT, tfused._R_STATUS]
    np.testing.assert_array_equal(ring_t[:, counts], ring_j[:, counts])
    # Recovery gates (field of view, disparity) on projections of the
    # solved pose, which the two packages sum in another order (2e-6 m
    # apart here): with the odometry guesses one landmark a frame can fall
    # on either side (measured: frames 8 and 9 by one), without odometry
    # none does.
    rec = np.abs(ring_t[:, tfused._R_NRECOVER] - ring_j[:, tfused._R_NRECOVER])
    assert rec.max() <= (1 if use_odom else 0), rec
    np.testing.assert_allclose(ring_t[:, :16], ring_j[:, :16], atol=POSE_ATOL)
    np.testing.assert_allclose(ts.T_world_cam.numpy(), np.asarray(js.T_world_cam),
                               atol=POSE_ATOL)


# The engine runs: tests/test_torch_closed_loop.py's 48-frame circle at
# 192 x 512, closed loop, on K1's plain version (border 20).
E_CAM = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4, rows=192, cols=512)
E_FRAMES = 48
MID_CHUNK = 20  # a checkpoint between two drains, inside the chunk 16..23


def _engine_config(split: bool):
    cfg = TConfig()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.8
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.relocalization.preliminary_minimum_interspace_queries = 6
    cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
    cfg.relocalization.icp_minimum_number_of_inliers = 8
    cfg.relocalization.icp_minimum_inlier_ratio = 0.3
    cfg.tracking.batch_frontend = split
    return cfg


@pytest.fixture(scope="module")
def engine_world():
    cam = tcam.make_camera(**E_CAM, device="cpu")
    world = tsyn.make_world(cam, n_points=1500, seed=21,
                            poses=tsyn.circle_trajectory(E_FRAMES, radius=7.0))
    return cam, world, [tsyn.render_frame(world, t)[:2] for t in range(E_FRAMES)]


def _run(engine_world, split, harvest, how, tmp_path=None):
    cam, world, frames = engine_world
    eng = SlamEngine(cam, _engine_config(split), landmark_capacity=8192, device="cpu")
    eng.tracker.harvest_every = harvest
    if how == "prestage":
        for h in eng.tracker.prestage(frames):
            eng.process_prestaged(h)
    else:
        for t, f in enumerate(frames):
            if how == "checkpoint" and t == MID_CHUNK:
                assert len(eng.tracker._buf) == MID_CHUNK % harvest  # mid-chunk
                checkpoint.save_checkpoint(eng, str(tmp_path / "mid_chunk.npz"))
                assert not eng.tracker._buf and eng.tracker._dispatched == MID_CHUNK
            eng.process(*f)
    traj = eng.trajectory
    return dict(traj=traj, rep=eng.report(), ate=float(ttraj.ate_rmse(traj, world.poses)[0]),
                closures=[(c.query_id, c.reference_id) for c in eng.world_map.closures])


@pytest.fixture(scope="module")
def split_runs(engine_world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("split")
    return {how: _run(engine_world, True, 8, how, tmp)
            for how in ("compute", "prestage", "checkpoint")}


EVENTS = ("n_local_maps", "n_closures", "n_optimizations", "n_track_breaks")


@pytest.mark.parametrize("how", ["prestage", "checkpoint"])
def test_split_engine_entry_points_agree(split_runs, how):
    ref, got = split_runs["compute"], split_runs[how]
    assert ref["rep"]["n_local_maps"] >= 10 and ref["rep"]["n_track_breaks"] == 0
    assert ref["rep"]["n_closures"] >= 1 and ref["ate"] <= 0.10, ref["ate"]
    for k in EVENTS:
        assert got["rep"][k] == ref["rep"][k], k
    assert got["closures"] == ref["closures"]
    assert abs(got["ate"] - ref["ate"]) <= 1e-4, (got["ate"], ref["ate"])
    np.testing.assert_allclose(got["traj"], ref["traj"], atol=1e-4)


@pytest.mark.parametrize("motion", ["CONSTANT_VELOCITY", "CAMERA_ODOMETRY"])
def test_split_tracker_of_one_frame_chunks_is_the_unsplit_tracker(engine_world, motion):
    """Chunks of one frame: the batched front-end runs at the threshold the
    per-frame step would use, so every ring row and pose is the same (with
    CAMERA_ODOMETRY, ground-truth motion guesses given to compute())."""
    cam, world, frames = engine_world
    trackers = []
    for split in (False, True):
        cfg = _engine_config(split)
        cfg.command_line.option_disable_relocalization = True
        cfg.tracking.motion_model = motion
        tr = ttracker.FusedPoseTracker(cam, cfg, landmark_capacity=8192, device="cpu")
        for t, f in enumerate(frames[:12]):
            odo = np.linalg.inv(world.poses[t]) @ world.poses[max(t - 1, 0)]
            tr.compute(*f, odometry=odo if motion == "CAMERA_ODOMETRY" else None)
        tr.flush()
        trackers.append(tr)
    a, b = trackers
    assert b.split and not a.split
    assert torch.equal(a.state.ring, b.state.ring)
    assert torch.equal(a.state.T_world_cam, b.state.T_world_cam)
    np.testing.assert_array_equal(np.stack(a.trajectory), np.stack(b.trajectory))


def test_split_engine_at_the_cpu_cadence_is_the_unsplit_engine(engine_world, split_runs):
    """harvest_every 1 (the CPU default): chunks of one frame, the unsplit
    engine's results exactly; and the drain cadence of 8 keeps its events."""
    unsplit = _run(engine_world, False, 1, "compute")
    split = _run(engine_world, True, 1, "compute")
    for k in EVENTS:
        assert split["rep"][k] == unsplit["rep"][k], k
    assert split["closures"] == unsplit["closures"]
    np.testing.assert_array_equal(split["traj"], unsplit["traj"])
    assert split_runs["compute"]["rep"]["n_local_maps"] == unsplit["rep"]["n_local_maps"]


def test_cli_runs_the_split_front_end_and_fast_icp(tmp_path):
    """`python -m vslam_tpu_torch run -c <yaml>` reaches tracking.batch_frontend
    and relocalization.aligner_type FAST-ICP (closed loop): the JAX CLI's
    positions within 1e-4 m on a 10-frame KITTI directory (border 12, both
    packages on the staged route)."""
    from vslam_tpu.system import cli as jcli
    from vslam_tpu_torch.io import image
    from vslam_tpu_torch.system import cli as tcli

    cam = tcam.make_camera(**E_CAM, device="cpu")
    world = tsyn.make_world(cam, n_frames=10, n_points=1500, seed=40, step=0.3)
    root = tmp_path / "seq"
    for d in ("image_0", "image_1"):
        (root / d).mkdir(parents=True)
    for t in range(10):
        for d, img in zip(("image_0", "image_1"), tsyn.render_frame(world, t)[:2]):
            image.write_png(str(root / d / f"{t:06d}.png"), np.clip(img, 0, 255).astype(np.uint8))
    np.savetxt(root / "times.txt", np.arange(10) * 0.1)
    (root / "calib.txt").write_text("P0: 300 0 256 0 0 300 96 0 0 0 1 0\n"
                                    "P1: 300 0 256 -120 0 300 96 0 0 0 1 0\n")
    (root / "config.yaml").write_text(
        "framepoint_generation:\n  capacity: 256\n  bin_size_pixels: 16\n  border_pixels: 12\n"
        "tracking:\n  batch_frontend: true\n"
        "relocalization:\n  aligner_type: FAST-ICP\n"
        "parallelism:\n  shard_descriptor_db: false\n  shard_landmarks: false\n")
    est = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out = tmp_path / name
        out.mkdir()
        main(["run", "--dataset", str(root), "--format", "kitti", "-c",
              str(root / "config.yaml"), "--output-kitti", str(out / "est.txt"),
              "--timing-output", str(out / "timing.json"), *extra])
        est[name] = ttraj.read_kitti(str(out / "est.txt"))
    assert est["port"].shape == (10, 4, 4)
    assert np.abs(est["port"][:, :3, 3] - est["jax"][:, :3, 3]).max() <= 1e-4
