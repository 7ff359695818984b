"""The modular tracker's per-frame programs (tracking/modular.py: the
JAX package's jitted process_stereo_pair / process_depth_frame,
track_and_align(_uvd), propagate_tracks + promote_temporary_points,
spawn_landmarks + update_observed) on the CPU, where each program runs
eagerly on the same buffers the card captures.

  * each program's outputs and the state it writes equal the plain
    functions' bit for bit: stereo on the K1 route (border 20) and the
    staged route (border 12), RGB-D with and without a depth
    calibration, a track attempt stereo and UVD, propagate + promote,
    spawn + update and the update alone;
  * each matches JAX's jitted counterpart: integers exact, points rtol
    1e-6 (the front-end), poses 1e-4 and the landmark table 1e-5
    (tests/test_torch_modular.py's tolerances); a track attempt's match
    count exact and its inliers within 2 (tests/test_torch_frame.py's:
    the chi2 gate can flip a borderline point);
  * the PoseTracker on the programs over 20 stereo and 16 RGB-D frames
    equals the JAX PoseTracker in every per-frame count (keypoints,
    framepoints, tracked points, inliers, threshold, status, breaks,
    allocated) and its positions within 1e-4 m; the program
    cache keeps its size from frame 2 on and every program runs as often
    as the ladder says;
  * two trackers taking turns on the shared programs equal each one run
    alone, bit for bit;
  * a `tracker.table = ...` assignment (BA write-back, checkpoint load)
    and a `prev_frame` assignment (merging) land in the programs' buffers
    and are seen by the next step.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.frontend import brief as jbrief
from vslam_tpu.frontend import depth as jdepth
from vslam_tpu.frontend import pallas_frontend as jpf
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.mapping import frame as jframe
from vslam_tpu.mapping import landmarks as jlm
from vslam_tpu.ops import camera as jcam
from vslam_tpu.solve import gn as jgn
from vslam_tpu.tracking.tracker import PoseTracker as JTracker
from vslam_tpu_torch.frontend import depth as tdepth
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.mapping import frame as tframe
from vslam_tpu_torch.mapping import landmarks as tlm
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.ops import lie as tlie
from vslam_tpu_torch.solve import gn as tgn
from vslam_tpu_torch.tracking import modular
from vslam_tpu_torch.tracking.tracker import PoseTracker as TTracker

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

STEREO_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=160.0, baseline_m=0.4, rows=320, cols=640)
K1_ARGS = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4, rows=192, cols=512)
RGBD_ARGS = dict(fx=300.0, fy=300.0, cx=160.0, cy=96.0, baseline_m=0.075, rows=192, cols=320)
GATES = (50, 1.0, 1.0, 200.0)  # max Hamming, epipolar tol, min / max disparity
DEPTH_RANGE = (0.3, 30.0)
GN = tgn.GNConfig(max_iterations=100)
JGN = jgn.GNConfig(max_iterations=100)
N_FRAMES = 20
RGBD_FRAMES = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _j(t: torch.Tensor, words=False):
    """A JAX copy of a CPU tensor (descriptor words as uint32): a copy,
    since a JAX CPU array may alias the numpy memory it was made from,
    which the programs write in place."""
    a = t.numpy().copy()
    return jnp.asarray(a.view(np.uint32) if words else a)


def _programs(args, mode, capacity, bin_size, border, gates, depth_calib=None, octaves=1):
    """Unshared programs (their own buffers) with the gates set."""
    cam = tcam.make_camera(**args, device="cpu")
    progs = modular.ModularPrograms(
        cam, mode, modular.FrontEndSettings(capacity, bin_size, border, "BRIEF256", "FAST",
                                            octaves), GN, 4096, depth_calib)
    for buf, v in zip(progs.gates, gates):
        buf.fill_(v)
    return cam, progs


def _assert_frames_equal(got, want):
    for name in tframe.FrameState._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _assert_frame_matches_jax(got, jf):
    for name in ("uv4", "valid", "track_len", "landmark_slot", "reliable"):
        np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(jf, name)),
                                      name)
    np.testing.assert_array_equal(got.desc.numpy(), np.asarray(jf.desc).view(np.int32))
    np.testing.assert_allclose(got.p_cam.numpy(), np.asarray(jf.p_cam), rtol=1e-6)


@pytest.fixture(scope="module")
def stereo_world():
    world = jsyn.make_world(jcam.make_camera(**STEREO_ARGS), n_frames=N_FRAMES,
                            n_points=3000, seed=9, step=0.4, turn_rate=0.003)
    return world, [tuple(np.asarray(a, np.float32) for a in jsyn.render_frame(world, t)[:2])
                   for t in range(N_FRAMES)]


@pytest.fixture(scope="module")
def rgbd_world():
    world = tsyn.make_world(tcam.make_camera(**RGBD_ARGS, device="cpu"), n_frames=RGBD_FRAMES,
                            n_points=2500, seed=7, step=0.3)
    return world, [tuple(np.asarray(a, np.float32) for a in tsyn.render_depth_frame(world, t))
                   for t in range(RGBD_FRAMES)]


# ---------------------------------------------------------------------------
# The front-end program
# ---------------------------------------------------------------------------


def test_front_end_program_staged_route(stereo_world):
    _, frames = stereo_world
    left, right = frames[5]
    cam, progs = _programs(STEREO_ARGS, "stereo", 512, 12, 12, GATES)
    counts = progs.front.run((left, right, np.float32(25.0)))
    tf, tnk, tnf = tframe.process_stereo_pair(cam, _t(left), _t(right), torch.tensor(25.0),
                                              *GATES, capacity=512, bin_size=12, border=12)
    _assert_frames_equal(progs.cur, tf)
    assert counts.tolist() == [int(tnk), int(tnf)] and int(tnf) > 100
    jf, jnk, jnf = jframe.process_stereo_pair(
        jcam.make_camera(**STEREO_ARGS), jnp.asarray(left), jnp.asarray(right),
        jnp.float32(25.0), jnp.int32(GATES[0]), *map(jnp.float32, GATES[1:]),
        capacity=512, bin_size=12, border=12)
    assert counts.tolist() == [int(jnk), int(jnf)]
    _assert_frame_matches_jax(progs.cur, jf)


def test_front_end_program_k1_route(monkeypatch):
    """Border 20, bin 16, one octave: the K1 route (its plain version on
    the CPU); JAX forced onto its K1 branch in interpret mode, under a
    fresh jit, as tests/test_torch_frame.py does."""
    jc = jcam.make_camera(**K1_ARGS)
    world = jsyn.make_world(jc, n_frames=16, n_points=1500, seed=42, step=0.45)
    left, right = (np.asarray(a, np.uint8).astype(np.float32)
                   for a in jsyn.render_frame(world, 4)[:2])
    cam, progs = _programs(K1_ARGS, "stereo", 256, 16, 20, GATES)
    counts = progs.front.run((left, right, np.float32(20.0)))
    tf, tnk, tnf = tframe.process_stereo_pair(cam, _t(left), _t(right), torch.tensor(20.0),
                                              *GATES, capacity=256, bin_size=16, border=20)
    _assert_frames_equal(progs.cur, tf)
    assert counts.tolist() == [int(tnk), int(tnf)] and int(tnf) > 50

    monkeypatch.setattr(jbrief, "_use_pallas", lambda: True)
    monkeypatch.setattr(jpf, "fast_brief_frontend_pair",
                        partial(jpf.fast_brief_frontend_pair, interpret=True))
    run = jax.jit(jframe.process_stereo_pair.__wrapped__,
                  static_argnames=("capacity", "bin_size", "border"))
    jf, jnk, jnf = run(jc, jnp.asarray(left), jnp.asarray(right), jnp.float32(20.0),
                       jnp.int32(GATES[0]), *map(jnp.float32, GATES[1:]), capacity=256,
                       bin_size=16, border=20)
    assert counts.tolist() == [int(jnk), int(jnf)]
    _assert_frame_matches_jax(progs.cur, jf)


def _calibration():
    K = np.array([[290.0, 0, 158.0], [0, 291.0, 97.0], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.025, -0.004, 0.001]
    return K, T


@pytest.mark.parametrize("calibrated", [False, True])
def test_front_end_program_depth(rgbd_world, calibrated):
    _, frames = rgbd_world
    img, depth = frames[3]
    K, T = _calibration()
    calib = (torch.linalg.inv(_t(K)), _t(T)) if calibrated else None
    cam, progs = _programs(RGBD_ARGS, "depth", 256, 10, 12, DEPTH_RANGE, calib)
    counts = progs.front.run((img, depth, np.float32(20.0)))
    dm = _t(depth) if calib is None else tdepth.register_depth(cam, _t(depth), *calib)
    tf, tnk, tnf = tframe.process_depth_frame(cam, _t(img), dm, torch.tensor(20.0),
                                              *DEPTH_RANGE, capacity=256, bin_size=10,
                                              border=12)
    _assert_frames_equal(progs.cur, tf)
    assert counts.tolist() == [int(tnk), int(tnf)] and int(tnf) > 50
    jc = jcam.make_camera(**RGBD_ARGS)
    jd = jnp.asarray(depth)
    if calibrated:
        jd = jdepth.register_depth(jc, jd, jnp.asarray(K), jnp.asarray(T))
    jf, jnk, jnf = jframe.process_depth_frame(
        jc, jnp.asarray(img), jd, jnp.float32(20.0), *map(jnp.float32, DEPTH_RANGE),
        capacity=256, bin_size=10, border=12)
    assert counts.tolist() == [int(jnk), int(jnf)]
    _assert_frame_matches_jax(progs.cur, jf)


# ---------------------------------------------------------------------------
# The track, propagate and landmark programs
# ---------------------------------------------------------------------------


def _two_frames(args, mode, frames, capacity, bin_size, gates, i=4):
    """Programs holding frame i-1 as prev (its landmarks spawned) and
    frame i as cur; the JAX frames and table of the same state."""
    cam, progs = _programs(args, mode, capacity, bin_size, 12, gates)
    T_wc = np.eye(4, dtype=np.float32)
    progs.front.run((*frames[i - 1], np.float32(20.0)))
    rows = np.flatnonzero(modular.spawn_mask(progs.cur, 1).numpy())
    assigned = np.full(capacity, -1, np.int32)
    assigned[rows] = np.arange(len(rows))
    progs.spawn.run((assigned, T_wc, np.int32(i - 1), np.int32(0)))
    progs.front.run((*frames[i], np.float32(20.0)))
    jt = jlm.LandmarkTable(*(_j(t, k == "desc") for k, t in progs.table._asdict().items()))
    jprev, jcur = (jframe.FrameState(*(_j(t, k == "desc") for k, t in f._asdict().items()))
                   for f in (progs.prev, progs.cur))
    return cam, progs, jt, jprev, jcur


def _snapshot(progs):
    return [t.clone() for t in (*progs.table, *progs.prev, *progs.cur, progs.T_cur_prev,
                                progs.prev_to_cur)]


def _state(progs):
    return [*progs.table, *progs.prev, *progs.cur, progs.T_cur_prev, progs.prev_to_cur]


@pytest.mark.parametrize("mode", ["stereo", "depth"])
def test_track_program_matches_plain_and_jax(stereo_world, rgbd_world, mode):
    if mode == "stereo":
        args, (_, frames), gates, cap, bin_size = STEREO_ARGS, stereo_world, GATES, 512, 12
        jfn, tfn = jframe.track_and_align, tframe.track_and_align
    else:
        args, (_, frames), gates, cap, bin_size = RGBD_ARGS, rgbd_world, DEPTH_RANGE, 256, 10
        jfn, tfn = jframe.track_and_align_uvd, tframe.track_and_align_uvd
    cam, progs, jt, jprev, jcur = _two_frames(args, mode, frames, cap, bin_size, gates)
    guess = np.eye(4, dtype=np.float32)
    guess[2, 3] = -0.2
    before = _snapshot(progs)
    v = progs.track.run((guess, np.float32(12.0), np.int32(60))).numpy()

    w = tlm.landmark_weights(progs.table, progs.prev.landmark_slot)
    res = tfn(cam, progs.prev, progs.cur, _t(guess), torch.tensor(12.0),
              torch.tensor(60, dtype=torch.int32), w, GN)
    assert torch.equal(progs.T_cur_prev, res.T_cur_prev)
    assert torch.equal(progs.prev_to_cur, res.prev_to_cur)
    assert v.tolist() == [float(res.converged), float(res.n_inliers), float(res.n_matches),
                          float(progs.prev.valid.sum()), *res.T_cur_prev.reshape(16).tolist()]
    for a, b in zip(_state(progs)[:-2], before[:-2]):  # the frames and table stay
        assert torch.equal(a, b)
    assert bool(res.converged) and int(res.n_inliers) > 50

    jres = jfn(jcam.make_camera(**args), jprev, jcur, jnp.asarray(guess), jnp.float32(12.0),
               jnp.int32(60), jlm.landmark_weights(jt, jprev.landmark_slot), JGN)
    assert int(jres.n_matches) == int(v[modular.VERDICT_MATCHES])
    assert bool(jres.converged) == bool(v[modular.VERDICT_CONVERGED])
    assert abs(int(jres.n_inliers) - int(v[modular.VERDICT_INLIERS])) <= 2
    np.testing.assert_allclose(v[modular.VERDICT_T:].reshape(4, 4),
                               np.asarray(jres.T_cur_prev), atol=1e-4)


def test_propagate_program_matches_plain_and_jax(stereo_world):
    _, frames = stereo_world
    cam, progs, jt, jprev, jcur = _two_frames(STEREO_ARGS, "stereo", frames, 512, 12, GATES)
    progs.track.run((np.eye(4, dtype=np.float32), np.float32(12.0), np.int32(60)))
    prev, cur = tframe.FrameState(*(t.clone() for t in progs.prev)), \
        tframe.FrameState(*(t.clone() for t in progs.cur))
    T, p2c = progs.T_cur_prev.clone(), progs.prev_to_cur.clone()
    progs.propagate.run()
    want = tframe.propagate_tracks(prev, cur, p2c)
    want, n = tframe.promote_temporary_points(cam, prev, want, T, p2c)
    _assert_frames_equal(progs.cur, want)
    _assert_frames_equal(progs.prev, prev)
    assert int((progs.cur.track_len > 1).sum()) > 100

    jnew = jframe.propagate_tracks(jprev, jcur, _j(p2c))
    jnew, jn = jframe.promote_temporary_points(jcam.make_camera(**STEREO_ARGS), jprev, jnew,
                                               _j(T), _j(p2c))
    assert int(jn) == int(n)
    _assert_frame_matches_jax(progs.cur, jnew)


def _assert_table_matches_jax(tt, jt):
    for k in tlm.LandmarkTable._fields:
        got, ref = getattr(tt, k).numpy(), np.asarray(getattr(jt, k))
        if k == "desc":
            ref = ref.view(np.int32)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)


@pytest.mark.parametrize("mode", ["stereo", "depth"])
@pytest.mark.parametrize("spawn", [True, False])
def test_landmark_programs_match_plain_and_jax(stereo_world, rgbd_world, mode, spawn):
    if mode == "stereo":
        args, (_, frames), gates, cap, bin_size = STEREO_ARGS, stereo_world, GATES, 512, 12
    else:
        args, (_, frames), gates, cap, bin_size = RGBD_ARGS, rgbd_world, DEPTH_RANGE, 256, 10
    cam, progs, jt, _, jcur = _two_frames(args, mode, frames, cap, bin_size, gates)
    # Every other valid point of the current frame observes one of the
    # table's landmarks (distinct slots); the spawn gives the other
    # reliable ones fresh slots.
    n_lm = int(progs.table.valid.sum())
    obs = np.flatnonzero(progs.cur.valid.numpy())[::2][:n_lm]
    slots = np.full(cap, -1, np.int32)
    slots[obs] = np.arange(len(obs))
    modular.assign(progs.cur, progs.cur._replace(landmark_slot=_t(slots)))
    rows = np.flatnonzero(modular.spawn_mask(progs.cur, 1).numpy())
    assigned = np.full(cap, -1, np.int32)
    assigned[rows] = 1000 + np.arange(len(rows))
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [0.05, -0.02, 0.4]
    table = tlm.LandmarkTable(*(t.clone() for t in progs.table))
    cur = tframe.FrameState(*(t.clone() for t in progs.cur))
    jt = jlm.LandmarkTable(*(_j(t, k == "desc") for k, t in table._asdict().items()))
    jslots = _j(cur.landmark_slot)
    if spawn:
        progs.spawn.run((assigned, T_wc, np.int32(7), np.int32(3)))
        a = _t(assigned)
        table = tlm.spawn_landmarks(table, a, tlie.transform_point_cloud(_t(T_wc), cur.p_cam),
                                    cur.desc, torch.tensor(7, dtype=torch.int32),
                                    origin_kf=torch.tensor(3, dtype=torch.int32))
        cur = cur._replace(landmark_slot=torch.where(a >= 0, a, cur.landmark_slot))
        jt = jlm.spawn_landmarks(jt, jnp.asarray(assigned),
                                 jnp.asarray(cur.p_cam.numpy() @ T_wc[:3, :3].T + T_wc[:3, 3]),
                                 _j(cur.desc, True), jnp.int32(7),
                                 origin_kf=jnp.int32(3))
        jslots = _j(cur.landmark_slot)
    else:
        progs.update.run((T_wc, np.int32(7)))
    table = tlm.update_observed(cam, table, _t(T_wc), cur.landmark_slot, cur.uv4, cur.desc,
                                cur.valid, torch.tensor(7, dtype=torch.int32), mode=mode)
    for name in tlm.LandmarkTable._fields:
        assert torch.equal(getattr(progs.table, name), getattr(table, name)), name
    _assert_frames_equal(progs.prev, cur)  # the current frame is the next one's prev
    assert int((progs.table.n_updates > 1).sum()) > 20
    jt = jlm.update_observed(jcam.make_camera(**args), jt, jnp.asarray(T_wc), jslots,
                             _j(cur.uv4),
                             _j(cur.desc, True),
                             _j(cur.valid), jnp.int32(7), mode=mode)
    _assert_table_matches_jax(progs.table, jt)


# ---------------------------------------------------------------------------
# The tracker on the programs
# ---------------------------------------------------------------------------


def _cfg(cls, mode):
    cfg = cls()
    fp = cfg.framepoint_generation
    if mode == "stereo":
        fp.capacity, fp.bin_size_pixels, fp.border_pixels = 512, 12, 12
        fp.detector_threshold_starting_value = 25.0
    else:
        cfg.command_line.tracker_mode = "RGB_DEPTH"
        fp.capacity, fp.bin_size_pixels, fp.maximum_depth_meters = 256, 10, 30.0
    return cfg


def _run(tracker, frames, after=None):
    rows, prev = [], None
    for i, f in enumerate(frames):
        tracker.compute(*f)
        s = tracker.stats
        now = (s.n_keypoints, s.n_framepoints, s.n_tracked_points, s.n_inliers)
        rows.append(tuple(a - b for a, b in zip(now, prev or (0,) * 4))
                    + (tracker.controller.threshold, tracker.status, s.n_breaks,
                       tracker.allocator.num_allocated))
        prev = now
        if after is not None:
            after(i)
    return rows, np.stack(tracker.trajectory)


@pytest.mark.parametrize("mode", ["stereo", "depth"])
def test_tracker_on_programs_matches_jax(stereo_world, rgbd_world, mode):
    args, (world, frames) = ((STEREO_ARGS, stereo_world) if mode == "stereo"
                             else (RGBD_ARGS, rgbd_world))
    cap = 16384 if mode == "stereo" else 8192
    jt = JTracker(jcam.make_camera(**args), _cfg(JConfig, mode), landmark_capacity=cap)
    modular.clear_programs()
    tt = TTracker(tcam.make_camera(**args, device="cpu"), _cfg(TConfig, mode),
                  landmark_capacity=cap, device="cpu")
    sizes, uses = [], []
    progs = tt.programs

    def note(i):
        sizes.append(len(modular._PROGRAMS))
        uses.append({k: p.uses for k, p in progs.programs.items()})

    trows, ttraj = _run(tt, frames, note)
    jrows, jtraj = _run(jt, frames)
    assert trows == jrows
    assert np.abs(ttraj[:, :3, 3] - jtraj[:, :3, 3]).max() <= 1e-4
    assert trows[-1][5] == "Tracking" and trows[-1][6] == 0
    assert tt.stats.n_spawned == tt.allocator.num_allocated == trows[-1][7]
    # One program set for the run, no key per frame or per scalar; one
    # front-end and one landmark program a frame, an attempt a track run.
    assert set(sizes) == {1}
    n = len(frames)
    assert uses[-1]["front-end"] == n
    assert uses[-1]["spawn"] + uses[-1]["update"] == n
    assert uses[-1]["propagate"] == n - 1 - trows[-1][6]
    assert n - 1 <= uses[-1]["track"] <= 3 * (n - 1)


def test_trackers_taking_turns_equal_each_alone(stereo_world):
    """Two trackers of one key on the shared programs, stepped in turns
    (the second on the frames in reverse), against each one run alone:
    trajectories, counts and tables bit for bit."""
    _, frames = stereo_world
    seqs = (frames[:8], frames[::-1][:8])
    alone = []
    for seq in seqs:
        modular.clear_programs()
        t = TTracker(tcam.make_camera(**STEREO_ARGS, device="cpu"), _cfg(TConfig, "stereo"),
                     landmark_capacity=4096, device="cpu")
        alone.append((_run(t, seq), [x.clone() for x in t.table]))
    modular.clear_programs()
    a, b = (TTracker(tcam.make_camera(**STEREO_ARGS, device="cpu"), _cfg(TConfig, "stereo"),
                     landmark_capacity=4096, device="cpu") for _ in range(2))
    assert a.programs is b.programs
    for fa, fb in zip(*seqs):
        a.compute(*fa)
        b.compute(*fb)
    for t, ((rows, traj), table) in zip((a, b), alone):
        np.testing.assert_array_equal(np.stack(t.trajectory), traj)
        assert t.allocator.num_allocated == rows[-1][-1]
        for x, y in zip(t.table, table):
            assert torch.equal(x, y)


def test_table_and_prev_frame_assignments_reach_the_programs(stereo_world):
    """A table assigned between frames (the BA write-back's and the
    checkpoint load's `tracker.table = ...`) lands in the programs'
    buffers in place, and the next step refines from it: here every
    landmark marked invalid, so the next frame updates none of them."""
    _, frames = stereo_world
    modular.clear_programs()
    t = TTracker(tcam.make_camera(**STEREO_ARGS, device="cpu"), _cfg(TConfig, "stereo"),
                 landmark_capacity=4096, device="cpu")
    for f in frames[:4]:
        t.compute(*f)
    bufs = [x.data_ptr() for x in t.programs.table]
    table = t.table
    n_up = torch.where(table.valid, 100, table.n_updates)
    t.table = table._replace(valid=torch.zeros_like(table.valid), n_updates=n_up)
    assert [x.data_ptr() for x in t.programs.table] == bufs
    assert torch.equal(t.programs.table.n_updates, n_up)
    slots = t.prev_frame.landmark_slot.clone()
    t.prev_frame = t.prev_frame._replace(landmark_slot=torch.full_like(slots, -1))
    assert (t.programs.prev.landmark_slot == -1).all()
    t.prev_frame = t.prev_frame._replace(landmark_slot=slots)
    t.compute(*frames[4])
    old = n_up == 100
    assert old.sum() > 100
    assert torch.equal(t.table.n_updates[old], n_up[old])  # none refined
    assert not t.table.valid[old].any()
    t.prev_frame = None  # a checkpoint load: the next frame re-seeds
    assert t.prev_frame is None
    t.compute(*frames[5])
    assert t.status == "Localizing" and t.prev_frame is not None
