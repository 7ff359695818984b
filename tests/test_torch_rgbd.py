"""Port parity: the RGB-D path (frontend/depth.py, the depth front-end,
the UVD pose solve and landmark refinement, depth recovery, and the
RGB-D FusedPoseTracker) against vslam_tpu on the CPU.

The scene is rendered with render_depth_frame at 192 x 320 (a width
that is a multiple of 16: the blur's FMA chain is exact there, see
ROADMAP "facts"); its intensity image stays f32, as the RGB-D tracker
uploads it.

Tolerances:
  * gather_depth, register_depth: exact;
  * bilateral filter: rtol 1e-5 (XLA's and torch's exp differ by ulps);
  * process_depth_frame: keypoints, descriptors, validity, uv4 and the
    counts exact, p_cam within rtol 1e-6;
  * uvd_align: pose within 1e-5, iteration count and inlier mask exact;
  * update_landmarks_uvd: positions within 1e-4 m (measured 1.6e-5: a
    closed-form 3x3 solve for JAX's), information within rtol 1e-5,
    chi2 rtol 1e-5, inlier flags exact;
  * recover_lost_landmarks_depth: the frame as process_depth_frame's,
    the recovered count exact;
  * ORB256 (front-end and recovery): as above, but the differing
    descriptor bits are counted and at most 0.1% (measured 0);
  * 16-frame tracker runs: every event count equal, every position
    within 1e-4 m (measured: 2e-6 m).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.frontend import brief as jbrief
from vslam_tpu.frontend import depth as jdepth
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.io.config import load_config as jload
from vslam_tpu.mapping import frame as jframe
from vslam_tpu.ops import camera as jcam
from vslam_tpu.ops import lie as jlie
from vslam_tpu.solve import aligners as jal
from vslam_tpu.solve import gn as jgn
from vslam_tpu.tracking.tracker import FusedPoseTracker as JTracker
from vslam_tpu_torch.frontend import depth as tdepth
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.io.config import load_config as tload
from vslam_tpu_torch.mapping import frame as tframe
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.solve import aligners as tal
from vslam_tpu_torch.solve import gn as tgn
from vslam_tpu_torch.tracking.tracker import FusedPoseTracker as TTracker

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAM_ARGS = dict(fx=300.0, fy=300.0, cx=160.0, cy=96.0, baseline_m=0.075, rows=192, cols=320)
CAPACITY = 256
N_FRAMES = 16
EVENTS = ("n_frames", "n_breaks", "n_recovered", "n_spawned", "n_keypoints",
          "n_framepoints", "n_tracked_points", "n_inliers")


@pytest.fixture(scope="module")
def scene():
    jc = jcam.make_camera(**CAM_ARGS)
    tc = tcam.make_camera(**CAM_ARGS, device="cpu")
    world = tsyn.make_world(tc, n_frames=N_FRAMES, n_points=2500, seed=7, step=0.3)
    frames = [tsyn.render_depth_frame(world, t) for t in range(N_FRAMES)]
    return jc, tc, world, frames


def test_render_depth_frame_matches_jax(scene):
    jc, _, world, frames = scene
    jworld = jsyn.make_world(jc, n_frames=N_FRAMES, n_points=2500, seed=7, step=0.3)
    for t in (0, 9):
        img, depth = jsyn.render_depth_frame(jworld, t)
        np.testing.assert_array_equal(frames[t][0], img)
        np.testing.assert_array_equal(frames[t][1], depth)
    assert (frames[0][1] > 0).mean() > 0.2


def test_gather_depth_is_exact(scene):
    _, _, _, frames = scene
    depth = frames[3][1]
    rng = np.random.default_rng(0)
    uv = np.c_[rng.uniform(-5, 330, 400), rng.uniform(-5, 200, 400)].astype(np.float32)
    uv[:40] = np.round(uv[:40]) + 0.5  # half-pixel ties round to even
    ref = np.asarray(jdepth.gather_depth(jnp.asarray(depth), jnp.asarray(uv)))
    got = tdepth.gather_depth(torch.from_numpy(depth), torch.from_numpy(uv)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_register_depth_is_exact(scene):
    jc, tc, _, frames = scene
    depth = frames[5][1]
    T = np.asarray(jlie.exp_se3(jnp.asarray([-0.06, 0.01, 0.0, 0.0, 0.02, 0.01],
                                            jnp.float32)))
    K_d = np.array([[290.0, 0.0, 158.0], [0.0, 292.0, 95.0], [0.0, 0.0, 1.0]], np.float32)
    ref = np.asarray(jdepth.register_depth(jc, jnp.asarray(depth), jnp.asarray(K_d),
                                           jnp.asarray(T)))
    got = tdepth.register_depth(tc, torch.from_numpy(depth),
                                torch.linalg.inv(torch.from_numpy(K_d)),
                                torch.from_numpy(T)).numpy()
    assert (ref > 0).sum() > 1000
    np.testing.assert_array_equal(got, ref)


def test_bilateral_filter_matches_jax(scene):
    _, _, _, frames = scene
    rng = np.random.default_rng(1)
    depth = frames[2][1] + np.where(frames[2][1] > 0, rng.normal(0, 0.02, frames[2][1].shape),
                                    0.0).astype(np.float32)
    ref = np.asarray(jdepth.bilateral_filter_depth(jnp.asarray(depth)))
    got = tdepth.bilateral_filter_depth(torch.from_numpy(depth)).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def _jax_depth_frame(jc, img, depth, thr, **kw):
    out = jax.jit(lambda i, d, t: jframe.process_depth_frame(
        jc, i, d, t, jnp.float32(0.3), jnp.float32(30.0), capacity=CAPACITY,
        bin_size=10, **kw))(jnp.asarray(img), jnp.asarray(depth), jnp.float32(thr))
    return out


def _torch_depth_frame(tc, img, depth, thr, **kw):
    return tframe.process_depth_frame(tc, torch.from_numpy(img), torch.from_numpy(depth),
                                      torch.tensor(thr), 0.3, 30.0, capacity=CAPACITY,
                                      bin_size=10, **kw)


def _assert_same_frame(tf, jf):
    jf = {k: np.asarray(v) for k, v in jf._asdict().items()}
    for name in ("uv4", "valid", "reliable", "track_len", "landmark_slot"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), jf[name], err_msg=name)
    np.testing.assert_array_equal(tf.desc.numpy(), jf["desc"].view(np.int32))
    np.testing.assert_allclose(tf.p_cam.numpy(), jf["p_cam"], rtol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("brief256_planes", dict(want_planes=True)),
    ("brief256", dict(want_planes=False)),
    ("brief256_pyramid", dict(want_planes=True, octaves=2)),
    ("brief256r", dict(want_planes=True, descriptor="BRIEF256R")),
])
def test_process_depth_frame_matches_jax(scene, monkeypatch, name, kw):
    monkeypatch.setattr(jbrief, "_ROT_FILTERS_CACHE", {})
    jc, tc, _, frames = scene
    img, depth = frames[4]
    jout = _jax_depth_frame(jc, img, depth, 12.0, **kw)
    tout = _torch_depth_frame(tc, img, depth, 12.0, **kw)
    _assert_same_frame(tout[0], jout[0])
    assert int(tout[1]) == int(jout[1]) and int(tout[2]) == int(jout[2])
    assert int(tout[2]) > 100
    if kw["want_planes"]:
        np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]).view(np.int32))


def _assert_same_orb_frame(tf, jf):
    """As _assert_same_frame, the differing descriptor bits counted (at
    most 0.1%: ORB256's bilinear compares may flip at a tie)."""
    jf = {k: np.asarray(v) for k, v in jf._asdict().items()}
    for name in ("uv4", "valid", "reliable", "track_len", "landmark_slot"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), jf[name], err_msg=name)
    want = jf["desc"].view(np.int32)
    n_diff = int(np.unpackbits((tf.desc.numpy() ^ want).view(np.uint8)).sum())
    assert n_diff <= 1e-3 * want.size * 32, n_diff
    np.testing.assert_allclose(tf.p_cam.numpy(), jf["p_cam"], rtol=1e-6)


@pytest.mark.parametrize("want_planes", [True, False])
def test_process_depth_frame_rejects_orb(scene, want_planes):
    """ORB256 was once refused here; it is ported: the depth front-end
    with ORB256 gives JAX's frame and returns no planes (recovery
    describes the image)."""
    jc, tc, _, frames = scene
    img, depth = frames[4]
    kw = dict(want_planes=want_planes, descriptor="ORB256")
    jout = _jax_depth_frame(jc, img, depth, 12.0, **kw)
    tout = _torch_depth_frame(tc, img, depth, 12.0, **kw)
    _assert_same_orb_frame(tout[0], jout[0])
    assert int(tout[1]) == int(jout[1]) and int(tout[2]) == int(jout[2]) > 100
    if want_planes:
        assert tout[3] is None and jout[3] is None


def _uvd_problem(seed=0, n=200):
    rng = np.random.default_rng(seed)
    p = np.c_[rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(0.5, 5, n)]
    T = np.asarray(jlie.exp_se3(jnp.asarray([0.05, -0.02, 0.1, 0.01, -0.03, 0.02],
                                            jnp.float32)), np.float64)
    q = p @ T[:3, :3].T + T[:3, 3]
    fx, fy, cx, cy = (CAM_ARGS[k] for k in ("fx", "fy", "cx", "cy"))
    meas = np.c_[fx * q[:, 0] / q[:, 2] + cx, fy * q[:, 1] / q[:, 2] + cy, q[:, 2]]
    meas += rng.normal(0, [0.5, 0.5, 0.01], meas.shape)
    meas[::9, :2] += 25.0  # outliers
    reliable = rng.uniform(size=n) > 0.1
    meas[~reliable, 2] = 0.0
    return dict(p_prev=p.astype(np.float32), meas=meas.astype(np.float32),
                weight=rng.uniform(1, 3, n).astype(np.float32), depth_reliable=reliable), \
        rng.uniform(size=n) > 0.05


def test_uvd_align_matches_jax(scene):
    jc, tc, _, _ = scene
    d, mask = _uvd_problem()
    ref = jal.uvd_align(jc, jal.UVDData(**{k: jnp.asarray(v) for k, v in d.items()}),
                        jnp.asarray(mask), jnp.eye(4), jgn.GNConfig())
    got = tal.uvd_align(tc, tal.UVDData(**{k: torch.from_numpy(v) for k, v in d.items()}),
                        torch.from_numpy(mask), torch.eye(4), tgn.GNConfig())
    assert np.abs(got.x.numpy() - np.asarray(ref.x)).max() <= 1e-5
    assert int(got.num_iterations) == int(ref.num_iterations) >= 2
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(ref.inlier_mask))
    assert int(got.num_inliers) == int(ref.num_inliers) > 100
    assert bool(got.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-4)


def test_update_landmarks_uvd_matches_jax(scene):
    jc, tc, _, _ = scene
    rng = np.random.default_rng(2)
    M = 64
    xyz = np.c_[rng.uniform(-2, 2, M), rng.uniform(-1, 1, M), rng.uniform(1, 5, M)]
    T_wc = np.asarray(jlie.exp_se3(jnp.asarray([0.1, 0.0, -0.2, 0.0, 0.05, 0.0],
                                               jnp.float32)))
    p = (xyz - T_wc[:3, 3]) @ T_wc[:3, :3]
    fx, fy, cx, cy = (CAM_ARGS[k] for k in ("fx", "fy", "cx", "cy"))
    meas = np.c_[fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy, p[:, 2]]
    meas = (meas + rng.normal(0, [1.0, 1.0, 0.05], meas.shape)).astype(np.float32)
    meas[::5, :2] += 12.0  # past the kernel
    xyz = (xyz + rng.normal(0, 0.05, xyz.shape)).astype(np.float32)
    H = np.einsum("mi,mj->mij", *(rng.normal(0, 3, (2, M, 3)))).astype(np.float32)
    H = (H + np.transpose(H, (0, 2, 1)) + 5 * np.eye(3, dtype=np.float32)).astype(np.float32)
    obs = rng.uniform(size=M) > 0.2
    ref = jal.update_landmarks_uvd(jc, jnp.asarray(xyz), jnp.asarray(H), jnp.asarray(T_wc),
                                   jnp.asarray(meas), jnp.asarray(obs))
    got = tal.update_landmarks_uvd(tc, *(torch.from_numpy(a) for a in (xyz, H, T_wc, meas,
                                                                        obs)))
    assert np.abs(got[0].numpy() - np.asarray(ref[0])).max() <= 1e-4
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert not np.asarray(ref[3]).all()  # the kernel is active


def test_recover_lost_landmarks_depth_matches_jax(scene):
    jc, tc, world, frames = scene
    prev_j = _jax_depth_frame(jc, *frames[6], 12.0, want_planes=False)[0]
    cur_j, _, _, planes_j = _jax_depth_frame(jc, *frames[7], 12.0, want_planes=True)
    # Free the second half of the current frame's rows for the recovered points.
    cur_j = cur_j._replace(valid=cur_j.valid & (jnp.arange(CAPACITY) < CAPACITY // 2))
    valid = np.asarray(prev_j.valid)
    prev_j = prev_j._replace(
        landmark_slot=jnp.asarray(np.where(valid, np.arange(CAPACITY), -1), jnp.int32),
        track_len=jnp.asarray(np.where(valid, 3, 0), jnp.int32))
    rng = np.random.default_rng(4)
    prev_to_cur = np.where(rng.uniform(size=CAPACITY) < 0.6, -1, 0).astype(np.int32)
    motion = np.linalg.inv(world.poses[7]) @ world.poses[6]
    ref, n_ref = jframe.recover_lost_landmarks_depth(
        jc, prev_j, cur_j, jnp.asarray(motion), jnp.asarray(prev_to_cur), planes_j,
        jnp.asarray(frames[7][0]), jnp.asarray(frames[7][1]), jnp.float32(50.0),
        jnp.float32(0.3), jnp.float32(30.0), border=20)
    to_t = {k: np.asarray(v) for k, v in prev_j._asdict().items()}
    got, n_got = tframe.recover_lost_landmarks_depth(
        tc, from_jax.frame_state_from_numpy(to_t),
        from_jax.frame_state_from_numpy({k: np.asarray(v) for k, v in cur_j._asdict().items()}),
        torch.from_numpy(motion), torch.from_numpy(prev_to_cur),
        torch.from_numpy(np.asarray(planes_j).view(np.int32)), torch.from_numpy(frames[7][0]),
        torch.from_numpy(frames[7][1]),
        torch.tensor(50.0), 0.3, 30.0, border=20)
    assert int(n_got) == int(n_ref) > 20
    _assert_same_frame(got, ref)


def test_recover_lost_landmarks_depth_orb256_matches_jax(scene):
    jc, tc, world, frames = scene
    kw = dict(want_planes=False, descriptor="ORB256")
    prev_j = _jax_depth_frame(jc, *frames[6], 12.0, **kw)[0]
    cur_j = _jax_depth_frame(jc, *frames[7], 12.0, **kw)[0]
    cur_j = cur_j._replace(valid=cur_j.valid & (jnp.arange(CAPACITY) < CAPACITY // 2))
    valid = np.asarray(prev_j.valid)
    prev_j = prev_j._replace(
        landmark_slot=jnp.asarray(np.where(valid, np.arange(CAPACITY), -1), jnp.int32),
        track_len=jnp.asarray(np.where(valid, 3, 0), jnp.int32))
    prev_to_cur = np.where(np.random.default_rng(4).uniform(size=CAPACITY) < 0.6, -1,
                           0).astype(np.int32)
    motion = np.linalg.inv(world.poses[7]) @ world.poses[6]
    ref, n_ref = jframe.recover_lost_landmarks_depth(
        jc, prev_j, cur_j, jnp.asarray(motion), jnp.asarray(prev_to_cur), None,
        jnp.asarray(frames[7][0]), jnp.asarray(frames[7][1]), jnp.float32(50.0),
        jnp.float32(0.3), jnp.float32(30.0), border=20, descriptor="ORB256")
    got, n_got = tframe.recover_lost_landmarks_depth(
        tc, from_jax.frame_state_from_numpy({k: np.asarray(v) for k, v in
                                             prev_j._asdict().items()}),
        from_jax.frame_state_from_numpy({k: np.asarray(v) for k, v in cur_j._asdict().items()}),
        torch.from_numpy(motion), torch.from_numpy(prev_to_cur), None,
        torch.from_numpy(frames[7][0]), torch.from_numpy(frames[7][1]),
        torch.tensor(50.0), 0.3, 30.0, border=20, descriptor="ORB256")
    assert int(n_got) == int(n_ref) > 20
    _assert_same_orb_frame(got, ref)


def _tracker_config(cls, calib=None):
    cfg = cls()
    cfg.command_line.tracker_mode = "RGB_DEPTH"
    cfg.framepoint_generation.capacity = CAPACITY
    cfg.framepoint_generation.bin_size_pixels = 10
    cfg.framepoint_generation.maximum_depth_meters = 30.0
    if calib is not None:
        cfg.framepoint_generation.depth_camera_intrinsics = calib[0]
        cfg.framepoint_generation.depth_camera_to_rgb = calib[1]
    return cfg


@pytest.mark.parametrize("sensor", ["registered", "misaligned"])
def test_rgbd_tracker_matches_jax(scene, sensor):
    """16 frames of the RGB-D FusedPoseTracker in both packages; the
    misaligned depth camera sits 6 cm to the left of the RGB camera and
    its images are registered every frame through the configured
    calibration."""
    jc, tc, world, frames = scene
    calib = None
    if sensor == "misaligned":
        T_rgb_depth = np.eye(4, dtype=np.float32)
        T_rgb_depth[0, 3] = -0.06
        depth_world = tsyn.SyntheticWorld(
            cam=world.cam, points_w=world.points_w, textures=world.textures,
            poses=np.asarray([p @ T_rgb_depth for p in world.poses], np.float32),
            background=world.background, patch=world.patch)
        frames = [(img, tsyn.render_depth_frame(depth_world, t)[1])
                  for t, (img, _) in enumerate(frames)]
        calib = (np.asarray(tc.K).tolist(), T_rgb_depth.tolist())
    jt = JTracker(jc, _tracker_config(JConfig, calib), landmark_capacity=8192)
    tt = TTracker(tc, _tracker_config(TConfig, calib), landmark_capacity=8192, device="cpu")
    assert tt.mode == "depth" and (tt.depth_calib is None) == (calib is None)
    for img, depth in frames:
        jt.compute(img, depth)
        tt.compute(img, depth)
    jt.flush()
    tt.flush()
    for k in EVENTS:
        assert getattr(tt.stats, k) == getattr(jt.stats, k), k
    assert tt.stats.n_breaks == 0 and tt.stats.n_recovered > 20
    Tj, Tt = np.stack(jt.trajectory), np.stack(tt.trajectory)
    assert np.abs(Tt[:, :3, 3] - Tj[:, :3, 3]).max() <= 1e-4
    assert np.abs(Tt[-1, :3, 3] - world.poses[-1][:3, 3]).max() <= 0.05


def test_rgbd_tracker_with_the_xtion_front_end_matches_jax(scene):
    """16 frames with configuration_xtion.yaml's front-end and tracker
    settings (FAST + ORB256, bin 12, bilateral depth, its threshold
    controller and landmark settings), at this scene's capacity and depth
    range.

    Frames, breaks, keypoints, framepoints and inliers are JAX's exactly;
    the tracked and spawned counts within 2.  Over the run 3 of 4,096
    ORB256 descriptors differ from JAX's, by one bit each: the port's
    orientation is within 7e-6 rad of XLA's (which itself changes with
    how XLA fuses the program), and with XLA's angle the port's bits are
    exact.  Each flip moves one match (measured: tracked 1,541 against
    1,540, spawned 700 against 701).  Positions agree within 1e-4 m up to
    frame 5, before the first such flip, and within 2e-3 m after it
    (measured 1.2e-3 m at the end of a 4.5 m path); both runs end within
    0.1 m of the ground truth (measured 0.054 m)."""
    jc, tc, world, frames = scene
    cfgs = []
    for load in (jload, tload):
        cfg = load(os.path.join(REPO, "configurations", "configuration_xtion.yaml"))
        cfg.framepoint_generation.capacity = CAPACITY
        cfg.framepoint_generation.maximum_depth_meters = 30.0
        cfgs.append(cfg)
    assert cfgs[1].framepoint_generation.descriptor_type == "ORB256"
    jt = JTracker(jc, cfgs[0], landmark_capacity=8192)
    tt = TTracker(tc, cfgs[1], landmark_capacity=8192, device="cpu")
    assert tt.params.bilateral_depth and tt.params.descriptor == "ORB256"
    for img, depth in frames:
        jt.compute(img, depth)
        tt.compute(img, depth)
    jt.flush()
    tt.flush()
    for k in EVENTS:
        tol = 2 if k in ("n_tracked_points", "n_spawned") else 0
        assert abs(getattr(tt.stats, k) - getattr(jt.stats, k)) <= tol, k
    assert tt.stats.n_breaks == 0 and tt.stats.n_spawned > 500
    Tj, Tt = np.stack(jt.trajectory), np.stack(tt.trajectory)
    assert np.abs(Tt[:6, :3, 3] - Tj[:6, :3, 3]).max() <= 1e-4
    assert np.abs(Tt[:, :3, 3] - Tj[:, :3, 3]).max() <= 2e-3
    for T in (Tt, Tj):
        assert np.abs(T[-1, :3, 3] - world.poses[-1][:3, 3]).max() <= 0.1
