"""Port parity: mapping/frame.py and mapping/landmarks.py against
vslam_tpu, on a rendered synthetic stereo sequence (192 x 512, uint8).

The JAX front-end is forced onto its fused (K1) branch — the branch the
port implements — by patching, inside each test only, brief._use_pallas
to True and the TPU kernel to its Pallas interpreter; the JAX call runs
under a fresh jax.jit so no trace cached by another test is reused.

Tolerances: the front-end is integer work plus a few f32 ops, so
FrameState is compared exactly (p_cam to rtol=1e-6).  The pose solve sums
in another order: pose to atol=1e-4 and inlier count within 2 (the
chi2 <= kernel gate can flip a borderline point).  Recovery and landmark
updates: integer fields exact, positions to atol=1e-4.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.frontend import brief as jbrief
from vslam_tpu.frontend import pallas_frontend as jpf
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.mapping import frame as jframe
from vslam_tpu.mapping import landmarks as jlm
from vslam_tpu.ops import camera as jcam
from vslam_tpu.ops import lie as jlie
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.mapping import frame as tframe
from vslam_tpu_torch.mapping import landmarks as tlm
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.solve import gn as tgn

# Under pytest-xdist each core runs a worker process; torch's own intra-op
# threads on top of that oversubscribe the CPU and slow these tests ~30x.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAM_ARGS = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                rows=192, cols=512)
CAPACITY = 256
STEREO = (60, 1.5, 1.0, 200.0)  # max Hamming, epipolar tol, min/max disparity


@pytest.fixture(scope="module")
def scene():
    jc = jcam.make_camera(**CAM_ARGS)
    tc = from_jax.camera_from_numpy(np.asarray(jc.K), np.asarray(jc.baseline_m),
                                    jc.rows, jc.cols)
    world = jsyn.make_world(jc, n_frames=16, n_points=1500, seed=42, step=0.45)
    imgs = [np.stack(jsyn.render_frame(world, t)[:2]).astype(np.uint8).astype(np.float32)
            for t in (3, 4)]
    return jc, tc, world, imgs


def _jax_frontend(monkeypatch, jc, pair, thr):
    monkeypatch.setattr(jbrief, "_use_pallas", lambda: True)
    monkeypatch.setattr(jpf, "fast_brief_frontend_pair",
                        partial(jpf.fast_brief_frontend_pair, interpret=True))
    mh, et, mind, maxd = STEREO

    @jax.jit
    def run(il, ir, t):
        return jframe.stereo_frontend_core(
            jc, il, ir, t, jnp.int32(mh), jnp.float32(et), jnp.float32(mind),
            jnp.float32(maxd), capacity=CAPACITY, bin_size=16, border=20,
            want_planes=True,
        )

    return run(jnp.asarray(pair[0]), jnp.asarray(pair[1]), jnp.float32(thr))


def _torch_frontend(tc, pair, thr):
    p = torch.from_numpy(pair)
    return tframe.stereo_frontend_core(
        tc, p[0], p[1], torch.tensor(thr), *STEREO, capacity=CAPACITY,
        bin_size=16, border=20, want_planes=True,
    )


def _np(fs):
    return {k: np.asarray(v) for k, v in fs._asdict().items()}


@pytest.fixture(scope="module")
def frames(scene):
    """JAX K1-branch front-end outputs for frames 3 and 4 (numpy)."""
    jc, _, _, imgs = scene
    mp = pytest.MonkeyPatch()
    try:
        return [tuple(_np(o) if hasattr(o, "_asdict") else np.asarray(o)
                      for o in _jax_frontend(mp, jc, pair, 20.0))
                for pair in imgs]
    finally:
        mp.undo()


@pytest.mark.parametrize("thr", [12.0, 20.0])
def test_stereo_frontend_core_matches_jax_k1_branch(monkeypatch, scene, thr):
    jc, tc, _, imgs = scene
    jf, jn_kp, jn_fp, jplanes = _jax_frontend(monkeypatch, jc, imgs[1], thr)
    tf, tn_kp, tn_fp, tplanes = _torch_frontend(tc, imgs[1], thr)
    assert int(tn_kp) == int(jn_kp) and int(tn_fp) == int(jn_fp)
    assert int(tn_fp) > 50  # a real frame, not an empty one
    for name in ("uv4", "valid", "reliable", "track_len", "landmark_slot"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)), err_msg=name)
    np.testing.assert_array_equal(tf.desc.numpy(), np.asarray(jf.desc).view(np.int32))
    np.testing.assert_allclose(tf.p_cam.numpy(), np.asarray(jf.p_cam), rtol=1e-6)
    np.testing.assert_array_equal(tplanes.numpy(), np.asarray(jplanes).view(np.int32))


def _gt_motion(world, a, b):
    """T_cur_prev for prev frame a, cur frame b."""
    return (np.linalg.inv(world.poses[b]) @ world.poses[a]).astype(np.float32)


def _track_inputs(scene, frames):
    _, _, world, _ = scene
    prev, cur = frames[0][0], frames[1][0]
    guess = _gt_motion(world, 3, 4)
    guess[:3, 3] += np.array([0.02, -0.01, 0.03], np.float32)
    weights = np.random.default_rng(3).uniform(1.0, 3.0, CAPACITY).astype(np.float32)
    return prev, cur, guess, weights


def _track_both(scene, frames):
    jc, tc, _, _ = scene
    prev, cur, guess, weights = _track_inputs(scene, frames)
    jres = jframe.track_and_align(
        jc, jframe.FrameState(**{k: jnp.asarray(v) for k, v in prev.items()}),
        jframe.FrameState(**{k: jnp.asarray(v) for k, v in cur.items()}),
        jnp.asarray(guess), jnp.float32(50.0), jnp.int32(60), jnp.asarray(weights),
    )
    tres = tframe.track_and_align(
        tc, from_jax.frame_state_from_numpy(prev), from_jax.frame_state_from_numpy(cur),
        torch.from_numpy(guess), torch.tensor(50.0), torch.tensor(60, dtype=torch.int32),
        torch.from_numpy(weights), tgn.GNConfig(),
    )
    return jres, tres


def test_track_and_align_matches_jax(scene, frames):
    jres, tres = _track_both(scene, frames)
    np.testing.assert_allclose(tres.T_cur_prev.numpy(), np.asarray(jres.T_cur_prev),
                               atol=1e-4)
    assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= 2
    assert int(jres.n_inliers) > 50
    assert int(tres.n_matches) == int(jres.n_matches)
    np.testing.assert_array_equal(tres.prev_to_cur.numpy(), np.asarray(jres.prev_to_cur))
    assert bool(tres.converged) == bool(jres.converged)


def test_propagate_promote_recover_match_jax(scene, frames):
    jc, tc, _, _ = scene
    jres, _ = _track_both(scene, frames)
    prev, cur = dict(frames[0][0]), frames[1][0]
    planes = frames[1][3]
    prev["landmark_slot"] = np.where(prev["valid"], np.arange(CAPACITY), -1).astype(np.int32)
    prev["track_len"] = np.where(prev["valid"], 3, 0).astype(np.int32)
    p2c = np.asarray(jres.prev_to_cur).copy()
    p2c[::2] = -1  # every other track lost: recovery candidates
    motion = np.array(jres.T_cur_prev)
    jprev = jframe.FrameState(**{k: jnp.asarray(v) for k, v in prev.items()})
    jcur = jframe.FrameState(**{k: jnp.asarray(v) for k, v in cur.items()})
    tprev, tcur = from_jax.frame_state_from_numpy(prev), from_jax.frame_state_from_numpy(cur)

    @jax.jit
    def jax_chain(p2c_j, motion_j, planes_j):
        c = jframe.propagate_tracks(jprev, jcur, p2c_j)
        c, n_prom = jframe.promote_temporary_points(jc, jprev, c, motion_j, p2c_j)
        c, n_rec = jframe.recover_lost_landmarks(
            jc, jprev, c, motion_j, p2c_j, planes_j, jnp.zeros((192, 512)),
            jnp.zeros((192, 512)), jnp.float32(50.0), jnp.float32(1.0),
            jnp.float32(200.0), border=20)
        return c, n_prom, n_rec

    jout, jn_prom, jn_rec = jax_chain(jnp.asarray(p2c), jnp.asarray(motion),
                                      jnp.asarray(planes))
    t_p2c, t_motion = torch.from_numpy(p2c), torch.from_numpy(motion)
    tout = tframe.propagate_tracks(tprev, tcur, t_p2c)
    tout, tn_prom = tframe.promote_temporary_points(tc, tprev, tout, t_motion, t_p2c)
    tout, tn_rec = tframe.recover_lost_landmarks(
        tc, tprev, tout, t_motion, t_p2c,
        torch.from_numpy(planes.view(np.int32)), torch.zeros((192, 512)),
        torch.zeros((192, 512)), 50.0, 1.0, 200.0, border=20)
    assert int(jn_rec) > 10  # recovery actually ran
    assert int(tn_rec) == int(jn_rec) and int(tn_prom) == int(jn_prom)
    for name in ("valid", "reliable", "track_len", "landmark_slot"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)), err_msg=name)
    np.testing.assert_array_equal(tout.desc.numpy(), np.asarray(jout.desc).view(np.int32))
    np.testing.assert_allclose(tout.uv4.numpy(), np.asarray(jout.uv4), atol=1e-4)
    np.testing.assert_allclose(tout.p_cam.numpy(), np.asarray(jout.p_cam), atol=1e-4)


def test_spawn_and_update_observed_matches_jax(scene, frames):
    jc, tc, world, _ = scene
    cur = frames[1][0]
    rng = np.random.default_rng(5)
    M = 1024
    T_wc = world.poses[4].astype(np.float32)
    xyz_true = cur["p_cam"] @ T_wc[:3, :3].T + T_wc[:3, 3]
    # Half the valid points observe an existing landmark, a quarter spawn
    # a fresh one, the rest have none.
    valid_rows = np.flatnonzero(cur["valid"])
    role = rng.integers(0, 4, len(valid_rows))
    slots = np.full(CAPACITY, -1, np.int32)
    fresh = np.zeros(CAPACITY, bool)
    used = rng.permutation(M)
    slots[valid_rows[role <= 1]] = used[: np.sum(role <= 1)]
    n_fresh = np.sum(role == 2)
    slots[valid_rows[role == 2]] = used[-n_fresh:]
    fresh[valid_rows[role == 2]] = True
    table = {
        "xyz_w": (rng.normal(0, 5, (M, 3))).astype(np.float32),
        "H_acc": np.tile(np.eye(3, dtype=np.float32) * 4.0, (M, 1, 1)),
        "desc": rng.integers(0, 2**32, (M, 8), dtype=np.uint32),
        "n_updates": rng.integers(1, 6, M).astype(np.int32),
        "last_seen": rng.integers(0, 4, M).astype(np.int32),
        "valid": np.ones(M, bool),
        "origin_kf": rng.integers(0, 3, M).astype(np.int32),
        "protected": rng.uniform(size=M) < 0.5,
    }
    obs_rows = valid_rows[role <= 1]
    table["xyz_w"][slots[obs_rows]] = xyz_true[obs_rows] + rng.normal(
        0, 0.05, (len(obs_rows), 3)).astype(np.float32)
    table["valid"][used[-n_fresh:]] = False
    args = (T_wc, slots, fresh, cur["p_cam"], cur["uv4"], cur["desc"], cur["valid"])
    kw = dict(min_forced_updates=2, min_meas_for_opt=2, max_t_err_depth_ratio=1.0)
    jt = jlm.spawn_and_update_observed(
        jc, jlm.LandmarkTable(**{k: jnp.asarray(v) for k, v in table.items()}),
        *(jnp.asarray(a) for a in args), jnp.int32(4), jnp.int32(2), **kw)
    tt = tlm.spawn_and_update_observed(
        tc, from_jax.landmark_table_from_numpy(table),
        *(torch.from_numpy(np.ascontiguousarray(
            a.view(np.int32) if a.dtype == np.uint32 else a)) for a in args),
        torch.tensor(4, dtype=torch.int32), torch.tensor(2, dtype=torch.int32), **kw)
    got = from_jax.landmark_table_to_numpy(tt)
    for name in ("desc", "n_updates", "last_seen", "valid", "origin_kf", "protected"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jt, name)), err_msg=name)
    np.testing.assert_allclose(got["xyz_w"], np.asarray(jt.xyz_w), atol=1e-4)
    np.testing.assert_allclose(got["H_acc"], np.asarray(jt.H_acc), rtol=1e-4, atol=1e-3)
    w_t = tlm.landmark_weights(tt, torch.from_numpy(slots)).numpy()
    w_j = np.asarray(jlm.landmark_weights(jt, jnp.asarray(slots)))
    np.testing.assert_allclose(w_t, w_j, atol=1e-6)


DETECTORS = ("FAST", "FAST12", "AGAST", "HARRIS", "GFTT", "SHI_TOMASI", "DOG", "KAZE",
             "AKAZE")


def test_unported_front_end_options_raise(scene):
    """No front-end option is left unported: every detector with every
    descriptor runs on the stereo and the depth front-end (a 96 x 160
    crop, one and two octaves; tests/test_torch_staged.py and
    tests/test_torch_rgbd.py hold them against JAX), and only an unknown
    detector name raises."""
    _, _, _, imgs = scene
    crop = torch.from_numpy(imgs[0][:, 48:144, 176:336].copy())
    cam = tcam.make_camera(fx=300.0, fy=300.0, cx=80.0, cy=48.0, baseline_m=0.4,
                           rows=96, cols=160, device="cpu")
    depth_m = torch.full((96, 160), 5.0)
    thr = torch.tensor(10.0)
    for detector in DETECTORS:
        for descriptor in ("BRIEF256", "BRIEF256R", "ORB256"):
            octaves = 2 if detector in ("FAST", "DOG") else 1
            kw = dict(capacity=64, bin_size=12, border=20, descriptor=descriptor,
                      detector=detector, octaves=octaves, want_planes=True)
            frame, n_kp, _, planes = tframe.stereo_frontend_core(
                cam, crop[0], crop[1], thr, *STEREO, **kw)
            dframe, dn_kp, _, dplanes = tframe.process_depth_frame(
                cam, crop[0], depth_m, thr, 0.3, 10.0, **kw)
            assert int(n_kp) == int(dn_kp) > 0, (detector, descriptor)
            assert frame.desc.shape == dframe.desc.shape == (64, 8)
            assert (planes is None) == (dplanes is None) == (descriptor == "ORB256")
    for run in (lambda kw: tframe.stereo_frontend_core(cam, crop[0], crop[1], thr,
                                                       *STEREO, **kw),
                lambda kw: tframe.process_depth_frame(cam, crop[0], depth_m, thr,
                                                      0.3, 10.0, **kw)):
        with pytest.raises(ValueError, match="unknown detector"):
            run(dict(capacity=64, bin_size=12, border=20, detector="SIFT"))


def test_recover_lost_landmarks_orb256_matches_jax(scene):
    """ORB256 recovery describes both images at the projections (no
    planes).  Integer fields exact, the recovered count exact, the
    differing descriptor bits counted (at most 0.1%), positions 1e-4."""
    jc, tc, world, imgs = scene
    mh, et, mind, maxd = STEREO

    @jax.jit
    def jfront(il, ir):
        return jframe.stereo_frontend_core(
            jc, il, ir, jnp.float32(20.0), jnp.int32(mh), jnp.float32(et),
            jnp.float32(mind), jnp.float32(maxd), capacity=CAPACITY, bin_size=16,
            border=20, descriptor="ORB256")[0]

    prev_j = jfront(jnp.asarray(imgs[0][0]), jnp.asarray(imgs[0][1]))
    cur_j = jfront(jnp.asarray(imgs[1][0]), jnp.asarray(imgs[1][1]))
    cur_j = cur_j._replace(valid=cur_j.valid & (jnp.arange(CAPACITY) < CAPACITY // 2))
    valid = np.asarray(prev_j.valid)
    prev_j = prev_j._replace(
        landmark_slot=jnp.asarray(np.where(valid, np.arange(CAPACITY), -1), jnp.int32),
        track_len=jnp.asarray(np.where(valid, 3, 0), jnp.int32))
    p2c = np.where(np.random.default_rng(4).uniform(size=CAPACITY) < 0.6, -1, 0)
    p2c = p2c.astype(np.int32)
    motion = _gt_motion(world, 3, 4)
    ref, n_ref = jframe.recover_lost_landmarks(
        jc, prev_j, cur_j, jnp.asarray(motion), jnp.asarray(p2c), None,
        jnp.asarray(imgs[1][0]), jnp.asarray(imgs[1][1]), jnp.float32(50.0),
        jnp.float32(1.0), jnp.float32(200.0), border=20, descriptor="ORB256")
    got, n_got = tframe.recover_lost_landmarks(
        tc, from_jax.frame_state_from_numpy(_np(prev_j)),
        from_jax.frame_state_from_numpy(_np(cur_j)), torch.from_numpy(motion),
        torch.from_numpy(p2c), None, torch.from_numpy(imgs[1][0]),
        torch.from_numpy(imgs[1][1]), 50.0, 1.0, 200.0, border=20, descriptor="ORB256")
    assert int(n_got) == int(n_ref) > 10
    for name in ("valid", "reliable", "track_len", "landmark_slot"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    want_desc = np.asarray(ref.desc).view(np.int32)
    n_diff = int(np.unpackbits((got.desc.numpy() ^ want_desc).view(np.uint8)).sum())
    assert n_diff <= 1e-3 * want_desc.size * 32, n_diff
    np.testing.assert_allclose(got.uv4.numpy(), np.asarray(ref.uv4), atol=1e-4)
    np.testing.assert_allclose(got.p_cam.numpy(), np.asarray(ref.p_cam), atol=1e-4)
