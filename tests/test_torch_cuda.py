"""The port's CUDA kernels and its shipped configurations on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither jax nor vslam_tpu, so it also runs where only the port
is installed:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax for the parity tests.)
Tolerance: none — each kernel is compared with its plain-torch version
for equality over the whole image; the open-loop engine runs on the card
are held to the port's CPU run within 1e-3 m on their first frames; the
closed loop to the same local-map count, >= 1 closure and ATE <= 0.10 m
on both devices; bundle adjustment and the RGB-D front-end to the CPU
as their docstrings state.
"""

import os

import numpy as np
import pytest
import torch

from vslam_tpu_torch.frontend import dense_brief as db
from vslam_tpu_torch.frontend import fast_brief as fb
from vslam_tpu_torch.eval import trajectory as traj_eval
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.io.config import ParameterCollection, load_config
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.system.engine import SlamEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")


def _uint8_valued(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.round(rng.uniform(0, 255, shape)).astype(np.float32))


@pytest.mark.cuda
def test_k1_kernel_matches_plain_version_on_the_card():
    _need_card()
    for arc_len in (9, 12):
        imgs = _uint8_valued((2, 200, 333), arc_len).cuda()
        thr = torch.tensor(12.0, device="cuda")
        got = fb.fast_brief_frontend_pair(imgs, thr, arc_len=arc_len)
        ref = fb.fast_brief_frontend_pair_reference(imgs, thr, arc_len=arc_len)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 120, 333), (1, 376, 1241)])
def test_dense_brief_kernel_matches_plain_version_on_the_card(shape):
    _need_card()
    sm = _uint8_valued(shape, 2).cuda()
    launches = (db.K2.launches, db.K3.launches, db.K4.launches)
    assert torch.equal(db.dense_bit_planes_batch(sm), db.dense_bit_planes_reference(sm))
    assert torch.equal(db.dense_bit_planes(sm[0]), db.dense_bit_planes_reference(sm[:1])[0])
    for bank in (0, 7, 15):
        assert torch.equal(db.dense_bit_planes_pattern(sm[0], bank),
                           db.dense_bit_planes_reference(sm[:1], 1 + bank)[0])
    assert (db.K2.launches, db.K3.launches, db.K4.launches) == (
        launches[0] + 1, launches[1] + 1, launches[2] + 3)
    for band in db.BANDS:  # the probe's bands and bf16 are built for table 0
        for dtype in (torch.float32, torch.bfloat16):
            x = sm.to(dtype).contiguous()
            assert torch.equal(db.KERNEL.launch(x, 0, band),
                               db.dense_bit_planes_reference(x, 0))


# Shapes that are not multiples of the tiles (K1: 32 x 64 outputs a block;
# the dense kernel: BAND x 128 a tile), and one smaller than the halo.
EDGE_SHAPES = [(2, 37, 53), (1, 200, 333), (3, 200, 333), (1, 12, 20), (3, 12, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("border", [16, 20, 31])
def test_k1_tiling_edges_match_plain_version(shape, border):
    _need_card()
    imgs = _uint8_valued(shape, border).cuda()
    for arc_len in (9, 12):
        for thr in (5.0, 100.0):
            t = torch.tensor(thr, device="cuda")
            got = fb.fast_brief_frontend_pair(imgs, t, arc_len=arc_len, border=border)
            ref = fb.fast_brief_frontend_pair_reference(imgs, t, arc_len=arc_len,
                                                        border=border)
            for name, a, b in zip(("planes", "score", "rowmax", "rowarg"), got, ref):
                assert torch.equal(a, b), (name, arc_len, thr)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_dense_kernel_tiling_edges_match_plain_version(shape):
    """Every table at the main band in f32; every probe band in f32 and
    bf16 at table 0."""
    _need_card()
    sm = _uint8_valued(shape, 7).cuda()
    for table in range(len(db.TABLES)):
        assert torch.equal(db.KERNEL.launch(sm, table),
                           db.dense_bit_planes_reference(sm, table)), table
    for band in db.BANDS:
        for dtype in (torch.float32, torch.bfloat16):
            x = sm.to(dtype).contiguous()
            assert torch.equal(db.KERNEL.launch(x, 0, band),
                               db.dense_bit_planes_reference(x, 0)), (band, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kitti", "euroc", "kitti_fast"])
def test_shipped_configurations_run_on_the_card(name):
    """Each shipped stereo configuration runs open loop on CUDA and agrees
    with the port's CPU run on the first frames."""
    _need_card()
    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512)
    world = synthetic.make_world(cam, n_frames=6, n_points=1500, seed=42, step=0.45)
    trajs = []
    for device in ("cuda", "cpu"):
        cfg = load_config(os.path.join(REPO, "configurations", f"configuration_{name}.yaml"))
        cfg.command_line.option_disable_relocalization = True
        engine = SlamEngine(cam, cfg, landmark_capacity=4096, device=device)
        for t in range(6):
            engine.process(*synthetic.render_frame(world, t)[:2])
        trajs.append(engine.trajectory)
        assert engine.report()["n_track_breaks"] == 0
    assert np.abs(trajs[0][:, :3, 3] - trajs[1][:, :3, 3]).max() <= 1e-3


@pytest.mark.cuda
def test_closed_loop_runs_on_the_card():
    """The 48-frame closed circle of tests/test_torch_closed_loop.py on
    the card and on the CPU.  The card harvests the tracker every
    parallelism.frames_per_chunk frames and the CPU every frame, and
    closure work resolves at drains, so the closures may come at other
    frames (and correct the trajectory from there): the runs are held to
    the same local maps, >= 1 closure each and ATE <= 0.10 m each, not to
    each other's poses."""
    _need_card()
    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512)
    n = 48
    world = synthetic.make_world(cam, n_points=1500, seed=21,
                                 poses=synthetic.circle_trajectory(n, radius=7.0))
    frames = [synthetic.render_frame(world, t)[:2] for t in range(n)]
    reps = []
    for device in ("cuda", "cpu"):
        cfg = ParameterCollection()
        cfg.framepoint_generation.capacity = 256
        cfg.framepoint_generation.border_pixels = 12
        cfg.world_map.minimum_distance_traveled_for_local_map = 0.8
        cfg.world_map.minimum_number_of_frames_for_local_map = 2
        cfg.relocalization.preliminary_minimum_interspace_queries = 6
        cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
        cfg.relocalization.icp_minimum_number_of_inliers = 8
        cfg.relocalization.icp_minimum_inlier_ratio = 0.3
        engine = SlamEngine(cam, cfg, landmark_capacity=8192, device=device)
        for h in engine.tracker.prestage(frames):
            engine.process_prestaged(h)
        traj = engine.trajectory
        rep = engine.report()
        assert traj.shape == (n, 4, 4) and np.all(np.isfinite(traj))
        assert rep["n_closures"] >= 1 and rep["n_track_breaks"] == 0, (device, rep)
        assert traj_eval.ate_rmse(traj, world.poses)[0] <= 0.10, device
        reps.append(rep)
    assert reps[0]["n_local_maps"] == reps[1]["n_local_maps"]


def _ba_problem(device, seed=0, P=6, L=256, O=4):
    """A random BA window (cameras 0.3 m apart, landmarks 5-15 m ahead,
    0.5 px noise, a few 30 px outliers, masked slots, odometry factors)."""
    from vslam_tpu_torch.backend import ba
    from vslam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    T = lie.exp_se3(torch.tensor(np.c_[0.3 * np.arange(P), 0.02 * rng.normal(size=(P, 2)),
                                       0.01 * rng.normal(size=(P, 3))], dtype=torch.float32))
    X = torch.tensor(np.c_[rng.uniform(-4, 4, L), rng.uniform(-2, 2, L),
                           rng.uniform(5, 15, L)], dtype=torch.float32)
    obs_cam = torch.tensor(np.stack([rng.choice(P, O, replace=False) for _ in range(L)]))
    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=160.0, cy=80.0, baseline_m=0.3,
                              rows=160, cols=320, device="cpu")
    uv4, _, _ = ba.stereo_residual_jacobians(cam, T[obs_cam], X[:, None], torch.zeros(4))
    uv4 = uv4 + torch.tensor(rng.normal(0, 0.5, uv4.shape), dtype=torch.float32)
    uv4[::7, 0] += 30.0
    mask = torch.tensor(rng.uniform(size=(L, O)) > 0.2)
    mask[:, :2] = True
    T0 = T.clone()
    T0[1:] = lie.exp_se3(torch.tensor(rng.normal(0, [0.05] * 3 + [0.01] * 3, (P - 1, 6)),
                                      dtype=torch.float32)) @ T[1:]
    odo_T = torch.eye(4).repeat(P, 1, 1)
    odo_T[:-1] = torch.linalg.inv(T0[:-1]) @ T0[1:]
    prob = ba.BAProblem(
        T_wc=T0, xyz=X + torch.tensor(rng.normal(0, 0.1, X.shape), dtype=torch.float32),
        obs_cam=obs_cam, obs_uv4=uv4,
        obs_weight=torch.tensor(rng.uniform(1, 3, (L, O)), dtype=torch.float32),
        obs_mask=mask, lm_valid=torch.arange(L) % 11 != 0, cam_fixed=torch.arange(P) == 0,
        odo_T=odo_T, odo_weight=torch.ones(P), odo_info=torch.tensor([10.0] * 3 + [1e4] * 3))
    return cam_ops.to_device(cam, device), ba.BAProblem(
        *(None if f is None else f.to(device) for f in prob))


@pytest.mark.cuda
def test_bundle_adjustment_on_the_card_matches_the_cpu():
    """Ten BA rounds on one problem: poses within 1e-5, points within
    1e-4 m and every round's chi2 within rtol 1e-4 of the CPU's (f32 sums
    in another order; the one-hot assembly has no atomics, so the card
    gives the same answer on every run: checked bit for bit)."""
    _need_card()
    from vslam_tpu_torch.backend import ba

    out = {d: ba.bundle_adjust(*_ba_problem(d)) for d in ("cuda", "cpu")}
    again = ba.bundle_adjust(*_ba_problem("cuda"))
    Tg, Xg, cg = (a.cpu() for a in out["cuda"])
    Tc, Xc, cc = out["cpu"]
    assert (Tg - Tc).abs().max() <= 1e-5
    assert (Xg - Xc).abs().max() <= 1e-4
    torch.testing.assert_close(cg, cc, rtol=1e-4, atol=0.0)
    assert cc[-1] < 0.1 * cc[0]
    for a, b in zip(again, out["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_depth_frame_on_the_card_matches_the_cpu():
    """process_depth_frame at 192 x 320 (K3 once): keypoints, descriptors,
    validity, uv4, the counts and the planes equal on both devices, p_cam
    within rtol 1e-6."""
    _need_card()
    from vslam_tpu_torch.mapping import frame

    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=160.0, cy=96.0, baseline_m=0.075,
                              rows=192, cols=320, device="cpu")
    world = synthetic.make_world(cam, n_frames=8, n_points=2500, seed=7, step=0.3)
    img, depth = synthetic.render_depth_frame(world, 4)
    outs = {}
    for device in ("cuda", "cpu"):
        before = db.K3.launches
        outs[device] = frame.process_depth_frame(
            cam_ops.to_device(cam, device), torch.from_numpy(img).to(device),
            torch.from_numpy(depth).to(device), torch.tensor(12.0, device=device), 0.3, 30.0,
            capacity=256, bin_size=10, want_planes=True)
        assert db.K3.launches - before == (1 if device == "cuda" else 0)
    (fg, *rest_g), (fc, *rest_c) = outs["cuda"], outs["cpu"]
    for name in ("uv4", "desc", "valid", "reliable", "track_len", "landmark_slot"):
        assert torch.equal(getattr(fg, name).cpu(), getattr(fc, name)), name
    torch.testing.assert_close(fg.p_cam.cpu(), fc.p_cam, rtol=1e-6, atol=0.0)
    for a, b in zip(rest_g, rest_c):
        assert torch.equal(a.cpu(), b)
    assert int(rest_c[1]) > 100
