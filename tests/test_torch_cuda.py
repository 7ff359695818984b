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


@pytest.mark.cuda
def test_modular_tracker_on_the_card_matches_the_cpu():
    """The modular PoseTracker (tracking.use_fused_tracker: false) for 8
    frames at 192 x 512, border 16 (K1): on the card every integer of
    every frame (keypoints, threshold, status, breaks, allocations) is the
    CPU's and every position within 1e-4 m, and K1 launches once a frame."""
    _need_card()
    from vslam_tpu_torch.tracking.tracker import PoseTracker

    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512, device="cpu")
    world = synthetic.make_world(cam, n_frames=8, n_points=1500, seed=5, step=0.4)
    frames = [synthetic.render_frame(world, t)[:2] for t in range(8)]
    runs = []
    for device in ("cuda", "cpu"):
        cfg = ParameterCollection()
        cfg.framepoint_generation.capacity = 256
        cfg.framepoint_generation.border_pixels = 16
        tracker = PoseTracker(cam, cfg, landmark_capacity=4096, device=device)
        before, rows, n_kp = fb.K1.launches, [], 0
        for f in frames:
            tracker.compute(*f)
            rows.append((tracker.stats.n_keypoints - n_kp, tracker.controller.threshold,
                         tracker.status, tracker.stats.n_breaks,
                         tracker.allocator.num_allocated))
            n_kp = tracker.stats.n_keypoints
        assert fb.K1.launches - before == (len(frames) if device == "cuda" else 0)
        runs.append((rows, np.stack(tracker.trajectory)))
    assert runs[0][0] == runs[1][0] and runs[0][0][-1][4] > 100
    assert np.abs(runs[0][1][:, :3, 3] - runs[1][1][:, :3, 3]).max() <= 1e-4


def _modular_engine_run(device, kind):
    """The modular engine (tracking.use_fused_tracker: false) on a small
    sequence: "rgbd" -- 12 RGB-D frames at 192 x 320, closed loop; "ba" --
    tests/test_torch_ba_engine.py's corridor (36 frames at 160 x 320,
    border 12, BA every 8 frames, open loop).  Returns (report,
    trajectory)."""
    cfg = ParameterCollection()
    cfg.tracking.use_fused_tracker = False
    if kind == "rgbd":
        cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=160.0, cy=96.0, baseline_m=0.075,
                                  rows=192, cols=320, device="cpu")
        world = synthetic.make_world(cam, n_frames=12, n_points=2500, seed=7, step=0.3)
        frames = [synthetic.render_depth_frame(world, t) for t in range(12)]
        cfg.command_line.tracker_mode = "RGB_DEPTH"
        cfg.framepoint_generation.capacity = 256
        cfg.framepoint_generation.bin_size_pixels = 10
        cfg.framepoint_generation.maximum_depth_meters = 30.0
        cfg.world_map.minimum_number_of_frames_for_local_map = 2
    else:
        cam = cam_ops.make_camera(fx=400.0, fy=400.0, cx=160.0, cy=80.0, baseline_m=0.3,
                                  rows=160, cols=320, device="cpu")
        world = synthetic.make_world(cam, n_frames=36, n_points=2500, seed=8, step=0.4,
                                     turn_rate=0.004)
        frames = [synthetic.render_frame(world, t)[:2] for t in range(36)]
        cfg.framepoint_generation.capacity = 256
        cfg.framepoint_generation.bin_size_pixels = 10
        cfg.framepoint_generation.border_pixels = 12
        cfg.local_map.minimum_number_of_landmarks = 20
        cfg.world_map.minimum_distance_traveled_for_local_map = 0.6
        cfg.world_map.minimum_number_of_frames_for_local_map = 2
        cfg.command_line.option_disable_relocalization = True
        cfg.graph_optimization.enable_full_bundle_adjustment = True
        cfg.graph_optimization.number_of_frames_per_bundle_adjustment = 8
    engine = SlamEngine(cam, cfg, landmark_capacity=8192, device=device)
    for f in frames:
        engine.process(*f)
    return engine.report(), engine.trajectory


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rgbd", "ba"])
def test_modular_engine_on_the_card_matches_the_cpu(kind):
    """The modular engine, RGB-D closed loop and stereo with BA, on the
    card and the CPU: the same local maps, BA runs and breaks (0), every
    position within 1e-3 m (nothing is in flight: both resolve keyframes
    after every frame)."""
    _need_card()
    (rep_c, traj_c), (rep_p, traj_p) = (_modular_engine_run(d, kind) for d in ("cuda", "cpu"))
    for k in ("n_local_maps", "n_ba_runs", "n_track_breaks", "n_closures"):
        assert rep_c[k] == rep_p[k], (k, rep_c[k], rep_p[k])
    assert rep_c["n_track_breaks"] == 0 and rep_c["n_local_maps"] >= 3
    assert (rep_c["n_ba_runs"] >= 2) == (kind == "ba")
    assert np.abs(traj_c[:, :3, 3] - traj_p[:, :3, 3]).max() <= 1e-3


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


@pytest.mark.cuda
@pytest.mark.parametrize("detector", ["HARRIS", "GFTT", "DOG", "KAZE"])
def test_float_detectors_and_orb256_on_the_card_match_the_cpu(detector):
    """The float detectors at 2 octaves keep >= 99% of the CPU's
    keypoints on the card (plain torch ops: no kernel of the port), and
    ORB256 descriptors of them differ in <= 0.1% of their bits."""
    _need_card()
    from vslam_tpu_torch.frontend import detect, orb

    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=160.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=320, device="cpu")
    world = synthetic.make_world(cam, n_frames=8, n_points=2500, seed=7, step=0.3)
    img = torch.from_numpy(synthetic.render_frame(world, 4)[0].astype(np.uint8)
                           .astype(np.float32))
    kps, descs = {}, {}
    for device in ("cuda", "cpu"):
        kp = detect.detect_keypoints(img.to(device), torch.tensor(10.0, device=device), 12,
                                     256, 20, detector, octaves=2)
        kps[device] = set(map(tuple, kp.uv[kp.valid].cpu().numpy().tolist()))
        descs[device] = orb.describe(img.to(device), kp.uv).cpu().numpy()
    assert len(kps["cpu"]) > 50
    assert len(kps["cuda"] & kps["cpu"]) >= 0.99 * len(kps["cpu"])
    if kps["cuda"] == kps["cpu"]:
        n_diff = int(np.unpackbits((descs["cuda"] ^ descs["cpu"]).view(np.uint8)).sum())
        assert n_diff <= 1e-3 * descs["cpu"].size * 32


@pytest.mark.cuda
def test_cli_run_on_a_kitti_directory_on_the_card(tmp_path):
    """`python -m vslam_tpu_torch run` (in process, no --device: the card)
    on a 4-frame KITTI directory: K1 once a frame, finite poses that agree
    with the same run on the CPU within 1e-3 m."""
    _need_card()
    import json

    from vslam_tpu_torch.io.image import write_png
    from vslam_tpu_torch.system import cli

    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512, device="cpu")
    world = synthetic.make_world(cam, n_frames=4, n_points=1500, seed=40, step=0.3)
    root = tmp_path / "seq"
    for d in ("image_0", "image_1"):
        (root / d).mkdir(parents=True)
    for t in range(4):
        il, ir, _ = synthetic.render_frame(world, t)
        for d, img in (("image_0", il), ("image_1", ir)):
            write_png(str(root / d / f"{t:06d}.png"), np.clip(img, 0, 255).astype(np.uint8),
                      filters=(0, 4))
    (root / "calib.txt").write_text("P0: 300 0 256 0 0 300 96 0 0 0 1 0\n"
                                    f"P1: 300 0 256 {-300 * 0.4} 0 300 96 0 0 0 1 0\n")
    est = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        out.mkdir()
        cli.main(["run", "--dataset", str(root), "--output-kitti", str(out / "est.txt"),
                  "--timing-output", str(out / "timing.json")]
                 + (["--device", "cpu"] if device == "cpu" else []))
        rep = json.loads((out / "timing.json").read_text())
        est[device] = traj_eval.read_kitti(str(out / "est.txt"))
        assert rep["run"]["device"].startswith(device)
        assert rep["run"]["kernel_launches"] == (
            {"K1": 4, "K2": 0, "K3": 0, "K4": 0} if device == "cuda"
            else {"K1": 0, "K2": 0, "K3": 0, "K4": 0})
    assert est["cuda"].shape == (4, 4, 4) and np.isfinite(est["cuda"]).all()
    assert np.abs(est["cuda"][:, :3, 3] - est["cpu"][:, :3, 3]).max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["k1", "staged"])
def test_split_chunk_front_end_on_the_card_matches_the_cpu(route):
    """frame.frontend_chunk over 4 frames at 192 x 512: one K1 launch at
    B = 8 (route k1) or one K2 launch at B = 8 (staged, 2 octaves), and
    every output equal to the CPU's; p_cam within rtol 1e-6."""
    _need_card()
    from vslam_tpu_torch.mapping import frame

    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512, device="cpu")
    world = synthetic.make_world(cam, n_frames=4, n_points=1500, seed=42, step=0.45)
    chunk = torch.from_numpy(np.stack([np.stack(synthetic.render_frame(world, t)[:2])
                                       for t in range(4)]).astype(np.uint8)).float()
    kw = dict(capacity=256, bin_size=16, border=20, want_planes=True,
              octaves=1 if route == "k1" else 2)
    outs = {}
    for device in ("cuda", "cpu"):
        fb.K1.batches.clear()
        db.K2.batches.clear()
        outs[device] = frame.frontend_chunk(cam_ops.to_device(cam, device), chunk.to(device),
                                            torch.tensor(15.0, device=device), **kw)
        if device == "cuda":
            assert (fb.K1.batches if route == "k1" else db.K2.batches) == {8: 1}
    (fg, *rest_g), (fc, *rest_c) = outs["cuda"], outs["cpu"]
    for name in ("uv4", "desc", "valid", "reliable", "track_len", "landmark_slot"):
        assert torch.equal(getattr(fg, name).cpu(), getattr(fc, name)), name
    torch.testing.assert_close(fg.p_cam.cpu(), fc.p_cam, rtol=1e-6, atol=0.0)
    for a, b in zip(rest_g, rest_c):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_fast_icp_on_the_card_matches_the_cpu():
    """A batch of 4 outlier-laden point-set problems through FAST-ICP:
    transforms within 1e-4 of the CPU's, inlier counts and verdicts equal."""
    _need_card()
    from vslam_tpu_torch.ops import lie
    from vslam_tpu_torch.solve import aligners, anderson, gn

    rng = np.random.default_rng(3)
    xi = (torch.tensor([[0.4, -0.2, 0.3, 0.05, -0.08, 0.12]])
          * torch.from_numpy(rng.uniform(0.2, 1.0, (4, 1)).astype(np.float32)))
    T = lie.exp_se3(xi).numpy()
    mov = rng.uniform(-5, 5, (4, 120, 3)).astype(np.float32)
    fix = np.einsum("bij,bnj->bni", T[:, :3, :3], mov) + T[:, None, :3, 3]
    fix[:, :20] += rng.uniform(3, 8, (4, 20, 3))
    cfg = gn.GNConfig(kernel_max_error=0.5, min_num_inliers=20)
    res = {}
    for device in ("cuda", "cpu"):
        data = aligners.ICPData(torch.from_numpy(mov).to(device),
                                torch.from_numpy(fix.astype(np.float32)).to(device),
                                torch.ones(4, 120, device=device))
        res[device] = anderson.fast_icp_align(data, torch.ones(4, 120, dtype=torch.bool,
                                                               device=device),
                                              torch.eye(4, device=device).repeat(4, 1, 1), cfg)
    torch.testing.assert_close(res["cuda"].x.cpu(), res["cpu"].x, rtol=0.0, atol=1e-4)
    assert torch.equal(res["cuda"].num_inliers.cpu(), res["cpu"].num_inliers)
    assert torch.equal(res["cuda"].converged.cpu(), res["cpu"].converged)
    assert bool(res["cpu"].converged.all())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["k1", "staged", "rgbd"])
def test_frame_program_equals_the_eager_step_on_the_card(route):
    """The FrameProgram (one captured CUDA graph a frame, replayed) and
    the eager fused.step side by side on the card from the same start, 12
    frames of a 192 x 512 circle: every state tensor equal bit for bit
    after every frame; the replays run under
    torch.cuda.set_sync_debug_mode("error"), so a synchronization inside
    a frame raises; each replay counts its capture's launches."""
    _need_card()
    from vslam_tpu_torch.tracking import fused
    from vslam_tpu_torch.tracking import tracker as ttracker

    dev = torch.device("cuda")
    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512)
    world = synthetic.make_world(cam, n_points=1500, seed=21,
                                 poses=synthetic.circle_trajectory(48, radius=7.0))
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 256
    if route == "staged":
        cfg.framepoint_generation.detector_number_of_octaves = 2
    if route == "rgbd":
        cfg.command_line.tracker_mode = "RGB_DEPTH"
        frames = [np.stack(synthetic.render_depth_frame(world, t)[:2]).astype(np.float32)
                  for t in range(12)]
    else:
        frames = [np.stack(synthetic.render_frame(world, t)[:2]).astype(np.uint8)
                  for t in range(12)]
    staged = torch.from_numpy(np.stack(frames)).to(dev)
    params = ttracker.params_from_config(cam, cfg, dev)
    eager = fused.init_state(cam, params, 8192, 20.0)
    prog = fused.FrameProgram(cam, params, fused.init_state(cam, params, 8192, 20.0),
                                 True, staged.dtype)
    counters = db.kernel_counters()
    for i, imgs in enumerate(staged):
        eager = fused.step(cam, params, eager, imgs, True)
        if i == 1:
            prog.capture()
        before = {k: c.launches for k, c in counters.items()}
        if i > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            prog.run(imgs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        made = {k: c.launches - before[k] for k, c in counters.items()}
        if i == 0:
            first = made
        assert made == first and sum(made.values()) >= 1, (i, made, first)
        for (name, a), (_, b) in zip(fused.state_tensors(eager), fused.state_tensors(prog.state)):
            assert torch.equal(a, b), (route, i, name)
    assert prog.graph is not None and int(prog.state.frame_idx) == 12


@pytest.mark.cuda
def test_track_program_equals_the_eager_tails_on_the_card():
    """The split front-end's route on the card: one 8-frame chunk's
    front-end, then the eager track_step and the TrackProgram's replays
    side by side, every state tensor equal after every frame, the replays
    under sync debug mode "error"."""
    _need_card()
    from vslam_tpu_torch.tracking import fused
    from vslam_tpu_torch.tracking import tracker as ttracker

    dev = torch.device("cuda")
    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512)
    world = synthetic.make_world(cam, n_points=1500, seed=21,
                                 poses=synthetic.circle_trajectory(48, radius=7.0))
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 256
    cfg.tracking.batch_frontend = True
    chunk = torch.from_numpy(np.stack([np.stack(synthetic.render_frame(world, t)[:2])
                                       for t in range(8)]).astype(np.uint8)).to(dev)
    params = ttracker.params_from_config(cam, cfg, dev)
    eager = fused.init_state(cam, params, 8192, 20.0)
    prog = fused.TrackProgram(cam, params, fused.init_state(cam, params, 8192, 20.0), True)
    imgs = fused._chunk_images(cam, params, chunk)
    front = fused.chunk_front_end(cam, params, eager.threshold.clone(), imgs)
    for i in range(8):
        eager = fused.track_step(cam, params, eager, *front, imgs, i, True)
        if i == 1:
            prog.capture()
        if i > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            prog.run(front, imgs, i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for (name, a), (_, b) in zip(fused.state_tensors(eager), fused.state_tensors(prog.state)):
            assert torch.equal(a, b), (i, name)
    assert prog.graph is not None


@pytest.mark.cuda
@pytest.mark.parametrize("odometry", [False, True])
def test_engine_process_reads_nothing_back_between_drains(odometry):
    """SlamEngine.process, the route of the CLI, on the card with the
    fused tracker (frames_per_chunk 8): after frame 1 (its capture), every
    frame but the drains (each 8th) runs under
    torch.cuda.set_sync_debug_mode("error") -- the frame's upload and its
    odometry guess (pinned memory, asynchronous copies), the replay and
    the engine's bookkeeping wait for nothing on the device.  The run
    keeps the same local maps as the same frames through
    process_prestaged."""
    _need_card()
    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512)
    n = 24
    world = synthetic.make_world(cam, n_points=1500, seed=21,
                                 poses=synthetic.circle_trajectory(48, radius=7.0))
    frames = [synthetic.render_frame(world, t)[:2] for t in range(n)]

    def engine():
        cfg = ParameterCollection()
        cfg.framepoint_generation.capacity = 256
        cfg.parallelism.frames_per_chunk = 8
        cfg.command_line.option_use_odometry = odometry
        return SlamEngine(cam, cfg, landmark_capacity=8192, device="cuda")

    eng = engine()
    assert eng.tracker.step_route == "graph"
    for i, (img_l, img_r) in enumerate(frames):
        T_odom = (np.linalg.inv(world.poses[i]) @ world.poses[max(i - 1, 0)]).astype(
            np.float32) if odometry else None
        if i >= 2 and (i + 1) % 8:
            torch.cuda.set_sync_debug_mode("error")
        try:
            eng.process(img_l, img_r, T_odom)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    eng._flush_tracker()
    assert eng.tracker.program.graph is not None
    traj = eng.trajectory
    assert traj.shape == (n, 4, 4) and np.all(np.isfinite(traj))
    if not odometry:
        ref = engine()
        for h in ref.tracker.prestage(frames):
            ref.process_prestaged(h)
        ref._flush_tracker()
        assert eng.report()["n_local_maps"] == ref.report()["n_local_maps"]
        np.testing.assert_array_equal(traj, ref.trajectory)


# ---------------------------------------------------------------------------
# Conditional nodes (ops/control.py, csrc/graph_cond.cu)
# ---------------------------------------------------------------------------

def _geometric_loop(x, target, max_iters):
    """control.while_loop over B problems: problem b runs target[b]
    rounds of x <- 0.9 A x + 1 (a batched product, cuBLAS on the body's
    stream, and fresh allocations a round)."""
    from vslam_tpu_torch.ops import control

    A = torch.eye(2, device=x.device) + torch.ones((2, 2), device=x.device).triu(1) * 0.5
    A = (A - A.triu(1).transpose(0, 1) * 0.5).expand(x.shape[0], 2, 2)

    def body(s):
        v, it = s
        return torch.bmm(A, v[..., None])[..., 0] * 0.9 + torch.ones_like(v), it + 1

    return control.while_loop(lambda s: s[1] < target, body,
                              (x, torch.zeros_like(target)), max_iters)


@pytest.mark.cuda
def test_while_node_runs_the_predicted_iterations():
    """One WHILE node: after each replay its round counter holds the
    largest per-problem target (capped), each problem's state equals the
    eager loop's (to the cap, frozen) bit for bit, and a replay with new
    targets decides the iterations anew; no sync inside a replay."""
    _need_card()
    from vslam_tpu_torch.ops import control

    x = torch.tensor([[1.0, 2.0], [0.5, -1.0], [3.0, 0.0]], device="cuda")
    target = torch.tensor([3, 7, 1], dtype=torch.int32, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with control.graph_capture(graph) as record:
        out, it = _geometric_loop(x, target, 12)
    for t in ([3, 7, 1], [0, 0, 0], [12, 40, 2], [5, 5, 5]):
        target.copy_(torch.tensor(t, dtype=torch.int32))
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want, want_it = _geometric_loop(x, target, 12)
        assert torch.equal(out, want) and torch.equal(it, want_it), t
        assert record.read() == [("while", None, min(max(t), 12))], t


@pytest.mark.cuda
def test_if_node_runs_only_its_taken_branch():
    """One cond: a replay runs the branch its predicate picks -- each
    branch also bumps its own in-place hit counter, so the other branch's
    counter shows it did not run -- and returns that branch's values."""
    _need_card()
    from vslam_tpu_torch.ops import control

    x = torch.arange(6, dtype=torch.float32, device="cuda")
    pred = torch.ones((), dtype=torch.bool, device="cuda")
    hits = torch.zeros(2, dtype=torch.int32, device="cuda")

    def branch(k, fn):
        def run(v):
            hits[k] += 1
            return fn(v), v.sum()
        return run

    graph = torch.cuda.CUDAGraph()
    with control.graph_capture(graph) as record:
        out, total = control.cond(pred, branch(0, lambda v: v * 2.0),
                                  branch(1, lambda v: v - 1.0), (x,))
    hits.zero_()
    for p, want_hits in ((True, [1, 0]), (False, [1, 1]), (False, [1, 2]), (True, [2, 2])):
        pred.fill_(p)
        graph.replay()
        assert hits.tolist() == want_hits, p
        assert torch.equal(out, x * 2.0 if p else x - 1.0) and float(total) == 15.0
        assert record.read() == [("if", None, int(p))]


@pytest.mark.cuda
def test_if_node_containing_a_while_node():
    """A WHILE node inside an IF node's body (nested conditional nodes):
    taken, the loop runs its rounds and the branch returns its state;
    not taken, the loop's counter stays 0 and the other branch's value
    comes out."""
    _need_card()
    from vslam_tpu_torch.ops import control

    x = torch.tensor([[1.0, 2.0], [0.5, -1.0]], device="cuda")
    target = torch.tensor([4, 2], dtype=torch.int32, device="cuda")
    pred = torch.ones((), dtype=torch.bool, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with control.graph_capture(graph) as record:
        out = control.cond(pred, lambda v: _geometric_loop(v, target, 10)[0],
                           lambda v: v + 100.0, (x,))
    for p, t in ((True, [4, 2]), (False, [4, 2]), (True, [1, 6])):
        pred.fill_(p)
        target.copy_(torch.tensor(t, dtype=torch.int32))
        graph.replay()
        want = _geometric_loop(x, target, 10)[0] if p else x + 100.0
        assert torch.equal(out, want), (p, t)
        values = record.read()
        assert values == [("if", None, int(p)), ("while", (0, True), max(t) if p else 0)]
        assert record.reached(values) == [True, p]


@pytest.mark.cuda
def test_captured_icp_batch_equals_its_eager_batch():
    """relocalizer.ICPProgram at bucket 8 on the card: its first use
    eager, then captured (two WHILE nodes) and replayed on new batches of
    5 and 8 problems: each replay bit-equal to the eager solve of the
    same padded batch, rows past the batch masked out."""
    _need_card()
    from vslam_tpu_torch.loop import relocalizer as rl
    from vslam_tpu_torch.ops import lie
    from vslam_tpu_torch.solve import aligners, gn

    cfg = gn.GNConfig(kernel_max_error=0.25, min_num_inliers=8, max_iterations=50)
    prog = rl.ICPProgram(aligners.icp_align, cfg, 8, 256, "cuda")
    rng = np.random.default_rng(4)
    for B in (5, 5, 8, 3):
        xi = torch.from_numpy((rng.normal(size=(B, 6)) * 0.1).astype(np.float32)).cuda()
        mov = torch.from_numpy(rng.uniform(-5, 5, (B, 256, 3)).astype(np.float32)).cuda()
        fix = lie.transform_points(lie.exp_se3(xi)[:, None], mov)
        fix = fix + torch.from_numpy(rng.normal(0, 0.05, (B, 256, 3)).astype(np.float32)).cuda()
        mask = torch.from_numpy(np.arange(256)[None] < rng.integers(40, 256, (B, 1))).cuda()
        T0 = torch.eye(4, device="cuda").repeat(B, 1, 1)
        got = prog.run(mov, fix, mask, T0)
        want = aligners.icp_align(aligners.ICPData(prog.mov, prog.fix, prog.weight), prog.mask,
                                  prog.T0, cfg)
        for name, a, b in zip(got._fields, got, want):
            assert torch.equal(a, b), (B, name)
        assert bool(got.converged[:B].all())
    assert prog.graph is not None and prog.uses == 4
    assert [kind for kind, _, _ in prog.record.read()] == ["while", "while"]


@pytest.mark.cuda
def test_engine_after_a_warm_engine_replays_from_its_first_frame():
    """bench.py's order on the card: an engine over the frames, the ICP
    warm-up, then a fresh engine of the same configuration.  The second
    engine replays the first one's captured program from its first frame
    (no eager frame, no capture) and gives its trajectory bit for bit."""
    _need_card()
    from vslam_tpu_torch.loop import relocalizer as rl
    from vslam_tpu_torch.tracking import fused

    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512, device="cpu")
    world = synthetic.make_world(cam, n_points=1500, seed=21,
                                 poses=synthetic.circle_trajectory(48, radius=7.0))
    frames = [synthetic.render_frame(world, t)[:2] for t in range(24)]
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 256
    cfg.parallelism.frames_per_chunk = 8
    fused.clear_programs()
    rl.clear_icp_programs()

    def run():
        eng = SlamEngine(cam, cfg, landmark_capacity=8192, device="cuda")
        for h in eng.tracker.prestage(frames):
            eng.process_prestaged(h)
        return eng, eng.trajectory

    warm, want = run()
    rl.warm_icp_batches(cfg.relocalization, device="cuda")
    assert all(p.graph is not None for p in rl._PROGRAMS.values())
    before = fused.EVENTS.copy()
    eng, got = run()
    assert eng.tracker.program is warm.tracker.program
    delta = fused.EVENTS - before
    assert delta["eager"] == 0 and delta["capture"] == 0 and delta["replay"] == len(frames)
    np.testing.assert_array_equal(got, want)


def _replays_its_eager_run(prog, inputs):
    """A StaticProgram's first run eager, its second a capture and replay
    bit-equal to it, a third replay bit-equal again and free of host
    synchronization (inputs on the card).  Returns the eager outputs."""
    from torch.utils import _pytree as pytree

    eager = prog.run(inputs)
    replayed = prog.run(inputs)
    assert prog.graph is not None and prog.uses == 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = prog.run(inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b, c in zip(*(pytree.tree_leaves(x) for x in (eager, replayed, again))):
        assert torch.equal(a, b) and torch.equal(b, c)
    return eager


def _drifted_junction_graph(P=48, n_clo=6, seed=5):
    """A 1.2-lap circle of P keyframes with drifting odometry and n_clo
    closures from the second lap onto the first, as the hierarchical
    solve's inputs (poses, odometry, weights, closures)."""
    from vslam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    a = np.linspace(0, 2.4 * np.pi, P)
    gt = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    gt[:, 0, 0] = gt[:, 2, 2] = np.cos(a)
    gt[:, 0, 2], gt[:, 2, 0] = np.sin(a), -np.sin(a)
    gt[:, 0, 3], gt[:, 2, 3] = 12 * np.cos(a), 12 * np.sin(a)
    drift = lie.exp_se3(torch.tensor(np.c_[1e-2 * (1 + 0.1 * rng.normal(size=(P - 1, 3))),
                                           np.zeros(P - 1), 5e-3 * np.ones(P - 1),
                                           np.zeros(P - 1)], dtype=torch.float32)).numpy()
    odo = np.linalg.inv(gt[:-1]) @ gt[1:] @ drift
    est = gt.copy()
    for k in range(P - 1):
        est[k + 1] = est[k] @ odo[k]
    lap = int(P / 1.2)
    clo = [(j - lap, j, np.linalg.inv(gt[j - lap]) @ gt[j])
           for j in range(lap + 1, P, max((P - lap - 1) // n_clo, 1))][:n_clo]
    return est, odo.astype(np.float32), np.ones(P - 1, np.float32), clo


@pytest.mark.cuda
@pytest.mark.parametrize("levenberg", [False, True])
def test_pose_graph_programs_replay_their_eager_solves(levenberg):
    """The junction solve at (64, 128) and the distribution at 512 poses:
    each captured, its replays bit-equal to its eager run and to each
    other, no host synchronization inside a replay; the hierarchical
    solve through them within 1e-5 of the same solve on the CPU; the
    warm-up leaves its programs captured (the JAX package's three
    problems land at Jp 64, 64 and 256: the middle one's closures compact
    to 25)."""
    _need_card()
    from vslam_tpu_torch.backend import pose_graph as pg

    est, odo, w, clo = _drifted_junction_graph()
    g, junc, J, _ = pg.junction_graph(est, odo, w, clo)
    pg.clear_programs()
    dev = lambda a: torch.as_tensor(a).cuda()  # noqa: E731
    prog = pg.junction_program(64, 128, 10, levenberg, "cuda")
    opt, _ = _replays_its_eager_run(prog, (pg.PoseGraph(*map(dev, g)), dev(np.float32(1.0))))
    corr = opt[:J].cpu().numpy() @ np.linalg.inv(est[junc])
    owner = np.minimum(np.arange(512) * (J - 1) // 48, J - 2)
    dist = pg.distribute_program(512, 64, "cuda")
    _replays_its_eager_run(dist, (dev(pg._padded(est, 512, np.eye(4, dtype=np.float32))),
                                  dev(pg._padded(corr.astype(np.float32), 64,
                                                 np.eye(4, dtype=np.float32))),
                                  dev(owner.astype(np.int64)),
                                  dev((np.arange(512) % 7 / 7).astype(np.float32))))
    got, chi2 = pg.optimize_pose_graph_hierarchical(est, odo, w, clo, levenberg=levenberg,
                                                    device="cuda")
    want, chi2_cpu = pg.optimize_pose_graph_hierarchical(est, odo, w, clo,
                                                         levenberg=levenberg, device="cpu")
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    assert abs(chi2 / chi2_cpu - 1) <= 1e-4
    pg.clear_programs()
    before = pg.EVENTS.copy()
    pg.warm_hierarchical_buckets(device="cuda")
    assert all(p.graph is not None for p in pg._PROGRAMS.values())
    assert {k[1] for k in pg._PROGRAMS if k[0] == "junction"} == {64, 256}
    delta = pg.EVENTS - before
    assert delta["capture"] == 2 and delta["distribute capture"] == 2


@pytest.mark.cuda
def test_ba_program_replays_its_eager_solve():
    """The windowed BA program at P 16, L 512: captured, its replays
    bit-equal to its eager solve and to each other, no host
    synchronization inside a replay, the padded solve's poses within
    1e-5 of the tight one's; warm_windowed_ba leaves the engine's
    program at L 2048 captured."""
    _need_card()
    from vslam_tpu_torch.backend import ba
    from vslam_tpu_torch.system import ba_runner

    cam, prob = _ba_problem("cuda")
    P, (L, O) = prob.T_wc.shape[0], prob.obs_cam.shape
    pad = lambda t, n, fill: torch.cat(  # noqa: E731
        [t, fill.expand((n - len(t),) + t.shape[1:]).to(t.dtype)])
    eye = torch.eye(4, device="cuda")
    zero = torch.zeros((), device="cuda")
    padded = prob._replace(
        T_wc=pad(prob.T_wc, 16, eye), xyz=pad(prob.xyz, 512, zero),
        obs_cam=pad(prob.obs_cam, 512, zero), obs_uv4=pad(prob.obs_uv4, 512, zero),
        obs_weight=pad(prob.obs_weight, 512, zero), obs_mask=pad(prob.obs_mask, 512, zero),
        lm_valid=pad(prob.lm_valid, 512, zero), cam_fixed=pad(prob.cam_fixed, 16, zero + 1),
        odo_T=pad(prob.odo_T, 16, eye),
        odo_weight=pad(prob.odo_weight[:P - 1], 16, zero))
    config = ba.BAConfig()
    ba.clear_programs()
    prog = ba.ba_program(cam, 16, 512, O, config, True, "cuda")
    T, X, _ = _replays_its_eager_run(prog, ((cam.K, cam.baseline_m), padded))
    Tt, Xt, _ = ba.bundle_adjust(cam, prob, config)
    assert (T[:P] - Tt).abs().max() <= 1e-5
    assert (X[:L] - Xt).abs().max() <= 1e-3

    cfg = ParameterCollection()
    cfg.graph_optimization.enable_full_bundle_adjustment = True
    eng = SlamEngine(cam, cfg, landmark_capacity=4096, device="cuda")
    before = ba.EVENTS.copy()
    ba_runner.warm_windowed_ba(eng)
    delta = ba.EVENTS - before
    assert delta == {"eager": 1, "capture": 1, "replay": 1}
    key = (ba_runner.WINDOW, 2048, ba_runner.OMAX, ba_runner.ba_config(eng), True,
           torch.device("cuda", torch.cuda.current_device()))
    assert ba._PROGRAMS[key].graph is not None


@pytest.mark.cuda
def test_fast_icp_program_replays_its_eager_batch():
    """relocalizer.ICPProgram with FAST-ICP at bucket 8: captured (the
    rotation fit and the mixing solve read nothing back), each replay
    bit-equal to the eager solve of the same padded batch, no host
    synchronization inside a replay, the verdicts the CPU's."""
    _need_card()
    from vslam_tpu_torch.loop import relocalizer as rl
    from vslam_tpu_torch.ops import lie
    from vslam_tpu_torch.solve import aligners, anderson, gn

    cfg = gn.GNConfig(kernel_max_error=0.25, min_num_inliers=8, max_iterations=50)
    prog = rl.ICPProgram(anderson.fast_icp_align, cfg, 8, 256, "cuda")
    rng = np.random.default_rng(4)
    for B in (5, 5, 8, 3):
        xi = torch.from_numpy((rng.normal(size=(B, 6)) * 0.1).astype(np.float32))
        mov = torch.from_numpy(rng.uniform(-5, 5, (B, 256, 3)).astype(np.float32))
        fix = lie.transform_points(lie.exp_se3(xi)[:, None], mov)
        fix = fix + torch.from_numpy(rng.normal(0, 0.05, (B, 256, 3)).astype(np.float32))
        mask = torch.from_numpy(np.arange(256)[None] < rng.integers(40, 256, (B, 1)))
        T0 = torch.eye(4).repeat(B, 1, 1)
        args = [t.cuda() for t in (mov, fix, mask, T0)]
        torch.cuda.synchronize()
        if prog.graph is not None:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = prog.run(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = prog.eager()
        for name, a, b in zip(got._fields, got, want):
            assert torch.equal(a, b), (B, name)
        cpu = anderson.fast_icp_align(aligners.ICPData(mov, fix, torch.ones(B, 256)), mask,
                                      T0, cfg)
        assert torch.equal(got.converged[:B].cpu(), cpu.converged)
        assert torch.equal(got.num_inliers[:B].cpu(), cpu.num_inliers)
    assert prog.graph is not None and prog.uses == 4


@pytest.mark.cuda
def test_capture_without_conditional_nodes_keeps_its_slots():
    """control.graph_capture zeroes its record slots at the start of every
    replay.  A program with no WHILE or IF node keeps them through its
    Record: after the capture's other references are gone, memory the
    allocator hands out next is not written by a replay."""
    _need_card()
    import gc

    from vslam_tpu_torch.ops import control

    x = torch.arange(16, dtype=torch.float32, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with control.graph_capture(graph, "cuda") as record:
        y = x * 2
    assert record.entries == [] and record.slots is not None
    gc.collect()
    held = [torch.full((control.MAX_SLOTS,), 7, dtype=torch.int32, device="cuda")
            for _ in range(8)]
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert all(bool((h == 7).all()) for h in held)
    assert torch.equal(y, x * 2)
