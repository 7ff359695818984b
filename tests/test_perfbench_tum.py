"""The benchmark's TUM RGB-D cell (proslam-tum.room1024) on the CPU:

  * the port's depth framepoints (mapping/frame.py process_depth_frame)
    against perfbench/rgbd_plain.py's framepoints, one keypoint at a time;
  * the port's UVD pose solve (solve/aligners.py uvd_align) against
    rgbd_plain.uvd_solve, and that solve in bfloat16 against the same
    tolerance;
  * the depth hand-off's card renderer (run on the CPU) against its numpy
    copy, and its intensity plane against generator.render_frames;
  * the office sweep's kinematics and room (worlds/room.py), and the
    cell's control (the truth held in bfloat16) caught by its limits;
  * the configuration against configurations/configuration_tum.yaml;
  * the tracker's three depth counters in short engine runs;
  * the two new per-layer readers on hand-built traced windows.

Tolerances:
  * framepoints: validity and depth exact (the same f32 pixel); points
    within 1e-6 m of the float64 reference (the port back-projects in
    float32: 4.8e-8 m at most on these maps; the same computation in
    bfloat16 lies 9e-3 m away or more, and fails it);
  * UVD pose: translation within 1e-5 m and rotation within 1e-4 deg of
    the float64 reference (measured: 1.5e-7 m and 8e-7 deg at most over
    the three kinds of problem); the same solve in bfloat16 lies 3e-3 m
    and 0.06 deg away or more, and fails both.
"""

import dataclasses
import os
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import (control, generator, profile, reference, rgbd_plain, spec, synthetic_np,
                       window)
from perfbench.handoffs import prestaged_depth
from perfbench.roofline import dense_brief
from perfbench.worlds import room
from vslam_tpu_torch.frontend import detect
from vslam_tpu_torch.mapping import frame as frame_mod
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.solve import aligners, gn

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELL = "proslam-tum.room1024"
BENCH = spec.load()
POINT_TOL_M = 1e-6
POSE_TOL_M = 1e-5
POSE_TOL_DEG = 1e-4
FX, FY, CX, CY = 517.3, 516.5, 318.6, 255.3


def _K(cam) -> torch.Tensor:
    return torch.tensor([[float(cam.fx), 0.0, float(cam.cx)],
                         [0.0, float(cam.fy), float(cam.cy)], [0.0, 0.0, 1.0]])


def _depth_map(g, H, W) -> torch.Tensor:
    """Random depths: 0.3-5 m, and a sixth of the pixels each holes (0),
    too near (0.05-0.3 m) and too far (5-8 m)."""
    kind = torch.randint(0, 6, (H, W), generator=g)
    u = torch.rand((H, W), generator=g)
    return torch.where(kind == 0, 0.0, torch.where(
        kind == 1, 0.05 + 0.25 * u, torch.where(kind == 2, 5.0 + 3.0 * u, 0.3 + 4.7 * u)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_framepoints_match_the_plain_reference(seed):
    """At 2 octaves the level-1 keypoints lie on pixel halves (r s + 1/2),
    where the nearest pixel is the even one."""
    H, W = 96, 128
    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (H, W), generator=g).to(torch.float32)
    depth = _depth_map(g, H, W)
    cam = cam_ops.make_camera(fx=150.0, fy=150.0, cx=64.0, cy=48.0, baseline_m=0.075,
                              rows=H, cols=W, device="cpu")
    thr = torch.tensor(20.0)
    frame, n_kp, n_fp = frame_mod.process_depth_frame(
        cam, img, depth, thr, 0.3, 5.0, capacity=192, bin_size=12, border=20, octaves=2)
    kp = detect.detect_keypoints(img, thr, 12, 192, 20, "FAST", octaves=2)
    uv = kp.uv[kp.valid]
    assert int(n_kp) == len(uv) > 40
    halves = (uv.frac() == 0.5).all(dim=1)
    assert int(halves.sum()) >= 5 and int((~halves).sum()) >= 5
    z, valid, p = rgbd_plain.framepoints(depth, uv, _K(cam), 0.3, 5.0)
    # Every kind of depth occurs: holes, too near, too far and good.
    assert (z == 0).any() and ((z > 0) & (z < 0.3)).any() and (z > 5.0).any() and valid.any()
    n = int(valid.sum())
    assert int(n_fp) == n and int(frame.valid.sum()) == n
    assert torch.equal(frame.uv4[:n, :2], uv[valid])
    assert torch.equal(frame.uv4[:n, 2].double(), z[valid])
    assert torch.equal(frame.reliable[:n], torch.ones(n, dtype=torch.bool))
    assert float((frame.p_cam[:n].double() - p[valid]).abs().max()) <= POINT_TOL_M
    p_bf16 = rgbd_plain.framepoints(depth, uv, _K(cam), 0.3, 5.0, dtype=torch.bfloat16)[2]
    assert float((p_bf16[valid].double() - p[valid]).abs().max()) > 100 * POINT_TOL_M


def test_framepoints_round_half_to_even_and_refuse_outside_points():
    depth = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    K = torch.eye(3)
    z, valid, p = rgbd_plain.framepoints(depth, torch.tensor([[0.5, 0.5], [1.5, 1.5],
                                                              [2.5, 0.0]]), K, 0.0, 100.0)
    assert z.tolist() == [0.0, 10.0, 2.0]
    assert torch.equal(p[1], torch.tensor([15.0, 15.0, 10.0], dtype=torch.float64))
    with pytest.raises(ValueError):
        rgbd_plain.framepoints(depth, torch.tensor([[3.6, 1.0]]), K, 0.0, 100.0)


def _uvd_problem(kind: str, seed: int, N: int = 600):
    """Points 1-5 m ahead seen after a known motion; `noisy` adds 0.5 px
    and 1% of depth, `outliers` moves 15% of the measurements by up to 20
    px and leaves a fifth of the depths unmeasured (0)."""
    cam = cam_ops.make_camera(fx=FX, fy=FY, cx=CX, cy=CY, baseline_m=0.075, rows=480,
                              cols=640, device="cpu")
    g = torch.Generator().manual_seed(100 + seed)
    uv = torch.rand(N, 2, generator=g) * torch.tensor([600.0, 440.0]) + 20
    p = cam_ops.back_project(cam, uv, 1.0 + 4.0 * torch.rand(N, generator=g))
    T = rgbd_plain.exp_se3(torch.tensor([0.01, -0.005, 0.012, 0.01, -0.02, 0.005],
                                        dtype=torch.float64)).float()
    uv_m, z_m = cam_ops.project(cam, p @ T[:3, :3].T + T[:3, 3])
    meas = torch.cat([uv_m, z_m[:, None]], 1)
    if kind != "clean":
        meas[:, :2] += 0.5 * torch.randn(N, 2, generator=g)
        meas[:, 2] += 0.01 * meas[:, 2] * torch.randn(N, generator=g)
    if kind == "outliers":
        out = torch.rand(N, generator=g) < 0.15
        meas[out, :2] += 40 * (torch.rand(int(out.sum()), 2, generator=g) - 0.5)
        meas[torch.rand(N, generator=g) < 0.2, 2] = 0.0
    weight = 1 + torch.rand(N, generator=g)
    mask = torch.rand(N, generator=g) > 0.05
    return cam, p, meas, weight, meas[:, 2] > 0.01, mask


def _pose_gap(A, B) -> tuple[float, float]:
    t, r = reference.relative_gap(A.double().numpy(), B.double().numpy())
    return float(t), float(r)


@pytest.mark.parametrize("kind,seed", [("clean", 0), ("noisy", 1), ("outliers", 2)])
def test_uvd_align_matches_the_plain_solve(kind, seed):
    cam, p, meas, weight, reliable, mask = _uvd_problem(kind, seed)
    data = aligners.UVDData(p_prev=p, meas=meas, weight=weight, depth_reliable=reliable)
    res = aligners.uvd_align(cam, data, mask, torch.eye(4), gn.GNConfig())
    T, inliers, converged = rgbd_plain.uvd_solve(_K(cam), p, meas, weight, reliable, mask,
                                                 torch.eye(4))
    assert bool(res.converged) and converged
    assert torch.equal(res.inlier_mask, inliers)
    if kind == "outliers":
        assert int(inliers.sum()) < int(mask.sum()) - 50
    t, r = _pose_gap(res.x, T)
    assert t <= POSE_TOL_M and r <= POSE_TOL_DEG, (t, r)


def test_uvd_tolerance_fails_bfloat16():
    cam, p, meas, weight, reliable, mask = _uvd_problem("noisy", 1)
    args = (_K(cam), p, meas, weight, reliable, mask, torch.eye(4))
    t, r = _pose_gap(rgbd_plain.uvd_solve(*args, dtype=torch.bfloat16)[0],
                     rgbd_plain.uvd_solve(*args)[0])
    assert t > 100 * POSE_TOL_M and r > 100 * POSE_TOL_DEG


def _small_room(seed=5, frames=12):
    """A 96x128 camera over room1024's sweep, 1,500 points."""
    params = dict(generator.load_traffic(spec.traffic_path("room1024")).params,
                  frames=frames, n_points=1500, episode_frames=frames, trace_start=0,
                  trace_frames=0)
    cam = synthetic_np.Camera(FX / 5, FY / 5, CX / 5, CY / 5, 0.075, 96, 128)
    return room.make_world(generator.traffic("small", params), cam, seed)


def test_depth_render_matches_its_numpy_copy_and_the_generator():
    world = _small_room()
    n = generator.RENDER_BATCH + 2  # a whole batch and a part of one
    frames = prestaged_depth.render_frames(world, n, "cpu")
    plain = generator.render_frames(world, n, "cpu", torch.float32)
    assert frames.dtype == torch.float32 and frames.shape == (n, 2, 96, 128)
    assert torch.equal(frames[:, 0], plain[:, 0])
    for t in range(n):
        img, depth = prestaged_depth.render_frame(world, t)
        assert np.array_equal(frames[t, 0].numpy(), img)
        assert np.array_equal(frames[t, 1].numpy(), depth)
    # Depth where a patch won the pixel, 0 on the background, and every
    # depth one of the frame's point depths (a wall square to the optical
    # axis shows one depth: the frames turn across it).
    shown = set()
    for t in range(n):
        d = frames[t, 1]
        z = synthetic_np.camera_points(world, t)[:, 2]
        vals = torch.unique(d[d > 0]).numpy()
        assert (d == 0).any() and np.isin(vals, z).all()
        assert torch.equal(d == 0, frames[t, 0] == torch.from_numpy(world.background))
        shown.update(vals.tolist())
    assert len(shown) > 20


def test_sweep_kinematics():
    p = generator.load_traffic(spec.traffic_path("room1024")).params
    # The truth is given in the first camera's frame, as the engine's
    # trajectory starts; the sweep's shape is read in the room's.
    W = room.trajectory(p).astype(np.float64)
    assert np.allclose(W[0], np.eye(4), atol=1e-6)
    T = room.first_pose(p) @ W
    assert np.allclose(T, room.room_poses(p), atol=1e-5)
    rate = float(p["rate_hz"])
    assert len(T) == 1024 == int(p["episode_frames"])
    pos = T[:, :3, 3]
    along = np.linalg.norm(np.diff(pos[:, [0, 2]], axis=0), axis=1) * rate
    assert along.mean() == pytest.approx(0.334, rel=0.03)
    R = T[:, :3, :3]
    turn = reference._angle_deg(np.einsum("nji,njk->nik", R[:-1], R[1:]))
    assert (turn * rate).mean() == pytest.approx(29.9, rel=0.03)
    ext = np.ptp(pos, axis=0)
    assert ext[0] == pytest.approx(2.54, abs=0.01) and ext[2] == pytest.approx(2.19, abs=0.01)
    assert ext[1] == pytest.approx(0.53, abs=0.01)
    # One lap of the ellipse closes it: the path comes back to its start.
    lap_s = room.perimeter(p) / float(p["speed_m_s"])
    back = room.positions(p, np.array([0.0, lap_s]))
    assert np.abs(back[0, [0, 2]] - back[1, [0, 2]]).max() < 1e-6
    assert 1.5 < 1024 / rate / lap_s < 1.56
    for R in T[:, :3, :3]:
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_room_fixed_textures_from_the_seed():
    cam = window.load_config(spec.config_path(BENCH, "proslam-tum")).camera
    traffic = generator.load_traffic(spec.traffic_path("room1024"))
    a, b = room.make_world(traffic, cam, 7), room.make_world(traffic, cam, 2**31 + 9)
    assert np.array_equal(a.points_w, b.points_w) and not np.array_equal(a.textures, b.textures)
    assert a.points_w.shape == (8000, 3) and a.background.shape == (480, 640)
    # Every point lies on a face of the 6.0 x 5.0 x 2.6 m room (points in
    # the first camera's frame, f32: within 1e-6 m of the room's).
    T = room.first_pose(traffic.params)
    x, y, z = (a.points_w.astype(np.float64) @ T[:3, :3].T + T[:3, 3]).T
    on = ((np.abs(np.abs(x) - 3.0) < 1e-6) | (np.abs(np.abs(z) - 2.5) < 1e-6)
          | (np.abs(y - 1.3) < 1e-6) | (np.abs(y + 1.3) < 1e-6))
    assert on.all() and np.abs(x).max() <= 3.0 + 1e-6 and np.abs(z).max() <= 2.5 + 1e-6


def test_control_is_caught_by_track_m():
    """The control, in the first camera's frame (the one the program
    holds its poses in), fails the cell by track_m; track_deg is held
    from the sound runs alone (PERF.md section 2) and does not catch it."""
    w = spec.cell(BENCH, CELL)
    config = window.load_config(spec.config_path(BENCH, w["config"]))
    traffic = generator.load_traffic(spec.traffic_path(w["traffic"]))
    out = control.control_run(config, traffic, 2**31 + 11, spec.limits(CELL))
    failed = {k for k, c in out["checks"].items() if not c["value"] <= c["limit"]}
    assert not out["correct"] and failed == {"track_m"}, out
    assert out["checks"]["track_m"]["value"] > 1.5 * out["checks"]["track_m"]["limit"]


def test_config_is_the_tum_yaml_whole():
    yaml = pytest.importorskip("yaml")
    src = ROOT / "configurations" / "configuration_tum.yaml"
    c = window.load_config(spec.config_path(BENCH, "proslam-tum"))
    assert c.raw["proslam"] == yaml.safe_load(src.read_text())
    cfg = window.parameter_collection(c)
    assert len(cfg.explicit_keys) == len(c.settings)
    fp = cfg.framepoint_generation
    assert cfg.command_line.tracker_mode == "RGB_DEPTH"
    assert (fp.descriptor_type, fp.detector_number_of_octaves, fp.capacity,
            fp.bin_size_pixels) == ("BRIEF256", 1, 1024, 12)
    assert (fp.minimum_depth_meters, fp.maximum_depth_meters) == (0.3, 5.0)
    assert cfg.tracking.use_fused_tracker and int(cfg.parallelism.frames_per_chunk) == 32
    assert not cfg.graph_optimization.enable_full_bundle_adjustment
    assert (c.camera.rows, c.camera.cols, c.camera.fx, c.camera.cy) == (480, 640, 517.3, 255.3)
    entry = next(e for e in BENCH["configs"] if e["name"] == "proslam-tum")
    assert entry["reduced"] == []
    assert spec.cell(BENCH, CELL)["chips"] == 1


@pytest.mark.parametrize("mode", ["RGB_DEPTH", "RGB_STEREO"])
def test_depth_counters(mode, monkeypatch):
    """The counters the tracker adds at each drain equal the keypoints and
    framepoints process_depth_frame returned and the landmarks
    recover_lost_landmarks_depth re-acquired (RGB-D), and stay 0 on
    BRIEF256 stereo."""
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.system.engine import SlamEngine
    from vslam_tpu_torch.tracking import fused

    seen = Counter()
    front, recover = frame_mod.process_depth_frame, frame_mod.recover_lost_landmarks_depth

    def counted_front(*args, **kwargs):
        out = front(*args, **kwargs)
        seen["depth keypoints"] += int(out[1])
        seen["depth framepoints"] += int(out[2])
        return out

    def counted_recover(*args, **kwargs):
        out = recover(*args, **kwargs)
        seen["depth recovered"] += int(out[1])
        return out

    monkeypatch.setattr(frame_mod, "process_depth_frame", counted_front)
    monkeypatch.setattr(frame_mod, "recover_lost_landmarks_depth", counted_recover)
    world = _small_room(seed=3, frames=8)
    world = dataclasses.replace(world, cam=dataclasses.replace(world.cam, rows=96, cols=128))
    c = world.cam
    cam = cam_ops.make_camera(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, baseline_m=0.3, rows=c.rows,
                              cols=c.cols, device="cpu")
    cfg = ParameterCollection()
    cfg.command_line.tracker_mode = mode
    cfg.command_line.option_disable_relocalization = True
    fp = cfg.framepoint_generation
    fp.capacity, fp.bin_size_pixels, fp.border_pixels = 128, 8, 16
    keys = ("depth keypoints", "depth framepoints", "depth recovered")
    before = {k: fused.EVENTS[k] for k in keys}
    eng = SlamEngine(cam, cfg, landmark_capacity=2048, device="cpu")
    for t in range(8):
        img, depth = prestaged_depth.render_frame(world, t)
        eng.process(img, depth if mode == "RGB_DEPTH" else synthetic_np.render_frame(world, t)[1])
    eng.trajectory  # noqa: B018 -- the final drain
    got = {k: fused.EVENTS[k] - before[k] for k in keys}
    if mode == "RGB_DEPTH":
        assert got == {k: seen[k] for k in keys}
        assert got["depth framepoints"] > 0
        assert got["depth keypoints"] == eng.tracker.stats.n_keypoints
        assert got["depth recovered"] == eng.tracker.stats.n_recovered
    else:
        assert got == dict.fromkeys(keys, 0) and not seen


def _window(k3_per_frame: int, frames: int = 2, table: int = 0,
            events=None) -> window.Window:
    kernels = []
    for _ in range(frames):
        kernels += [(f"void dense_brief_kernel<8, float, {table}>(float const*, int, int, int, "
                     "int*)", 0, 25_000)] * k3_per_frame
        kernels += [("fast_cells_kernel", 0, 20_000), ("box_blur_kernel", 0, 10_000)]
    w = window.Window(cell=CELL, shape=(480, 640), octaves=1, frames=64,
                      events=Counter(events if events is not None else
                                     {"depth keypoints": 64_000, "depth framepoints": 57_600}))
    w.trace = profile.Slice(frames=frames, window_s=0.02, busy_s=0.01, kernels=kernels,
                            device_ops=kernels, cpu=[])
    return w


@pytest.mark.parametrize("launches,table", [(1, 0), (0, 0), (2, 0), (1, 5)])
def test_rgbd_roofline_reader(launches, table):
    val = spec.reader("rgbd_dense_brief_roofline")(_window(launches, table=table))
    if (launches, table) != (1, 0):
        assert val is None
    else:
        # One 25 us launch a frame against the (1, 480, 640) bound.
        assert val == pytest.approx(100 * dense_brief.least_seconds(1, 480, 640) / 25e-6,
                                    rel=1e-9)
        assert 0 < val < 100


def test_depth_valid_reader_needs_the_counters():
    read = spec.reader("front_end.depth_valid_pct")
    assert read(_window(1)) == pytest.approx(90.0)
    assert read(_window(1, events={})) is None
    assert read(_window(1, events={"rotated keypoints": 5})) is None
