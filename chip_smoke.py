"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then non-zero):
  1. device  — require CUDA; print torch / CUDA versions and the card's
               name and power limit (nvidia-smi);
  2. build   — compile K1 (csrc/fast_brief_frontend.cu) and the dense
               BRIEF kernel behind K2/K3/K4 (csrc/dense_brief.cu) with
               nvcc, both builds started together (their wall time);
               registers and spills (ptxas), resident blocks per SM
               (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the
               shared loads of one pixel (cuobjdump -sass, null with the
               reason where the toolkit has no cuobjdump);
  3. K1      — kernel vs its plain-torch version on the card at 376x1241,
               B=2, on a rendered synthetic pair and a uniform-random pair
               (both uint8-valued), FAST thresholds {5, 18, 40, 100}, arc
               lengths 9 and 12: all four outputs bit-equal over the whole
               image; one case also against the plain version on the CPU;
               median kernel times warm and with L2 flushed, the plain
               version's, the roofline bound and the shared-load floor;
  4. dense   — K2 at B=2 x 376x1241, K3 at 188x620 and at RGB-D's 480x640
               (f32 intensity, not uint8-valued) and K4 at 480x752 for all
               16 banks, each on box-blurred rendered images and a
               uniform-random pair: bit-equal to the plain version over
               the whole image; one case against the CPU; times as for K1
               (K3 at both shapes);
  5. K2'     — the band-size / input-type probe: the same kernel at
               (64, 376, 1241) with 8-, 16-, 32- and 64-row bands, f32 and
               bf16 input, each bit-equal to its plain version; times;
  6. slices  — SlamEngine in open-loop mode on the card, each run with
               every launch count set to 0 just before it and read just
               after:
               a. K1 slice: 128 frames of a 13 m-radius circle at KITTI
                  resolution with the bench's settings; 128 K1 launches,
                  0 breaks, ATE <= 0.05 m, 36-48 local maps;
               b. configuration_kitti.yaml (2 octaves, BRIEF256) on a
                  64-frame 13 m circle; K2 64, K3 128, K1 and K4 0
                  launches, 0 breaks, ATE <= 0.05 m, 14-18 local maps;
               c. configuration_euroc.yaml (BRIEF256R) at EuRoC's 752x480
                  and intrinsics on a 32-frame 4 m circle; K4 32 and K2 1
                  launches per frame, K1 and K3 0, 0 breaks, ATE <= 0.05 m,
                  13-17 local maps;
               each slice's first frames (8, 8, 4) agree with the same
               engine on the CPU within 1e-3 m;
  7. closed  — SlamEngine in closed-loop mode (relocalization, closure
               ICP, pose graph, landmark merging; BA off), the workload
               bench.py times for the JAX engine: the K1 slice's 128
               frames through tracker.prestage + process_prestaged, launch
               counts zeroed just before and read just after; 128 K1 and
               no K2/K3/K4 launches, 0 breaks, ATE <= 0.05 m, 36-48 local
               maps, >= 1 closure, >= 1 optimization, > 0 merged
               landmarks; prints the JAX engine's counts on a CPU for the
               same workload beside the card's, ms/frame, peak device
               memory, database rows and the closure stages' timings;
  8. ba-closed — bench.py's BA-enabled run: phase 7 with windowed bundle
               adjustment every 48 frames; the same checks plus >= 1 BA
               run; prints each BA problem's (P, L) and the BA stage's
               seconds and calls beside the JAX engine's counts;
  9. tum-config — configurations/configuration_tum.yaml as shipped (RGB-D,
               closed loop) at TUM fr1's 640x480 and intrinsics on a
               64-frame circle rendered as (intensity, depth) with the
               world scaled by 1/10; 64 K3 launches and no K1/K2/K4, 0
               breaks, ATE <= 0.05 m, local maps within +-15% of the JAX
               engine's on a CPU; the first 4 frames agree with the CPU
               within 1e-3 m.
The JAX counts printed beside phases 7-9 come from
chip_smoke_jax_reference.py.  The script then prints the kernel record
(one JSON line: launches summed over the runs of phases 6-9,
bit-equality, times, bound, share of the bound, shared-load floor,
blocks per SM, loads a pixel; K3's times at 480x640), the card's name
and power limit (nvidia-smi), and last {"ok": true, "device": {...}}.
Kernel times are CUDA-event medians of the kernel alone (the card is kept
busy while the host enqueues it; vslam_tpu_torch/frontend/kernel_timing.py).
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_FRAMES = 128
RADIUS_M = 13.0
ATE_LIMIT_M = 0.05
LOCAL_MAPS = (36, 48)
CPU_CHECK_FRAMES = 8
TUM_CPU_FRAMES = 4
CPU_CHECK_TOL_M = 1e-3
KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22, baseline_m=0.5372,
                 rows=376, cols=1241)
# EuRoC MAV cam0 intrinsics and the cam0-cam1 baseline (the dataset's
# sensor.yaml files).
EUROC_CAM = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, baseline_m=0.110,
                 rows=480, cols=752)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed(kernel, plain, work, pixels, taps, card, label):
    """The kernel's warm and L2-cold medians, the plain version's, and
    the bound and floor they are held to, printed and returned."""
    from vslam_tpu_torch.frontend import kernel_timing as kt

    rec = {"ms": kt.cuda_ms(kernel), "ms_l2_cold": kt.cuda_ms(kernel, setup=kt.l2_flush("cuda")),
           "plain_ms": kt.cuda_ms(plain)}
    rec["bound_ms"], rec["bound_by"] = kt.bound(*work)
    rec["roofline_share"] = rec["bound_ms"] / rec["ms_l2_cold"]
    rec["smem_floor_ms"] = kt.smem_floor_ms(pixels, taps)
    print(f"{label}: kernel {rec['ms']:.4f} ms warm, {rec['ms_l2_cold']:.4f} ms with L2 "
          f"flushed; plain version {rec['plain_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}), {100 * rec['roofline_share']:.1f}% of it; shared-load "
          f"floor {rec['smem_floor_ms']:.4f} ms at {taps} taps a pixel ({card})")
    return rec


# TUM RGB-D Freiburg 1 (the dataset's published fr1 calibration).
TUM_CAM = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, baseline_m=0.075, rows=480,
               cols=640)
TUM_FRAMES = 64
TUM_RADIUS_M = 3.5  # of the scaled world (see tum_world)
TUM_SCALE = 10.0  # the world is rendered at 10x and its depth divided back
BA_EVERY_FRAMES = 48

# The JAX engine (vslam_tpu) on a CPU for the closed-loop workloads of
# phases 7-9 (chip_smoke_jax_reference.py); it drains every frame, the
# port on the card every 32.
JAX_CPU_CLOSED_LOOP = {"n_local_maps": 42, "n_closures": 3, "n_optimizations": 1,
                       "n_merged_landmarks": 82, "n_track_breaks": 0, "ate_m": 0.0351,
                       "db_rows": 7242, "closures": [(39, 0), (40, 0), (41, 0)]}
JAX_CPU_BA_CLOSED = {"n_local_maps": 42, "n_closures": 3, "n_optimizations": 1,
                     "n_merged_landmarks": 82, "n_track_breaks": 0, "n_ba_runs": 2,
                     "ate_m": 0.0422, "db_rows": 7242, "closures": [(39, 0), (40, 0), (41, 0)]}
JAX_CPU_TUM = {"n_local_maps": 21, "n_closures": 0, "n_optimizations": 0,
               "n_merged_landmarks": 0, "n_track_breaks": 0, "ate_m": 0.0108, "db_rows": 5435}
CLOSURE_STAGES = ("relocalization", "reloc_vote_icp", "pose_graph_optimization",
                  "pg_solve", "pg_propagate", "landmark_merging")


def bench_config(parameter_collection):
    """The bench's configuration, open loop, as an instance of the given
    ParameterCollection class (the port's, or the JAX package's for
    chip_smoke_jax_reference.py)."""
    cfg = parameter_collection()
    cfg.framepoint_generation.capacity = 1024
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.world_map.minimum_distance_traveled_for_local_map = 1.5
    cfg.world_map.minimum_number_of_frames_for_local_map = 3
    cfg.local_map.maximum_number_of_landmarks = 512
    cfg.parallelism.frames_per_chunk = 32
    cfg.graph_optimization.enable_full_bundle_adjustment = False
    cfg.command_line.option_disable_relocalization = True
    return cfg


def bench_world(cam):
    """The bench's world (7000 points, seed 0) on the 128-frame circle and
    its stereo frames."""
    from vslam_tpu_torch.io import synthetic

    poses = synthetic.circle_trajectory(N_FRAMES, radius=RADIUS_M)
    world = synthetic.make_world(cam, n_points=7000, seed=0, poses=poses)
    return world, [synthetic.render_frame(world, t)[:2] for t in range(N_FRAMES)]


def bench_setup():
    """The bench's camera, configuration (open loop) and 128-frame circle."""
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.ops import camera as cam_ops

    cam = cam_ops.make_camera(**KITTI_CAM)
    world, frames = bench_world(cam)
    return cam, bench_config(ParameterCollection), world, frames


def tum_world(cam):
    """Phase 9's sequence: a 64-frame circle rendered as RGB-D frames
    (intensity, depth in meters), with the world -- points and pose
    translations -- scaled by 1/10 so that the depths fall in TUM's
    indoor range (0.3-4.5 m for the world's 3-45 m offsets).  Scaling a
    world leaves its images as they are, so each frame is rendered from
    the unscaled world and its depth divided by 10.  The circle's radius
    is 3.5 m: on circles of 1.3 m and 2.5 m the shipped configuration's
    closure ICP (its default 1 m kernel, 25 inliers at ratio 0.4) accepts
    a false closure across the circle from chance descriptor matches, in
    the JAX engine as in the port (ATE 0.77 m at 1.3 m).  Returns
    (ground-truth poses, frames)."""
    from vslam_tpu_torch.io import synthetic

    poses = synthetic.circle_trajectory(TUM_FRAMES, radius=TUM_RADIUS_M * TUM_SCALE)
    world = synthetic.make_world(cam, n_points=7000, seed=0, poses=poses)
    frames = []
    for t in range(TUM_FRAMES):
        img, depth = synthetic.render_depth_frame(world, t)
        frames.append((img, depth / np.float32(TUM_SCALE)))
    gt = poses.copy()
    gt[:, :3, 3] /= TUM_SCALE
    return gt, frames


def counters():
    """The launch counter of each kernel wrapper, by kernel."""
    from vslam_tpu_torch.frontend import dense_brief as db
    from vslam_tpu_torch.frontend import fast_brief as fb

    return {"K1": fb.K1, "K2": db.K2, "K3": db.K3, "K4": db.K4}


def reset_counts():
    for c in counters().values():
        c.launches = 0


def read_counts() -> dict:
    return {k: c.launches for k, c in counters().items()}


def phase_k1(frames, card):
    from vslam_tpu_torch.frontend import fast_brief as fb
    from vslam_tpu_torch.frontend import kernel_timing as kt

    rng = np.random.default_rng(0)
    pairs = {
        "synthetic": np.stack(frames[0]).astype(np.uint8).astype(np.float32),
        "uniform": rng.integers(0, 256, (2, 376, 1241)).astype(np.float32),
    }
    max_err = 0.0
    n_cases = 0
    for name, pair in pairs.items():
        imgs = torch.from_numpy(pair).cuda()
        for arc in (9, 12):
            for thr in (5.0, 18.0, 40.0, 100.0):
                t = torch.tensor(thr, device="cuda")
                got = fb.fast_brief_frontend_pair(imgs, t, arc_len=arc)
                ref = fb.fast_brief_frontend_pair_reference(imgs, t, arc_len=arc)
                torch.cuda.synchronize()
                for label, a, b in zip(("planes", "score", "rowmax", "rowarg"), got, ref):
                    if a.shape != b.shape or not torch.equal(a, b):
                        diff = (a.double() - b.double()).abs().max().item() \
                            if a.shape == b.shape else float("inf")
                        raise AssertionError(
                            f"K1 {label} differs from the plain version "
                            f"({name}, arc {arc}, threshold {thr}): max |diff| {diff}")
                    max_err = max(max_err, (a.double() - b.double()).abs().max().item())
                n_cases += 1
    # One case against the plain version on the CPU.
    imgs = torch.from_numpy(pairs["synthetic"])
    t = torch.tensor(18.0)
    got = fb.fast_brief_frontend_pair(imgs.cuda(), t.cuda())
    cpu = fb.fast_brief_frontend_pair(imgs, t)
    for a, b in zip(got, cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("K1 on the card differs from the plain version on the CPU")
    print(f"[k1] bit-equal to the plain version over the whole image in {n_cases} "
          "cases (2 pairs x 2 arc lengths x 4 thresholds) + 1 case against the CPU")

    imgs = torch.from_numpy(pairs["synthetic"]).cuda()
    t = torch.tensor(18.0, device="cuda")
    rec = timed(lambda: fb.fast_brief_frontend_pair(imgs, t),
                lambda: fb.fast_brief_frontend_pair_reference(imgs, t),
                kt.k1_work(*imgs.shape), imgs.numel(), kt.distinct_taps(fb.PATTERN), card,
                "[k1] median over 20 runs at 2x376x1241")
    return {"max_abs_err": max_err, "shape": "x".join(map(str, imgs.shape)), **rec}


def _require_equal(label, got, ref):
    if got.shape != ref.shape or not torch.equal(got, ref):
        n = int((got != ref).sum()) if got.shape == ref.shape else -1
        raise AssertionError(f"{label}: kernel differs from its plain version "
                             f"({n} words differ, shapes {tuple(got.shape)} / "
                             f"{tuple(ref.shape)})")
    return (got.double() - ref.double()).abs().max().item()


def phase_dense(kitti_frame, card):
    """K2, K3 and K4 against their plain version, whole image, bit-equal."""
    from vslam_tpu_torch.frontend import dense_brief as db
    from vslam_tpu_torch.frontend import detect, orb
    from vslam_tpu_torch.frontend import kernel_timing as kt
    from vslam_tpu_torch.io import synthetic
    from vslam_tpu_torch.ops import camera as cam_ops

    rng = np.random.default_rng(1)
    ecam = cam_ops.make_camera(**EUROC_CAM)
    eworld = synthetic.make_world(ecam, n_points=7000, seed=0,
                                  poses=synthetic.circle_trajectory(32, radius=4.0))

    def on_card(img):
        return torch.from_numpy(np.asarray(img).astype(np.uint8).astype(np.float32)).cuda()

    kitti = torch.stack([orb.box_blur(on_card(im), 2) for im in kitti_frame])
    level1 = torch.stack([orb.box_blur(detect.downsample2(on_card(im)), 2)
                          for im in kitti_frame])
    euroc = torch.stack([orb.box_blur(on_card(im), 2)
                         for im in synthetic.render_frame(eworld, 0)[:2]])
    # RGB-D's intensity image stays f32 (no uint8 cast): phase 9's first frame.
    tcam = cam_ops.make_camera(**TUM_CAM)
    tworld = synthetic.make_world(tcam, n_points=7000, seed=0, poses=synthetic.circle_trajectory(
        TUM_FRAMES, radius=TUM_RADIUS_M * TUM_SCALE))
    tum = orb.box_blur(torch.from_numpy(synthetic.render_frame(tworld, 0)[0]).cuda(), 2)[None]
    cases = {
        "K2": [kitti, torch.from_numpy(rng.uniform(0, 256, (2, 376, 1241))
                                       .astype(np.float32)).cuda()],
        "K3": [level1, tum, torch.from_numpy(rng.uniform(0, 256, (2, 188, 620))
                                             .astype(np.float32)).cuda()],
        "K4": [euroc, torch.from_numpy(rng.uniform(0, 256, (2, 480, 752))
                                       .astype(np.float32)).cuda()],
    }
    out = {}
    for name, stacks in cases.items():
        err = 0.0
        n_cases = 0
        for sm in stacks:
            if name == "K2":
                err = max(err, _require_equal(name, db.dense_bit_planes_batch(sm),
                                              db.dense_bit_planes_reference(sm)))
                n_cases += 1
                continue
            for img in sm:
                if name == "K3":
                    got = db.dense_bit_planes(img)
                    ref = db.dense_bit_planes_reference(img[None])[0]
                    err = max(err, _require_equal(name, got, ref))
                    n_cases += 1
                    continue
                for bank in range(db.N_ROT_BANKS):
                    got = db.dense_bit_planes_pattern(img, bank)
                    ref = db.dense_bit_planes_reference(img[None], 1 + bank)[0]
                    err = max(err, _require_equal(f"K4 bank {bank}", got, ref))
                    n_cases += 1
        torch.cuda.synchronize()
        out[name] = {"max_abs_err": err}
        print(f"[dense] {name} bit-equal to the plain version over the whole image "
              f"in {n_cases} cases (rendered + uniform-random, "
              f"{', '.join(str(tuple(x.shape)) for x in stacks)})")
    # One case against the plain version on the CPU.
    got = db.dense_bit_planes_batch(kitti).cpu()
    if not torch.equal(got, db.dense_bit_planes_batch(kitti.cpu())):
        raise AssertionError("K2 on the card differs from the plain version on the CPU")
    print("[dense] K2 on the card equals the plain version on the CPU")

    runs = {  # stack, wrapper, table
        "K2": (kitti, db.dense_bit_planes_batch, 0),
        "K3": (tum, lambda x: db.dense_bit_planes(x[0]), 0),
        "K3 at 188x620": (level1[:1], lambda x: db.dense_bit_planes(x[0]), 0),
        "K4": (euroc[:1], lambda x: db.dense_bit_planes_pattern(x[0], 5), 6),
    }
    out["K3 at 188x620"] = dict(out["K3"])
    for name, (x, wrapper, table) in runs.items():
        out[name]["shape"] = "x".join(map(str, x.shape))
        out[name].update(timed(
            lambda: wrapper(x), lambda: db.dense_bit_planes_reference(x, table),
            kt.dense_work(*x.shape), x.numel(), kt.distinct_taps(db.TABLES[table]), card,
            f"[dense] {name.split()[0]} median over 20 runs at {'x'.join(map(str, x.shape))}"
            f"{', bank 5' if name == 'K4' else ''}"))
    return out


def phase_k2_probe(card):
    """K2's band-size / input-type probe at (64, 376, 1241)."""
    from vslam_tpu_torch.frontend import dense_brief as db
    from vslam_tpu_torch.frontend import kernel_timing as kt

    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (64, 376, 1241))
                         .astype(np.float32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype).contiguous()
        ref = db.dense_bit_planes_reference(xd)
        for band in db.BANDS:
            _require_equal(f"K2' band {band} {dtype}", db.KERNEL.launch(xd, 0, band), ref)
            ms = kt.cuda_ms(lambda: db.KERNEL.launch(xd, 0, band), runs=10)
            print(f"[k2'] band {band:2d} {str(dtype)[6:]:8s} bit-equal; median over 10 "
                  f"runs at 64x376x1241: {ms:.4f} ms ({ms / 32:.4f} ms per pair) ({card})")
        del ref
    torch.cuda.synchronize()


def run_engine(cam, cfg, frames, device, n_frames):
    from vslam_tpu_torch.system.engine import SlamEngine

    engine = SlamEngine(cam, cfg, landmark_capacity=65536, device=device)
    times = []
    t0 = time.perf_counter()
    for left, right in frames[:n_frames]:
        t1 = time.perf_counter()
        engine.process(left, right)
        times.append(time.perf_counter() - t1)
    traj = engine.trajectory  # flushes the device ring
    if device == "cuda":
        torch.cuda.synchronize()
    return engine, traj, time.perf_counter() - t0, times


def drive_slice(label, cam, cfg, gt_poses, frames, expect, local_maps, cpu_frames, card):
    """One run on the card through engine.process, with the launch counts
    zeroed just before it and read just after; checks and prints it, then
    compares its first frames with the same engine on the CPU.  Returns
    the counts."""
    from vslam_tpu_torch.eval import trajectory as traj_eval

    n = len(frames)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    engine, traj, wall, times = run_engine(cam, cfg, frames, "cuda", n)
    counts = read_counts()
    rep = engine.report()
    if traj.shape != (n, 4, 4) or not np.all(np.isfinite(traj)):
        raise AssertionError(f"{label}: trajectory shape {traj.shape} or non-finite poses")
    rmse, _, _ = traj_eval.ate_rmse(traj, gt_poses)
    loop = np.linalg.norm(np.diff(gt_poses[:, :3, 3], axis=0), axis=1).sum()
    print(f"[{label}] {n} frames: ATE {rmse:.4f} m over a {loop:.1f} m path, "
          f"{rep['n_local_maps']} local maps, {rep['n_closures']} closures, "
          f"{rep['n_track_breaks']} breaks, "
          f"{rep['n_landmarks']} landmarks, {rep['n_recovered_landmarks']} recovered, "
          f"launches {counts}")
    ms_frame = 1e3 * wall / n
    steady = 1e3 * statistics.median(times[min(8, n // 4):])
    print(f"[{label}] {ms_frame:.2f} ms/frame over the run ({1e3 / ms_frame:.2f} fps), "
          f"median {steady:.2f} ms/frame after the first frames, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts}, expected {expect}")
    if rep["n_track_breaks"] != 0:
        raise AssertionError(f"{label}: {rep['n_track_breaks']} tracking breaks")
    if not rmse <= ATE_LIMIT_M:
        raise AssertionError(f"{label}: ATE {rmse:.4f} m > {ATE_LIMIT_M} m")
    if not local_maps[0] <= rep["n_local_maps"] <= local_maps[1]:
        raise AssertionError(f"{label}: {rep['n_local_maps']} local maps outside {local_maps}")

    _, traj_cpu, _, _ = run_engine(cam, cfg, frames, "cpu", cpu_frames)
    dev = np.abs(traj[:cpu_frames, :3, 3] - traj_cpu[:, :3, 3]).max()
    print(f"[{label}] first {cpu_frames} positions: card vs CPU max |diff| {dev:.2e} m")
    if not dev <= CPU_CHECK_TOL_M:
        raise AssertionError(f"{label}: card and CPU trajectories differ by {dev} m")
    return counts


def config_slice(label, name, cam_args, n_frames, radius, per_frame, local_maps,
                 cpu_frames, card):
    """A shipped configuration, open loop, on a synthetic circle."""
    from vslam_tpu_torch.io import synthetic
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configurations", f"configuration_{name}.yaml"))
    cfg.command_line.option_disable_relocalization = True
    cam = cam_ops.make_camera(**cam_args)
    world = synthetic.make_world(cam, n_points=7000, seed=0,
                                 poses=synthetic.circle_trajectory(n_frames, radius=radius))
    frames = [synthetic.render_frame(world, t)[:2] for t in range(n_frames)]
    expect = {k: per_frame.get(k, 0) * n_frames for k in counters()}
    return drive_slice(label, cam, cfg, world.poses, frames, expect, local_maps,
                       cpu_frames, card)


def closed_loop_config(cfg_open):
    """bench.py's closed-loop settings on top of the K1 slice's."""
    import copy

    cfg = copy.deepcopy(cfg_open)
    cfg.command_line.option_disable_relocalization = False
    cfg.relocalization.preliminary_minimum_interspace_queries = 8
    cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
    cfg.relocalization.icp_minimum_number_of_inliers = 10
    cfg.relocalization.icp_minimum_inlier_ratio = 0.3
    cfg.graph_optimization.minimum_closure_residual_for_optimization_meters = 0.10
    cfg.graph_optimization.minimum_closure_residual_for_optimization_degrees = 0.5
    return cfg


def ba_closed_config(cfg_open):
    """bench.py's BA-enabled run: the closed loop with windowed bundle
    adjustment every BA_EVERY_FRAMES frames (bench.py:98-100)."""
    cfg = closed_loop_config(cfg_open)
    cfg.graph_optimization.enable_full_bundle_adjustment = True
    cfg.graph_optimization.number_of_frames_per_bundle_adjustment = BA_EVERY_FRAMES
    return cfg


def phase_closed_loop(label, cam, cfg, world, frames, jax_cpu, card):
    """A closed-loop engine run on the card through tracker.prestage +
    process_prestaged, the launch counts zeroed just before it and read
    just after; checked against phase 7's limits.  With BA on it also
    requires >= 1 BA run and prints each BA problem's size and the BA
    stage.  Returns the launch counts."""
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.system import ba_runner
    from vslam_tpu_torch.system.engine import SlamEngine
    from vslam_tpu_torch.utils import log

    n = len(frames)
    ba_on = cfg.graph_optimization.enable_full_bundle_adjustment
    engine = SlamEngine(cam, cfg, landmark_capacity=65536, device="cuda")
    handles = engine.tracker.prestage(frames)
    sizes = []  # (P, L) of each BA problem
    build = ba_runner.build_window_problem

    def build_and_record(*args, **kwargs):
        built = build(*args, **kwargs)
        if built is not None:
            sizes.append((built[0].T_wc.shape[0], built[0].xyz.shape[0]))
        return built

    ba_runner.build_window_problem = build_and_record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log.chronometers.clear()
    reset_counts()
    times = []
    t0 = time.perf_counter()
    try:
        for h in handles:
            t1 = time.perf_counter()
            engine.process_prestaged(h)
            times.append((time.perf_counter() - t1) / len(h))
        traj = engine.trajectory  # flushes the tracker and the closure pipeline
        torch.cuda.synchronize()
    finally:
        ba_runner.build_window_problem = build
    wall = time.perf_counter() - t0
    counts = read_counts()
    rep = engine.report()
    if traj.shape != (n, 4, 4) or not np.all(np.isfinite(traj)):
        raise AssertionError(f"{label}: trajectory shape {traj.shape} or non-finite poses")
    rmse, _, _ = traj_eval.ate_rmse(traj, world.poses)
    got = {k: rep[k] for k in jax_cpu if k in rep}
    got.update(ate_m=round(float(rmse), 4), db_rows=engine.relocalizer.n_rows,
               closures=[(c.query_id, c.reference_id) for c in engine.world_map.closures])
    print(f"[{label}] {n} frames, card: {got}")
    print(f"[{label}] {n} frames, the JAX engine on a CPU: {jax_cpu}")
    print(f"[{label}] launches {counts}, {rep['n_landmarks']} landmarks, "
          f"{rep['n_recovered_landmarks']} recovered")
    ms_frame = 1e3 * wall / n
    print(f"[{label}] {ms_frame:.2f} ms/frame over the run incl. the final flush "
          f"({1e3 / ms_frame:.2f} fps), median {1e3 * statistics.median(times[1:]):.2f} "
          f"ms/frame over the {len(handles) - 1} handles after the first, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    table = rep["stage_table"]
    for stage in CLOSURE_STAGES + (("bundle_adjustment",) if ba_on else ()):
        row = table.get(stage, {"seconds": 0.0, "calls": 0})
        print(f"[{label}] stage {stage:24s} {row['seconds']:8.4f} s in {row['calls']} calls")
    if ba_on:
        print(f"[{label}] {rep['n_ba_runs']} BA runs; (P cameras, L landmarks) of each "
              f"problem: {sizes}")
    if counts != {"K1": n, "K2": 0, "K3": 0, "K4": 0}:
        raise AssertionError(f"{label}: launches {counts}, expected {n} K1 only")
    if rep["n_track_breaks"] != 0:
        raise AssertionError(f"{label}: {rep['n_track_breaks']} tracking breaks")
    if not rmse <= ATE_LIMIT_M:
        raise AssertionError(f"{label}: ATE {rmse:.4f} m > {ATE_LIMIT_M} m")
    if not LOCAL_MAPS[0] <= rep["n_local_maps"] <= LOCAL_MAPS[1]:
        raise AssertionError(f"{label}: {rep['n_local_maps']} local maps outside "
                             f"{LOCAL_MAPS}")
    if not (rep["n_closures"] >= 1 and rep["n_optimizations"] >= 1
            and rep["n_merged_landmarks"] > 0):
        raise AssertionError(f"{label}: {rep['n_closures']} closures, "
                             f"{rep['n_optimizations']} optimizations, "
                             f"{rep['n_merged_landmarks']} merged landmarks")
    if ba_on and not rep["n_ba_runs"] >= 1:
        raise AssertionError(f"{label}: bundle adjustment never ran")
    return counts


def phase_tum(card):
    """configuration_tum.yaml as shipped (RGB-D, closed loop) on phase 9's
    sequence; local maps within +-15% of the JAX engine's on a CPU."""
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configurations", "configuration_tum.yaml"))
    cam = cam_ops.make_camera(**TUM_CAM)
    gt, frames = tum_world(cam)
    ref = JAX_CPU_TUM["n_local_maps"]
    local_maps = (int(np.ceil(0.85 * ref)), int(np.floor(1.15 * ref)))
    print(f"[tum-config] the JAX engine on a CPU: {JAX_CPU_TUM}")
    return drive_slice("tum-config", cam, cfg, gt, frames,
                       {"K1": 0, "K2": 0, "K3": TUM_FRAMES, "K4": 0}, local_maps,
                       TUM_CPU_FRAMES, card)


def phase_build(card) -> dict:
    """Both nvcc builds at once; per kernel: blocks per SM and the shared
    loads of one pixel (the loads in its pixel loop, from the SASS)."""
    from vslam_tpu_torch.frontend import dense_brief as db
    from vslam_tpu_torch.frontend import fast_brief as fb
    from vslam_tpu_torch.frontend.cuda_build import loop_shared_loads

    t0 = time.perf_counter()
    libraries = {"K1": fb.K1.library, "K2/K3/K4": db.KERNEL.library}
    for lib in libraries.values():
        lib.start()  # one nvcc per source, all at once
    fb.K1.build()
    db.KERNEL.build()
    print(f"[build] both libraries built in {time.perf_counter() - t0:.2f} s of wall time")
    for name, lib in libraries.items():
        print(f"[build] {name} ({lib.src.name}) built in {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    kernels = {"K1": (fb.K1.library, fb.K1.sass_name, fb.K1.blocks_per_sm(dev))}
    for name, table in (("K2", 0), ("K3", 0), ("K4", 6)):
        kernels[name] = (db.KERNEL.library, db.KERNEL.sass_name(table),
                         db.KERNEL.blocks_per_sm(dev, table))
    facts, sass = {}, {}
    for name, (lib, fn, blocks) in kernels.items():
        try:
            if lib not in sass:
                sass[lib] = lib.sass()
            loads = loop_shared_loads(sass[lib], fn) or None
            why = "" if loads else "no pixel loop found in the SASS"
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            loads, why = None, str(e)
        facts[name] = {"blocks_per_sm": blocks, "lds_per_pixel": loads}
        print(f"[build] {name}: {blocks} blocks of 256 threads per SM, "
              f"{loads if loads else 'null (' + why + ')'} shared loads a pixel ({card})")
    return facts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    import vslam_tpu_torch  # noqa: F401  (the port, from this checkout)
    from vslam_tpu_torch.frontend import dense_brief as db

    card = card_line()
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    facts = phase_build(card)

    cam, cfg, world, frames = bench_setup()
    stats = {"K1": phase_k1(frames, card)}
    stats.update(phase_dense(frames[0], card))
    phase_k2_probe(card)

    launches = drive_slice("k1-slice", cam, cfg, world.poses, frames,
                           {"K1": N_FRAMES, "K2": 0, "K3": 0, "K4": 0}, LOCAL_MAPS,
                           CPU_CHECK_FRAMES, card)
    for counts in (
        config_slice("kitti-config", "kitti", KITTI_CAM, 64, 13.0, {"K2": 1, "K3": 2},
                     (14, 18), 8, card),
        config_slice("euroc-config", "euroc", EUROC_CAM, 32, 4.0,
                     {"K2": 1, "K4": 2 * db.N_ROT_BANKS}, (13, 17), 4, card),
    ):
        launches = {k: launches[k] + counts[k] for k in launches}
    for counts in (
        phase_closed_loop("closed", cam, closed_loop_config(cfg), world, frames,
                          JAX_CPU_CLOSED_LOOP, card),
        phase_closed_loop("ba-closed", cam, ba_closed_config(cfg), world, frames,
                          JAX_CPU_BA_CLOSED, card),
        phase_tum(card),
    ):
        launches = {k: launches[k] + counts[k] for k in launches}

    sources = {"K1": ("fast_brief_frontend_pair", "fast_brief_frontend.cu",
                      "vslam_tpu/frontend/pallas_frontend.py:196")}
    for name, entry in (("K2", db.K2), ("K3", db.K3), ("K4", db.K4)):
        sources[name] = (entry.name, "dense_brief.cu", entry.replaces)
    print(json.dumps({"kernels": [{
        "name": fn,
        "route": "cuda",
        "source": f"vslam_tpu_torch/csrc/{src}",
        "replaces": replaces,
        "launches": launches[k],
        # No single PyTorch call computes either function (256 packed
        # compares of shifted taps; blur + FAST + NMS + band argmax).
        "library_ms": None,
        **stats[k],
        **facts[k],
    } for k, (fn, src, replaces) in sources.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
