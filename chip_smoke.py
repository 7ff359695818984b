"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then non-zero):
  1. device  — require CUDA; print torch / CUDA versions and the card's
               name and power limit (nvidia-smi);
  2. build   — compile K1 (csrc/fast_brief_frontend.cu) and the dense
               BRIEF kernel behind K2/K3/K4 (csrc/dense_brief.cu) with
               nvcc, and the PNG decoder's host unfilter
               (csrc/png_unfilter.cpp) with g++, the builds started
               together (their wall time);
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
               a. K1 slice: the first 64 frames of the bench's 128-frame
                  13 m-radius circle at KITTI resolution with its settings
                  (phases 7-8 run all 128 on the same K1 path); 64 K1
                  launches, 0 breaks, ATE <= 0.05 m, local maps within
                  +-15% of the JAX engine's on a CPU;
               b. configuration_kitti.yaml (2 octaves, BRIEF256) on the
                  first 32 frames of a 64-frame 13 m circle (phase 12 runs
                  all 64 from disk); K2 32, K3 64, K1 and K4 0 launches,
                  0 breaks, ATE <= 0.05 m, local maps within +-15% of the
                  JAX engine's on a CPU;
               c. configuration_euroc.yaml (BRIEF256R) at EuRoC's 752x480
                  and intrinsics on a 32-frame 4 m circle; K4 32 and K2 1
                  launches per frame, K1 and K3 0, 0 breaks, ATE <= 0.05 m,
                  13-17 local maps;
               each slice's first frames (8, 4, 4) agree with the same
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
               closed loop) at TUM fr1's 640x480 and intrinsics on the
               first 32 frames of a 64-frame circle (phase 13 runs all 64
               from disk) rendered as (intensity, depth) with the world
               scaled by 1/10; 32 K3 launches and no K1/K2/K4, 0
               breaks, ATE <= 0.05 m, local maps within +-15% of the JAX
               engine's on a CPU; the first 4 frames agree with the CPU
               within 1e-3 m;
 10. xtion-config — configurations/configuration_xtion.yaml as shipped
               (RGB-D, FAST + ORB256, bin 12, bilateral depth filtering,
               closed loop) on phase 9's world, turning half as fast (32
               frames of a 128-frame circle); no K1/K2/K3/K4 launch
               (ORB256 is a gather, not a kernel), 0 breaks, ATE <= 0.05 m,
               local maps within +-15% of the JAX engine's on a CPU; the
               first 4 frames agree with the CPU within 1e-3 m.  The depth
               goes in as meters: the configuration's millimeter scale
               (depth_scale_factor_intensity_to_meters) is read only by the
               dataset loaders and the command line, which this phase
               does not go through;
 11. detectors — on the left image of phase 6a's frame 0 (376x1241):
               detect_keypoints with HARRIS, GFTT, DOG and KAZE (2 octaves,
               bin 16) on the card against the same call on the CPU, >= 99%
               of the keypoints in common, ms per call on the card; ORB256
               describe of its FAST keypoints on the card against the CPU,
               <= 0.1% of the bits differing; then configuration_kitti.yaml
               with detector_type DOG, open loop, on phase 6b's 32 frames: 0 breaks, ATE <= 0.05 m, local maps
               within +-15% of the JAX engine's on a CPU, the first 4
               frames within 1e-3 m of the CPU.
 12. kitti-disk — phase 6b's whole 64-frame circle written as a KITTI odometry
               directory (image_0/ and image_1/ 8-bit PNGs through stdlib
               zlib with a Paeth row in every 8, so the decoder's C
               unfilter runs; times.txt; calib.txt with P1[0, 3] = -fx*b;
               the ground truth), then `python -m vslam_tpu_torch run -c
               configurations/configuration_kitti.yaml --open-loop` (on
               the default device; closed, this circle ends at ATE 0.051 m
               in JAX and the port alike) writing KITTI and TUM
               trajectories, the pose and factor graphs and the report,
               `eval` against the ground truth and `convert` TUM -> KITTI,
               each a subprocess: frame 0 decodes to the written bytes, 0
               breaks, ATE <= 0.05 m, 14-18 local maps, K2 64 and K3 128
               launches (the run's report), and an engine in this process
               on the same decoded frames gives the same positions within
               1e-6 m over the first 40 frames, then saves a checkpoint
               there, between two of the card's 32-frame drains, holding
               a local map for every keyframe the device made;
               ms/frame and the decode time of a stereo pair;
 13. tum-disk — phase 9's whole 64-frame circle as a TUM directory (RGB8
               with equal channels, 16-bit depth at 5,000 units a meter,
               rgb.txt, depth.txt, groundtruth.txt), `run --format tum -c
               configurations/configuration_tum.yaml` and `eval --format
               tum`: 0 breaks, ATE <= 0.05 m, 18-24 local maps, 64 K3
               launches;
 14. checkpoint — the checkpoint phase 12's in-process engine saved after 40
               frames, loaded into a fresh engine on the card (no landmark
               names a missing keyframe), which runs frames 40-63: within
               0.2 m of phase 12's trajectory, ATE <= 0.1 m, K2 24 and K3
               48 launches; its size and its save
               and load times.  Phases 12-14 also print whether cv2 and
               matplotlib are installed (the port needs neither).
The JAX counts printed beside phases 6-11 come from
chip_smoke_jax_reference.py.  The script then prints the kernel record
(one JSON line: launches summed over the runs of phases 6-10 and 12-14,
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

from vslam_tpu_torch.eval.workloads import (  # noqa: E402  (the bench workload)
    KITTI_CAM, ba_closed_config, bench_config, bench_world, closed_loop_config)
from vslam_tpu_torch.frontend.dense_brief import kernel_counters as counters  # noqa: E402

ATE_LIMIT_M = 0.05
LOCAL_MAPS = (36, 48)  # phases 7-8: 128 frames, JAX's 42
# Phase 6a runs the first half of the bench's circle; phases 7-8 run all
# of it through the same K1 path.
K1_SLICE_FRAMES = 64
CPU_CHECK_FRAMES = 8
TUM_CPU_FRAMES = 4
# Phase 6b's world: 7,000 points around a 64-frame 13 m circle at KITTI
# resolution.  Phases 6b and 11 run its first half; phase 12 runs all of
# it from disk, through the command line.
KITTI_CIRCLE_FRAMES = 64
KITTI_SLICE_FRAMES = 32
CPU_CHECK_TOL_M = 1e-3
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
# Phases 9 and 10 run the first halves of their circles; phase 13 runs
# all of phase 9's from disk, through the command line.
TUM_CONFIG_FRAMES = 32
XTION_FRAMES = 32
TUM_RADIUS_M = 3.5  # of the scaled world (see tum_world)
TUM_SCALE = 10.0  # the world is rendered at 10x and its depth divided back
# Phase 10's circle turns 2.8 degrees a frame, half of phase 9's (see
# phase_xtion).
XTION_CIRCLE_FRAMES = 128

# The JAX engine (vslam_tpu) on a CPU for the workloads of phases 7-11
# (chip_smoke_jax_reference.py); it drains every frame, the port on the
# card every 32.
JAX_CPU_CLOSED_LOOP = {"n_local_maps": 42, "n_closures": 3, "n_optimizations": 1,
                       "n_merged_landmarks": 82, "n_track_breaks": 0, "ate_m": 0.0351,
                       "db_rows": 7242, "closures": [(39, 0), (40, 0), (41, 0)]}
JAX_CPU_BA_CLOSED = {"n_local_maps": 42, "n_closures": 3, "n_optimizations": 1,
                     "n_merged_landmarks": 82, "n_track_breaks": 0, "n_ba_runs": 2,
                     "ate_m": 0.0422, "db_rows": 7242, "closures": [(39, 0), (40, 0), (41, 0)]}
JAX_CPU_TUM = {"n_local_maps": 10, "n_closures": 0, "n_optimizations": 0,
               "n_merged_landmarks": 0, "n_track_breaks": 0, "ate_m": 0.0078, "db_rows": 2723}
JAX_CPU_XTION = {"n_local_maps": 31, "n_closures": 0, "n_optimizations": 0,
                 "n_merged_landmarks": 0, "n_track_breaks": 0, "ate_m": 0.0093,
                 "db_rows": 5133}
JAX_CPU_KITTI_DOG = {"n_local_maps": 8, "n_track_breaks": 0, "ate_m": 0.0139}
JAX_CPU_K1_SLICE = {"n_local_maps": 21, "n_track_breaks": 0, "ate_m": 0.0043}
JAX_CPU_KITTI_CONFIG = {"n_local_maps": 8, "n_track_breaks": 0, "ate_m": 0.0138}
FLOAT_DETECTORS = ("HARRIS", "GFTT", "DOG", "KAZE")
CLOSURE_STAGES = ("relocalization", "reloc_vote_icp", "pose_graph_optimization",
                  "pg_solve", "pg_propagate", "landmark_merging")


def bench_setup():
    """The bench's camera, configuration (open loop) and 128-frame circle."""
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.ops import camera as cam_ops

    cam = cam_ops.make_camera(**KITTI_CAM)
    world, frames = bench_world(cam)
    return cam, bench_config(ParameterCollection), world, frames


def tum_world(cam, circle_frames=TUM_FRAMES, n_frames=TUM_FRAMES):
    """Phase 9's sequence: the first n_frames frames of a circle of
    circle_frames frames, rendered as RGB-D frames (intensity, depth in
    meters), with the world -- points and pose translations -- scaled by
    1/10 so that the depths fall in TUM's indoor range (0.3-4.5 m for the
    world's 3-45 m offsets).  Scaling a world leaves its images as they
    are, so each frame is rendered from the unscaled world and its depth
    divided by 10.  The circle's radius is 3.5 m: on circles of 1.3 m and
    2.5 m the shipped tum configuration's closure ICP (its default 1 m
    kernel, 25 inliers at ratio 0.4) accepts a false closure across the
    circle from chance descriptor matches, in the JAX engine as in the
    port (ATE 0.77 m at 1.3 m).  Returns (ground-truth poses, frames)."""
    from vslam_tpu_torch.io import synthetic

    poses = synthetic.circle_trajectory(circle_frames, radius=TUM_RADIUS_M * TUM_SCALE)
    world = synthetic.make_world(cam, n_points=7000, seed=0, poses=poses)
    frames = []
    for t in range(n_frames):
        img, depth = synthetic.render_depth_frame(world, t)
        frames.append((img, depth / np.float32(TUM_SCALE)))
    gt = poses[:n_frames].copy()
    gt[:, :3, 3] /= TUM_SCALE
    return gt, frames


def kitti_config(load_config, detector=None):
    """configuration_kitti.yaml, open loop (the command line's
    --open-loop), with another detector_type if one is given, loaded by
    the given package's load_config.  Closed, phase 12's 64-frame circle
    closes once (local map 15 -> 0) and ends at ATE 0.0510 m, in the JAX
    engine on a CPU (0.05101 m) as in the port: above the 0.05 m limit."""
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configurations", "configuration_kitti.yaml"))
    if detector is not None:
        cfg.framepoint_generation.detector_type = detector
    cfg.command_line.option_disable_relocalization = True
    return cfg


def kitti_world(cam, n_frames):
    """Phase 6b's world (7,000 points, seed 0) on its 64-frame 13 m
    circle, cut to its first n_frames frames.  Returns (ground-truth
    poses, stereo frames)."""
    from vslam_tpu_torch.io import synthetic

    world = synthetic.make_world(
        cam, n_points=7000, seed=0,
        poses=synthetic.circle_trajectory(KITTI_CIRCLE_FRAMES, radius=13.0))
    return (world.poses[:n_frames],
            [synthetic.render_frame(world, t)[:2] for t in range(n_frames)])


def within_15_percent(ref: int):
    return int(np.ceil(0.85 * ref)), int(np.floor(1.15 * ref))


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


def phase_kitti_config(card):
    """Phase 6b: configuration_kitti.yaml, open loop, on the first half of
    its circle (phase 12 runs all of it from disk)."""
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    cam = cam_ops.make_camera(**KITTI_CAM)
    gt, frames = kitti_world(cam, KITTI_SLICE_FRAMES)
    print(f"[kitti-config] the JAX engine on a CPU: {JAX_CPU_KITTI_CONFIG}")
    return drive_slice("kitti-config", cam, kitti_config(load_config), gt, frames,
                       {"K1": 0, "K2": KITTI_SLICE_FRAMES, "K3": 2 * KITTI_SLICE_FRAMES, "K4": 0},
                       within_15_percent(JAX_CPU_KITTI_CONFIG["n_local_maps"]), 4, card)


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
    gt, frames = tum_world(cam, TUM_FRAMES, TUM_CONFIG_FRAMES)
    print(f"[tum-config] the JAX engine on a CPU: {JAX_CPU_TUM}")
    return drive_slice("tum-config", cam, cfg, gt, frames,
                       {"K1": 0, "K2": 0, "K3": TUM_CONFIG_FRAMES, "K4": 0},
                       within_15_percent(JAX_CPU_TUM["n_local_maps"]), TUM_CPU_FRAMES, card)


def phase_xtion(card):
    """configuration_xtion.yaml as shipped (RGB-D, ORB256, bilateral
    depth, closed loop) on phase 9's world, depth in meters, but turning
    half as fast: 64 frames of a 128-frame circle (2.8 degrees a frame).
    At phase 9's 5.6 degrees a frame ORB256 breaks tracking on 54 of 64
    frames, in the JAX engine on a CPU (ATE 2.18 m) as in the port: the
    synthetic background is one fixed image that does not move with the
    world, so the 31-pixel disk whose intensity centroid steers each
    descriptor sees another background every frame, and the steered
    pattern with it.  The configuration is the reference's live Xtion
    setup, tuned for slow hand-held motion."""
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configurations", "configuration_xtion.yaml"))
    cam = cam_ops.make_camera(**TUM_CAM)
    gt, frames = tum_world(cam, XTION_CIRCLE_FRAMES, XTION_FRAMES)
    print(f"[xtion-config] the JAX engine on a CPU: {JAX_CPU_XTION}")
    return drive_slice("xtion-config", cam, cfg, gt, frames,
                       {"K1": 0, "K2": 0, "K3": 0, "K4": 0},
                       within_15_percent(JAX_CPU_XTION["n_local_maps"]), TUM_CPU_FRAMES, card)


def _ms_per_call(fn, runs=10):
    """Median host time of a synchronized call on the card."""
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times[1:])


def phase_detectors(kitti_frame, card):
    """The float detectors and ORB256 on the card against the CPU, then
    the 32-frame open-loop DOG run of configuration_kitti.yaml."""
    from vslam_tpu_torch.frontend import detect, orb
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    img = torch.from_numpy(np.asarray(kitti_frame[0]).astype(np.uint8).astype(np.float32))
    thr = torch.tensor(20.0)
    for name in FLOAT_DETECTORS:
        args = dict(bin_size=16, capacity=1024, border=20, detector=name, octaves=2)
        kc = detect.detect_keypoints(img.cuda(), thr.cuda(), **args)
        kp = detect.detect_keypoints(img, thr, **args)
        on_card = set(map(tuple, kc.uv[kc.valid].cpu().numpy().tolist()))
        on_cpu = set(map(tuple, kp.uv[kp.valid].numpy().tolist()))
        common = len(on_card & on_cpu)
        ms = _ms_per_call(lambda: detect.detect_keypoints(img.cuda(), thr.cuda(), **args))
        print(f"[detectors] {name}: {len(on_card)} keypoints on the card, {len(on_cpu)} on "
              f"the CPU, {common} in common; {ms:.2f} ms per call on the card "
              f"(2 octaves, 376x1241, synchronized host clock, median of 10) ({card})")
        if len(on_cpu) < 100 or common < 0.99 * len(on_cpu):
            raise AssertionError(f"{name}: {common} of {len(on_cpu)} keypoints in common")
    kp = detect.detect_keypoints(img, thr, 16, 1024, 20)
    dc = orb.describe(img.cuda(), kp.uv.cuda()).cpu().numpy()
    dp = orb.describe(img, kp.uv).numpy()
    n_diff = int(np.unpackbits((dc ^ dp).view(np.uint8)).sum())
    ms = _ms_per_call(lambda: orb.describe(img.cuda(), kp.uv.cuda()))
    print(f"[detectors] ORB256 describe of {kp.uv.shape[0]} keypoints: {n_diff} of "
          f"{dp.size * 32} bits differ between the card and the CPU; {ms:.2f} ms per call "
          f"on the card ({card})")
    if n_diff > 1e-3 * dp.size * 32:
        raise AssertionError(f"ORB256: {n_diff} bits differ between the card and the CPU")

    cfg = kitti_config(load_config, detector="DOG")
    cam = cam_ops.make_camera(**KITTI_CAM)
    gt, frames = kitti_world(cam, KITTI_SLICE_FRAMES)
    print(f"[kitti-dog] the JAX engine on a CPU: {JAX_CPU_KITTI_DOG}")
    drive_slice("kitti-dog", cam, cfg, gt, frames,
                {"K1": 0, "K2": KITTI_SLICE_FRAMES, "K3": 2 * KITTI_SLICE_FRAMES, "K4": 0},
                within_15_percent(JAX_CPU_KITTI_DOG["n_local_maps"]), 4, card)


def phase_build(card) -> dict:
    """Both nvcc builds at once; per kernel: blocks per SM and the shared
    loads of one pixel (the loads in its pixel loop, from the SASS)."""
    from vslam_tpu_torch.frontend import dense_brief as db
    from vslam_tpu_torch.frontend import fast_brief as fb
    from vslam_tpu_torch.frontend.cuda_build import loop_shared_loads

    from vslam_tpu_torch.io import image

    t0 = time.perf_counter()
    libraries = {"K1": fb.K1.library, "K2/K3/K4": db.KERNEL.library,
                 "PNG unfilter (host)": image.UNFILTER}
    for lib in libraries.values():
        lib.start()  # one compiler per source, all at once
    image.UNFILTER.load()  # seconds; the nvcc builds go on meanwhile
    fb.K1.build()
    db.KERNEL.build()
    print(f"[build] the three libraries built in {time.perf_counter() - t0:.2f} s of wall time")
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


# ---------------------------------------------------------------------------
# Phases 12-14: recorded sequences from disk through the command line
# ---------------------------------------------------------------------------

# Rows unfiltered but for a Paeth row in every 8.
PNG_FILTERS = (0,) * 7 + (4,)
# Between two of the card's 32-frame drains: the checkpoint must register
# the keyframes harvested by its own flush.
RESUME_AT = 40
CHECKPOINT_TOL_M = 0.2
CHECKPOINT_ATE_M = 0.1
SAME_RUN_TOL_M = 1e-6


def cli(args, label, timeout=600):
    """`python -m vslam_tpu_torch <args>` from this checkout, on the
    default device; raises on a non-zero exit.  Returns its stdout."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "vslam_tpu_torch", *args], cwd=here, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"{label}: `python -m vslam_tpu_torch {args[0]}` exited "
                             f"{out.returncode}:\n{out.stderr[-3000:]}")
    print(f"[{label}] `python -m vslam_tpu_torch {args[0]}` took "
          f"{time.perf_counter() - t0:.2f} s")
    return out.stdout


def check_run(label, rep, ate, local_maps, expect):
    """The checks of a disk phase: 0 breaks, ATE, local maps, launches."""
    run = rep["run"]
    got = run["kernel_launches"]
    n = run["frames"]
    after_first = 1e3 * (run["seconds"] - run["first_frame_seconds"]) / (n - 1)
    print(f"[{label}] {n} frames: ATE {ate:.4f} m, "
          f"{rep['n_local_maps']} local maps, {rep['n_closures']} closures, "
          f"{rep['n_merged_landmarks']} merged landmarks, {rep['n_track_breaks']} breaks, "
          f"launches {got}; {run['ms_per_frame']:.2f} ms/frame over the run incl. the "
          f"final flush, {run['first_frame_seconds']:.2f} s of it the first frame (the "
          f"process's warm-up), {after_first:.2f} ms/frame after it; "
          f"{1e3 * run['frame_wait_seconds'] / n:.2f} ms/frame waiting for decoded frames; "
          f"device {run['device']}")
    if got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    if rep["n_track_breaks"] != 0:
        raise AssertionError(f"{label}: {rep['n_track_breaks']} tracking breaks")
    if not ate <= ATE_LIMIT_M:
        raise AssertionError(f"{label}: ATE {ate:.4f} m > {ATE_LIMIT_M} m")
    if not local_maps[0] <= rep["n_local_maps"] <= local_maps[1]:
        raise AssertionError(f"{label}: {rep['n_local_maps']} local maps outside {local_maps}")
    if not rep["run"]["device"].startswith("cuda"):
        raise AssertionError(f"{label}: ran on {rep['run']['device']}, not the card")


def write_kitti_sequence(root, cam_args, frames, poses):
    """A KITTI odometry sequence directory: image_0/ and image_1/ 8-bit
    PNGs, times.txt, calib.txt (P1[0, 3] = -fx * b) and the ground truth
    in KITTI format.  Returns frame 0's left image as written."""
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.io import image

    for d in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, d))
    written = None
    for t, (left, right) in enumerate(frames):
        for d, img in (("image_0", left), ("image_1", right)):
            u8 = np.clip(img, 0, 255).astype(np.uint8)
            image.write_png(os.path.join(root, d, f"{t:06d}.png"), u8, PNG_FILTERS)
            written = u8 if written is None else written
    np.savetxt(os.path.join(root, "times.txt"), np.arange(len(frames)) * 0.1)
    fx, fy, cx, cy, b = (cam_args[k] for k in ("fx", "fy", "cx", "cy", "baseline_m"))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"P0: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n")
        f.write(f"P1: {fx} 0 {cx} {-fx * b} 0 {fy} {cy} 0 0 0 1 0\n")
    traj_eval.write_kitti(os.path.join(root, "gt_kitti.txt"), poses.astype(np.float64))
    return written


def phase_kitti_disk(tmp, card):
    """Phase 12: phase 6b's 64-frame sequence as a KITTI directory, run
    through `python -m vslam_tpu_torch run` with configuration_kitti.yaml
    and --open-loop (kitti_config), then `eval` and `convert`; an in-process
    engine on the same decoded frames must give the same trajectory.
    Returns (launch counts, the subprocess trajectory, the decoded
    frames, the camera, the ground truth, the path of the checkpoint
    the in-process engine saved at frame RESUME_AT)."""
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.io import checkpoint, datasets, image
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops
    from vslam_tpu_torch.system.engine import SlamEngine

    here = os.path.dirname(os.path.abspath(__file__))
    yaml_path = os.path.join(here, "configurations", "configuration_kitti.yaml")
    gt, frames = kitti_world(cam_ops.make_camera(**KITTI_CAM, device="cpu"), KITTI_CIRCLE_FRAMES)
    seq = os.path.join(tmp, "kitti_seq")
    t0 = time.perf_counter()
    written = write_kitti_sequence(seq, KITTI_CAM, frames, gt)
    print(f"[kitti-disk] wrote {2 * KITTI_CIRCLE_FRAMES} PNGs (376x1241 gray8, a Paeth row "
          f"in {len(PNG_FILTERS)}) in {time.perf_counter() - t0:.2f} s")
    first = image.decode_image(os.path.join(seq, "image_0", "000000.png"))
    if first.dtype != np.uint8 or not np.array_equal(first, written):
        raise AssertionError("kitti-disk: frame 0 does not decode to the written bytes")
    ds = datasets.KittiDataset(seq)
    t0 = time.perf_counter()
    for i in range(len(ds)):
        image.decode_image(ds.left[i])
        image.decode_image(ds.right[i])
    decode_ms = 1e3 * (time.perf_counter() - t0) / len(ds)
    print(f"[kitti-disk] frame 0 decodes to the written bytes; decoding a stereo pair takes "
          f"{decode_ms:.2f} ms on one host thread")

    out = os.path.join(tmp, "kitti_out")
    os.makedirs(out)
    cli(["run", "--dataset", seq, "--format", "kitti", "-c", yaml_path, "--open-loop",
         "--output-kitti", os.path.join(out, "est_kitti.txt"),
         "--output-tum", os.path.join(out, "est_tum.txt"),
         "--save-pose-graph", os.path.join(out, "pose_graph.g2o"),
         "--save-factor-graph", os.path.join(out, "factor_graph.g2o"),
         "--timing-output", os.path.join(out, "timing.json")], "kitti-disk")
    with open(os.path.join(out, "timing.json")) as f:
        rep = json.load(f)
    metrics = json.loads(cli(["eval", "--estimate", os.path.join(out, "est_kitti.txt"),
                              "--ground-truth", os.path.join(seq, "gt_kitti.txt")],
                             "kitti-disk").strip().splitlines()[-1])
    print(f"[kitti-disk] eval: {metrics}")
    cli(["convert", "--input", os.path.join(out, "est_tum.txt"), "--input-format", "tum",
         "--output", os.path.join(out, "converted_kitti.txt"), "--output-format", "kitti"],
        "kitti-disk")
    est = traj_eval.read_kitti(os.path.join(out, "est_kitti.txt"))
    conv = traj_eval.read_kitti(os.path.join(out, "converted_kitti.txt"))
    with open(os.path.join(out, "pose_graph.g2o")) as f:
        n_vertices = sum(line.startswith("VERTEX_SE3:QUAT") for line in f)
    print(f"[kitti-disk] outputs: {len(est)} KITTI poses, {len(conv)} converted from TUM "
          f"(max |diff| {np.abs(conv[:, :3, 3] - est[:, :3, 3]).max():.2e} m), pose graph "
          f"with {n_vertices} vertices, factor graph "
          f"{os.path.getsize(os.path.join(out, 'factor_graph.g2o'))} bytes ({card})")
    check_run("kitti-disk", rep, metrics["ate_rmse_m"], (14, 18),
              {"K1": 0, "K2": KITTI_CIRCLE_FRAMES, "K3": 2 * KITTI_CIRCLE_FRAMES, "K4": 0})
    if est.shape != (KITTI_CIRCLE_FRAMES, 4, 4) or conv.shape != est.shape:
        raise AssertionError(f"kitti-disk: trajectory files hold {est.shape}, {conv.shape}")
    if not np.abs(conv[:, :3, 3] - est[:, :3, 3]).max() <= 1e-5:
        raise AssertionError("kitti-disk: convert changed the positions")
    if n_vertices != rep["n_local_maps"]:
        raise AssertionError(f"kitti-disk: {n_vertices} pose-graph vertices, "
                             f"{rep['n_local_maps']} local maps")

    # The first RESUME_AT frames (8 after the card's last drain) in this
    # process: the same engine, frame by frame, then a checkpoint for
    # phase 14, which must hold every keyframe the device has made.
    decoded = list(ds)
    engine = SlamEngine(ds.cam, kitti_config(load_config))
    for fr in decoded[:RESUME_AT]:
        engine.process(fr.img_left, fr.img_right)
    ckpt = os.path.join(tmp, "kitti_state.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(engine, ckpt)
    save_s = time.perf_counter() - t0
    n_maps, kf_count = len(engine.world_map), int(engine.tracker.state.kf_count)
    print(f"[kitti-disk] checkpoint at frame {RESUME_AT}: {n_maps} local maps, the device's "
          f"keyframe count {kf_count}")
    if n_maps != kf_count:
        raise AssertionError(f"kitti-disk: the checkpoint holds {n_maps} local maps of "
                             f"{kf_count} keyframes")
    dev = np.abs(engine.trajectory[:, :3, 3] - est[:RESUME_AT, :3, 3]).max()
    print(f"[kitti-disk] in-process engine on the decoded frames vs the command line: max "
          f"|diff| {dev:.2e} m over the first {RESUME_AT} frames (KITTI files round to 1e-9 "
          "relative)")
    if not dev <= SAME_RUN_TOL_M:
        raise AssertionError(f"kitti-disk: the command line and the in-process engine differ "
                             f"by {dev} m over the first {RESUME_AT} frames")
    return rep["run"]["kernel_launches"], est, decoded, ds.cam, gt, ckpt, save_s


def phase_checkpoint(est, decoded, cam, gt, ckpt, save_s, card):
    """Phase 14: the checkpoint phase 12's in-process engine saved at frame
    RESUME_AT, loaded into a fresh engine on the card, which runs the
    frames after it; launch counts zeroed just before and read just
    after the resumed run."""
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.io import checkpoint
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.system.engine import SlamEngine

    engine = SlamEngine(cam, kitti_config(load_config))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.load_checkpoint(engine, ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    table = engine.tracker.state.table
    origin_max = int(table.origin_kf[table.valid].max())
    if origin_max >= len(engine.world_map):
        raise AssertionError(f"checkpoint: a landmark names keyframe {origin_max} of "
                             f"{len(engine.world_map)} local maps")
    reset_counts()
    for fr in decoded[RESUME_AT:]:
        engine.process(fr.img_left, fr.img_right)
    traj = engine.trajectory
    counts = read_counts()
    n_after = len(decoded) - RESUME_AT
    err = np.linalg.norm(traj[:, :3, 3] - est[:, :3, 3], axis=1)
    rmse, _, _ = traj_eval.ate_rmse(traj, gt)
    print(f"[checkpoint] {os.path.getsize(ckpt) / 2**20:.2f} MiB npz; save {save_s:.3f} s, load "
          f"{load_s:.3f} s; resumed at frame {RESUME_AT}: max |diff| {err.max():.4f} m from "
          f"phase 12's run, ATE {rmse:.4f} m, {engine.report()['n_local_maps']} local maps, "
          f"launches {counts} ({card})")
    if traj.shape != (len(decoded), 4, 4) or not np.all(np.isfinite(traj)):
        raise AssertionError(f"checkpoint: trajectory {traj.shape} or non-finite poses")
    if not err.max() <= CHECKPOINT_TOL_M or not rmse <= CHECKPOINT_ATE_M:
        raise AssertionError(f"checkpoint: resumed run {err.max():.4f} m from phase 12's, "
                             f"ATE {rmse:.4f} m")
    if counts != {"K1": 0, "K2": n_after, "K3": 2 * n_after, "K4": 0}:
        raise AssertionError(f"checkpoint: launches {counts}")
    return counts


def phase_tum_disk(tmp, card):
    """Phase 13: phase 9's 64-frame RGB-D sequence as a TUM directory (RGB8
    intensity with equal channels, 16-bit depth at 5,000 units a meter),
    run through `python -m vslam_tpu_torch run --format tum` with
    configuration_tum.yaml, then `eval --format tum`."""
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.io import image
    from vslam_tpu_torch.ops import camera as cam_ops

    here = os.path.dirname(os.path.abspath(__file__))
    gt, frames = tum_world(cam_ops.make_camera(**TUM_CAM, device="cpu"))
    seq = os.path.join(tmp, "tum_seq")
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, d))
    ts = np.arange(len(frames)) * 0.1
    t0 = time.perf_counter()
    with open(os.path.join(seq, "rgb.txt"), "w") as fr, \
            open(os.path.join(seq, "depth.txt"), "w") as fd:
        for t, (img, depth) in enumerate(frames):
            gray = np.clip(img, 0, 255).astype(np.uint8)
            image.write_png(os.path.join(seq, "rgb", f"{t}.png"),
                            np.repeat(gray[..., None], 3, 2), PNG_FILTERS)
            image.write_png(os.path.join(seq, "depth", f"{t}.png"),
                            np.round(depth * 5000.0).astype(np.uint16), PNG_FILTERS)
            fr.write(f"{ts[t]:.6f} rgb/{t}.png\n")
            fd.write(f"{ts[t]:.6f} depth/{t}.png\n")
    traj_eval.write_tum(os.path.join(seq, "groundtruth.txt"), gt.astype(np.float64), ts)
    print(f"[tum-disk] wrote {len(frames)} RGB8 and {len(frames)} 16-bit depth PNGs (640x480) "
          f"in {time.perf_counter() - t0:.2f} s")
    out = os.path.join(tmp, "tum_out")
    os.makedirs(out)
    cli(["run", "--dataset", seq, "--format", "tum", "-c",
         os.path.join(here, "configurations", "configuration_tum.yaml"),
         "--output-kitti", os.path.join(out, "est_kitti.txt"),
         "--output-tum", os.path.join(out, "est_tum.txt"),
         "--timing-output", os.path.join(out, "timing.json")], "tum-disk")
    with open(os.path.join(out, "timing.json")) as f:
        rep = json.load(f)
    metrics = json.loads(cli(["eval", "--format", "tum", "--estimate",
                              os.path.join(out, "est_tum.txt"), "--ground-truth",
                              os.path.join(seq, "groundtruth.txt")],
                             "tum-disk").strip().splitlines()[-1])
    print(f"[tum-disk] eval: {metrics} ({card})")
    if metrics["n_poses"] != len(frames):
        raise AssertionError(f"tum-disk: {metrics['n_poses']} poses associated")
    check_run("tum-disk", rep, metrics["ate_rmse_m"], (18, 24),
              {"K1": 0, "K2": 0, "K3": len(frames), "K4": 0})
    return rep["run"]["kernel_launches"]


def phase_disk(card):
    """Phases 12-14 in one temporary directory, removed at the end."""
    import importlib.util
    import shutil
    import tempfile

    print(f"[disk] on this machine: cv2 "
          f"{'present' if importlib.util.find_spec('cv2') else 'absent'}, matplotlib "
          f"{'present' if importlib.util.find_spec('matplotlib') else 'absent'} (the port "
          "decodes, rectifies and writes without either; --dump needs matplotlib)")
    tmp = tempfile.mkdtemp(prefix="vslam_disk_")
    try:
        counts, est, decoded, cam, gt, ckpt, save_s = phase_kitti_disk(tmp, card)
        launches = dict(counts)
        for more in (phase_checkpoint(est, decoded, cam, gt, ckpt, save_s, card),
                     phase_tum_disk(tmp, card)):
            launches = {k: launches[k] + more[k] for k in launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


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

    print(f"[k1-slice] the JAX engine on a CPU: {JAX_CPU_K1_SLICE}")
    launches = drive_slice("k1-slice", cam, cfg, world.poses[:K1_SLICE_FRAMES],
                           frames[:K1_SLICE_FRAMES],
                           {"K1": K1_SLICE_FRAMES, "K2": 0, "K3": 0, "K4": 0},
                           within_15_percent(JAX_CPU_K1_SLICE["n_local_maps"]),
                           CPU_CHECK_FRAMES, card)
    for counts in (
        phase_kitti_config(card),
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
        phase_xtion(card),
    ):
        launches = {k: launches[k] + counts[k] for k in launches}
    phase_detectors(frames[0], card)
    counts = phase_disk(card)
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
