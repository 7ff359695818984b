"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then non-zero):
  1. device  — require CUDA; print torch / CUDA versions and the card's
               name and power limit (nvidia-smi);
  2. build   — compile kernel K1 (csrc/fast_brief_frontend.cu) with nvcc;
  3. K1      — kernel vs its plain-torch version on the card at 376x1241,
               B=2, on a rendered synthetic pair and a uniform-random pair
               (both uint8-valued), FAST thresholds {5, 18, 40, 100}, arc
               lengths 9 and 12: all four outputs bit-equal over the whole
               image; one case also against the plain version on the CPU;
               median kernel and plain times (CUDA events, 20 runs);
  4. slice   — SlamEngine in open-loop mode on the card: 128 frames of a
               13 m-radius circle at KITTI resolution with the bench's
               settings; asserts 128 K1 launches, 0 tracking breaks,
               ATE <= 0.05 m, 36-48 local maps, and that the first 8 frames
               agree with the same engine on the CPU.
The line before the last is a JSON object with the kernel record, the
last line {"ok": true, "device": {...}}.
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
CPU_CHECK_TOL_M = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20) -> float:
    """Median device time of fn() in ms (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bench_setup():
    """The bench's camera, configuration (open loop) and 128-frame circle."""
    from vslam_tpu_torch.io import synthetic
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.ops import camera as cam_ops

    cam = cam_ops.make_camera(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                              baseline_m=0.5372, rows=376, cols=1241)
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 1024
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.world_map.minimum_distance_traveled_for_local_map = 1.5
    cfg.world_map.minimum_number_of_frames_for_local_map = 3
    cfg.local_map.maximum_number_of_landmarks = 512
    cfg.parallelism.frames_per_chunk = 32
    cfg.graph_optimization.enable_full_bundle_adjustment = False
    cfg.command_line.option_disable_relocalization = True
    poses = synthetic.circle_trajectory(N_FRAMES, radius=RADIUS_M)
    world = synthetic.make_world(cam, n_points=7000, seed=0, poses=poses)
    frames = [synthetic.render_frame(world, t)[:2] for t in range(N_FRAMES)]
    return cam, cfg, world, frames


def phase_k1(frames, card):
    from vslam_tpu_torch.frontend import fast_brief as fb

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
    ms = cuda_ms(lambda: fb.fast_brief_frontend_pair(imgs, t))
    plain_ms = cuda_ms(lambda: fb.fast_brief_frontend_pair_reference(imgs, t))
    print(f"[k1] median over 20 runs at 2x376x1241: kernel {ms:.4f} ms, plain "
          f"version {plain_ms:.4f} ms ({card})")
    return max_err, ms, plain_ms


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


def phase_slice(cam, cfg, world, frames, card):
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.frontend import fast_brief as fb

    torch.cuda.reset_peak_memory_stats()
    fb.K1.launches = 0
    engine, traj, wall, times = run_engine(cam, cfg, frames, "cuda", N_FRAMES)
    launches = fb.K1.launches
    rep = engine.report()
    if traj.shape != (N_FRAMES, 4, 4) or not np.all(np.isfinite(traj)):
        raise AssertionError(f"trajectory shape {traj.shape} or non-finite poses")
    rmse, _, _ = traj_eval.ate_rmse(traj, world.poses)
    print(f"[slice] {N_FRAMES} frames: ATE {rmse:.4f} m over a "
          f"{2 * np.pi * RADIUS_M:.1f} m loop, {rep['n_local_maps']} local maps, "
          f"{rep['n_track_breaks']} breaks, {rep['n_landmarks']} landmarks, "
          f"{rep['n_recovered_landmarks']} recovered, K1 launches {launches}")
    ms_frame = 1e3 * wall / N_FRAMES
    steady = 1e3 * statistics.median(times[8:])
    print(f"[slice] {ms_frame:.2f} ms/frame over the run ({1e3 / ms_frame:.2f} fps), "
          f"median {steady:.2f} ms/frame after frame 8, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    if launches != N_FRAMES:
        raise AssertionError(f"K1 launched {launches} times for {N_FRAMES} frames")
    if rep["n_track_breaks"] != 0:
        raise AssertionError(f"{rep['n_track_breaks']} tracking breaks")
    if not rmse <= ATE_LIMIT_M:
        raise AssertionError(f"ATE {rmse:.4f} m > {ATE_LIMIT_M} m")
    if not LOCAL_MAPS[0] <= rep["n_local_maps"] <= LOCAL_MAPS[1]:
        raise AssertionError(f"{rep['n_local_maps']} local maps outside {LOCAL_MAPS}")

    _, traj_cpu, _, _ = run_engine(cam, cfg, frames, "cpu", CPU_CHECK_FRAMES)
    dev = np.abs(traj[:CPU_CHECK_FRAMES, :3, 3] - traj_cpu[:, :3, 3]).max()
    print(f"[slice] first {CPU_CHECK_FRAMES} positions: card vs CPU max |diff| {dev:.2e} m")
    if not dev <= CPU_CHECK_TOL_M:
        raise AssertionError(f"card and CPU trajectories differ by {dev} m")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    import vslam_tpu_torch  # noqa: F401  (the port, from this checkout)
    from vslam_tpu_torch.frontend import fast_brief as fb

    card = card_line()
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    fb.K1.build()
    print(f"[build] K1 built in {fb.K1.build_seconds:.2f} s")
    for line in fb.K1.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")

    cam, cfg, world, frames = bench_setup()
    max_err, ms, plain_ms = phase_k1(frames, card)
    launches = phase_slice(cam, cfg, world, frames, card)

    print(json.dumps({"kernels": [{
        "name": "fast_brief_frontend_pair",
        "route": "cuda",
        "source": "vslam_tpu_torch/csrc/fast_brief_frontend.cu",
        "replaces": "vslam_tpu/frontend/pallas_frontend.py:196",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
