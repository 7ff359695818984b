"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then non-zero):
  1. device  — require CUDA; print torch / CUDA versions and the card's
               name and power limit (nvidia-smi);
  2. build   — compile K1 (csrc/fast_brief_frontend.cu), the dense
               BRIEF kernel behind K2/K3/K4 (csrc/dense_brief.cu), the
               staged FAST detector's kernel (csrc/fast_cells.cu), the
               box blur kernel (csrc/box_blur.cu), the matching kernel
               (csrc/hamming_match.cu) and the conditional graph nodes
               (csrc/graph_cond.cu: WHILE and IF nodes under capture,
               ops/control.py) with nvcc, and the PNG
               decoder's host unfilter (csrc/png_unfilter.cpp) with g++,
               the builds started together (their wall time);
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
  4b. fast-cells — the staged detector's kernel (FAST score, NMS, border
               mask, per-cell argmax) vs its plain version on the card at
               both pyramid levels of a KITTI pair (2x376x1241, 2x188x620:
               rendered, uniform-random, three grey levels) and a ragged
               3x37x53 stack, arc lengths 9 and 12, thresholds {5, 20,
               100}, (border, bin) (20, 16), (3, 16), (0, 24): every cell
               bit-equal; one case against the CPU; times at both levels
               as for K1;
  4c. box-blur — the box blur kernel (csrc/box_blur.cu) vs its plain
               version on the card at every launch of the cells' routes
               (KITTI's pair and level-1 image at radius 2; EuRoC's pair
               and image at 2 and its gradient pair at 7; rendered or
               gradient stacks and uniform-random ones) and on a ragged
               3x37x53 stack at radii 2 and 7: every pixel bit-equal; one
               case against the CPU; times at each launch as for K1, and
               summed over a KITTI and a EuRoC frame;
  4d. hamming-match — the matching kernel (csrc/hamming_match.cu) vs
               the plain match_stereo / match_projective on the card at
               the cells' shape (a KITTI pair's 1,024 keypoints an image;
               stereo, projective at A = 1 and 3): all three outputs of
               every row equal; one case against the CPU; times warm and
               L2-cold beside the plain version's and the bound;
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
                  all 64 from disk); K2 32, K3 64, the staged detector
                  64, the box blur 96, K1 and K4 0 launches,
                  0 breaks, ATE <= 0.05 m, local maps within +-15% of the
                  JAX engine's on a CPU;
               c. configuration_euroc.yaml (BRIEF256R) at EuRoC's 752x480
                  and intrinsics on the first 16 frames of a 32-frame 4 m
                  circle; K4 32, K2 1 and the box blur 5 launches per
                  frame, K1 and K3 0,
                  0 breaks, ATE <= 0.05 m, local maps within +-15% of the
                  JAX engine's on a CPU;
               each slice's first frames (4, 2, 2) agree with the same
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
               memory, database rows and the closure stages' timings; the
               closure ICP batches (relocalizer.ICPProgram: padded to a
               bucket of 8 or 16, eager at a bucket's first use, captured
               at its second, replayed after): each captured bucket's
               last replay bit-equal to the eager solve of the same
               batch, device ms a batch by route and ICP ms a drain;
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
               engine's on a CPU; the first 2 frames agree with the CPU
               within 1e-3 m;
 10. xtion-config — configurations/configuration_xtion.yaml as shipped
               (RGB-D, FAST + ORB256, bin 12, bilateral depth filtering,
               closed loop) on phase 9's world, turning half as fast (32
               frames of a 128-frame circle); no K1/K2/K3/K4 launch
               (ORB256 is a gather, not a kernel), 0 breaks, ATE <= 0.05 m,
               local maps within +-15% of the JAX engine's on a CPU; the
               first 2 frames agree with the CPU within 1e-3 m.  The depth
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
               with detector_type DOG, open loop, on phase 6b's 32 frames:
               0 breaks, ATE <= 0.05 m, local maps
               within +-15% of the JAX engine's on a CPU, the first 2
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
 15. k1-split — phase 6a's first 32 frames with tracking.batch_frontend (the
               split front-end): one K1 launch for the 32-frame chunk over
               its 64 images (B = 64) and no other, 0 breaks, ATE <= 0.05 m,
               local maps within +-15% of the JAX engine's split run on a CPU;
               the first 4 frames within 1e-3 m of the CPU at the same chunk;
               K1 at (64, 376, 1241) bit-equal to its plain version, timed;
               ms/frame and peak memory beside phase 6a's;
 16. kitti-split — phase 6b's 32 frames with the split front-end: one K2 launch
               over the chunk's 64 blurred images (B = 64) and K3 64, the same
               checks; K2 at that shape bit-equal to its plain version, timed;
 17. fast-icp — phase 7's own closure ICP batches re-solved with FAST-ICP
               (solve/anderson.py) on the card and on the CPU (the same
               verdicts, accepted transforms within 1e-4) and GN ICP's verdicts (their
               translation gap printed: two robust estimators); JAX's
               GN-agreement problem on the card within 5e-3 m of GN ICP; the
               host synchronizations of one batch (torch's sync debug mode),
               ms a batch; the batches again through FAST-ICP's closure ICP
               programs (one a bucket, captured): two replays of each batch
               bit-equal to each other and to its eager batch, the verdicts of the eager batch and of GN
               ICP, no synchronization inside a replayed run, ms a batch
               eager and replayed;
 18. chain-pg — optimize_pose_graph_chain on a 64-pose chain with three
               closures, card against CPU within 1e-4, with and without
               Levenberg damping; ms a call;
 19. sharded — two gloo ranks on the one card (this script with
               --shard-worker): search_sharded_top2 and the relocalizer's
               sharded query on phase 7's final database exact against the
               one-device search, and bundle_adjust_sharded on phase 8's last
               BA window against the one-device bundle_adjust (poses 1e-5,
               chi2 1e-4 relative) and bit for bit against its two blocks
               summed in one process (points: two f32 sum orders of this
               window differ by up to ~1e-3 m); the points' distance from
               an f64 solve printed beside the one-device BA's.
 20. modular-closed — phase 7's workload with tracking.use_fused_tracker
               false: the modular PoseTracker stepped through engine.process
               frame by frame on its captured programs (tracking/modular.py:
               front-end, track attempt, propagate, spawn, update; each eager
               once, captured at its second use, replayed after), keyframes
               and closures resolved synchronously after every frame (the
               DB query a captured program a key); launch counts zeroed just
               before and read just after: 128 K1 and no K2/K3/K4 launches,
               0 breaks, ATE <= 0.05 m, local maps within +-15% of the JAX
               modular engine's on a CPU, >= 1 closure, its optimization
               count (0: JAX's three closures pass the residual gate), > 0
               merged landmarks, and the events and ATE of the card's eager
               modular run to every digit (CARD_MODULAR_CLOSED); one eager
               run a program; ms/frame and the median after the first 16,
               the program events, WHILE iterations a track replay, peak
               device memory and the closure stages' timings; then each
               program from the run's last state: its eager run and two
               replays bit-equal, no synchronization inside a replay, its
               WHILE nodes as the eager run's active rounds, eager and
               replayed ms.
 21. device-program — the fused tracker's FrameProgram (make_frame_step:
               the state in static buffers, one captured CUDA graph a frame
               whose GN phases are WHILE nodes and whose retry ladder,
               snapshot and eviction are IF nodes, replayed) against the
               eager fused.step (loops to their caps, both branches),
               side by side from the same start on phase 7's first 64
               frames: after every frame every state tensor equal bit for
               bit, every WHILE node reached running as many iterations
               as the eager loop's active rounds and every cond deciding
               as the eager one (the program's control.Record against
               control.recording of the eager step), every replay under
               torch.cuda.set_sync_debug_mode("error") (a synchronization
               inside a frame raises), each replay counting its capture's
               launches (one K1 a frame); the eviction IF taking its sweep
               on frames 31 and 63 alone, the snapshot IF firing as often
               as kf_count says; WHILE iterations a replay; ms/frame of
               both paths, the host's enqueue time of a replay, and on a
               second program over the same frames device-busy ms and
               kernels a replay (torch.profiler over frames 56-63) and ms
               a replay by CUDA events (frames 48-55), beside the
               fixed-cap program's; the capture's seconds and peak memory;
               then the same checks on 4 frames of each other captured
               route (kitti-config, euroc-config, tum-config,
               xtion-config, kitti-dog) and of the split front-end's tails
               (TrackProgram, make_track_step, on one 4-frame chunk of
               phase 6a's frames); and the guided ladder (320 x 640,
               yaw-perturbed odometry): the IF nodes of attempts 2 and 3
               take their retries on exactly the frames where a host
               ladder reaches those attempts.
 22. bench — bench.py on the port (eval/workloads.run_bench), its one JSON
               line printed: an engine over the BA-enabled closed loop's
               128 frames and the pose-graph, BA and ICP warm-ups, then the
               timed closed and ba-closed engines, fresh, on the programs the
               warm-up captured (fused.make_frame_step and the ICP buckets
               are one per process): phases 7-8's events and ATE to every
               digit, no eager frame, no capture and no eager ICP batch,
               pose-graph solve or BA inside either timed loop
               (fused.EVENTS, relocalizer.EVENTS, pose_graph.EVENTS,
               ba.EVENTS), one replay a frame; the open-loop tracker-only rates (fused,
               and the split front-end), the device-only rate (every frame's
               replay back to back, one sync), the stage ms/frame, the
               warm-up's seconds and each timed engine's first handle;
               launches zeroed before and read after: K1 once a frame in
               five 128-frame runs and once a split chunk, no K2/K3/K4;
               the DB query's programs (relocalizer.query_program, warmed
               by relocalizer.warm_query_programs up to the warm engine's
               prefix): no eager query and no capture inside either timed
               loop, >= 1 replay;
 23. scale — the KITTI-00-scale run inside phase 22 (eval/scale_run.py,
               1,024 frames of 2.5 laps of a 65 m circle through 26,000
               points, windowed BA every 128 frames, blocks of 128 frames
               rendered and prestaged off the clock), counted on its own:
               ate_ok, 0 breaks, closures after local map 150, 1,024 K1
               launches; local maps, closures, optimizations, BA runs,
               merged landmarks, DB rows, live table rows, peak device
               memory, ms/frame, the stage table and the programs' events
               over the run and its warm-ups, the query programs' (SB,
               prefix) keys and uses and their replayed ms at the largest
               prefix; peak device memory at most SCALE_PEAK_MIB; its
               largest pose graph padded against tight as phase 24 holds it;
 24. backend programs — fresh on the card: the pose-graph junction solve
               at Jp 64, 128 and 256 (two laps of a drifting circle) and
               its distribution, and the BA program on phase 8's last
               window (P 16, L padded to 2048): each captured, a replay
               bit-equal to the eager run of the same padded shape and to a
               second replay, no host synchronization inside a replayed
               run, padded against tight (pose graph: within 1e-5 or 3x the
               tight f32 solve's distance from f64, also on phase 7's own
               graph, chi2 1e-3; BA: poses 1e-5, points 1e-3 m, chi2
               1e-4), ms a solve eager and replayed.
 25. modular configs — configuration_kitti.yaml (staged: K2 + K3 launched
               from the front-end program) and configuration_tum.yaml (RGB-D:
               K3) on the modular tracker, 32 frames each of phases 6b and 9's
               sequences: K2 32 and K3 64, and K3 32, the eager modular
               route's launches; 0 breaks, ATE <= 0.05 m, local maps within
               +-15% of the JAX engine's on a CPU, the first frames within
               1e-3 m of the CPU; then the query programs on phase 7's own
               query batches, each from the database it met, and one at the
               scale run's largest prefix (65,536 rows, 45,839 live, 16
               queries) on a random database: captured, eager run and two
               replays bit-equal (best, ok, the database after the insert),
               no synchronization inside a replay, eager and replayed ms,
               the scale query's peak device memory.
 26. euroc-closed — the benchmark's EuRoC cell (perfbench's
               proslam-euroc.mh1024: configuration_euroc.yaml, BRIEF256R)
               closed loop on the card: its 1,024 rolled frames from one
               seed, prestaged, through SlamEngine.process_prestaged in
               32-frame handles; launches K4 32, K2 1, the staged detector
               2 and the box blur 5 a frame (and 2 a descriptor check),
               K1 and K3 0; 0 breaks, every pose finite, >= 1 closure;
               the correctness numbers of perfbench/reference.py
               and the `rotated keypoints` counter; and after
               EUROC_CHECK_HANDLES handles the last frame's left
               descriptors as the frame program left them (the front end's
               framepoints, recovered rows left out) against
               perfbench/brief256r_plain.py on the program's own
               keypoints, at 752x480: a bank may differ only within
               EUROC_BANK_MARGIN of a boundary, and where the banks agree
               every bit but the exact ties is equal.  Alone:
               `python3 chip_smoke.py --euroc-closed`.
 27. tum-closed — the benchmark's TUM cell (perfbench's
               proslam-tum.room1024: configuration_tum.yaml, RGB-D)
               closed loop on the card: its 1,024 (intensity, depth)
               frames from one seed, prestaged, through
               SlamEngine.process_prestaged in 32-frame handles; launches
               K3, the staged detector and the box blur 1 a frame (and
               K3 1, the detector 2 and the blur 1 a check), K1, K2 and
               K4 0; 0 breaks, every pose finite, >= 1 closure; the
               correctness numbers of perfbench/reference.py and the
               three depth counters against the tracker's statistics;
               and at the first frame of TUM_CHECK_HANDLES handles (that
               frame handed over alone, the rest of its handle after it,
               so the drains stay where they were), at 640x480 and
               capacity 1,024, on the program's own keypoints and depth:
               its framepoints against perfbench/rgbd_plain.py's
               (validity and depth exact, points within
               TUM_POINT_TOL_M), and the pose the frame program solved
               against rgbd_plain.uvd_solve from the inputs of that
               solve (attempt 1's, recorded from the same step run
               eagerly on the state before the frame; within
               TUM_POSE_TOL_M and TUM_POSE_TOL_DEG); the same references
               in bfloat16 must fail both tolerances.  Alone:
               `python3 chip_smoke.py --tum-closed`.
Every drive_slice run (phases 6, 9-11, 15-16) and phases 7-8 start from
an empty program cache (fresh_programs), so the engine's first frame
runs eagerly there, as before the programs were shared.
Every run of the fused tracker (phases 6-17) steps through that program
(phases 15-16: the chunk's front-end eagerly, then each frame's tail as
a replay): each replay adds its capture's launches to the counts.  The
modular tracker (phases 20, 25) runs its per-frame programs the same
way, as its JAX counterpart runs jitted programs, and its host reads
(each ladder attempt's verdict, the spawn mask) fall between them.
Phases 7, 8 and 20 are also held to the events and ATE this script
printed before their programs existed (CARD_CLOSED, CARD_BA_CLOSED,
CARD_MODULAR_CLOSED).
The phases run in the order 1-5, 21, 6a, 6b, 15, 16, 18, 6c, 26, 27, 7, 8,
20, 25, 9-14, 17, 19, 24, 22-23: phases 15-16 next to the runs they are
compared with, phase 25 after phase 7, whose query batches it replays.
The JAX counts printed beside phases 6-11, 15-16 and 20 come from
chip_smoke_jax_reference.py.  The script then prints its wall time, the
kernel record (one JSON line: launches summed over the runs of phases
6-10, 12-16, 20-23 and 25-27, bit-equality, times, bound, share of the bound,
shared-load floor, blocks per SM, loads a pixel; K3's times at 480x640;
K1 and K2 at the split chunk's B = 64 as entries of their own), the card's name
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
import vslam_tpu_torch.frontend.dense_brief  # noqa: E402,F401  (registers K1-K4, box_blur)
import vslam_tpu_torch.frontend.detect  # noqa: E402,F401  (registers fast_cells)
from vslam_tpu_torch.ops.cuda_build import counters  # noqa: E402

ATE_LIMIT_M = 0.05
LOCAL_MAPS = (36, 48)  # phases 7-8: 128 frames, JAX's 42
# Phase 6a runs the first half of the bench's circle; phases 7-8 run all
# of it through the same K1 path.
K1_SLICE_FRAMES = 64
# The first frames of each slice held to the CPU.
CPU_CHECK_FRAMES = 8
KITTI_CPU_FRAMES = 4
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
EUROC_CIRCLE_FRAMES = 32
# Cut when phase 20 took the smoke past 900 s on a slow host: the split
# K1 run takes one 32-frame chunk (it took two), euroc-config the first
# half of its circle (it ran all 32 frames).
SPLIT_K1_FRAMES = 32
EUROC_FRAMES = 16
# Phase 26: the benchmark's EuRoC cell, its seed, the handles after which
# the last frame's descriptors are held to the plain reference, and the
# bank margin (tests/test_perfbench_euroc.py: the float32 angle lies
# within 1e-5 banks of the exact one; 100 times that).
EUROC_CELL = "proslam-euroc.mh1024"
EUROC_SEED = 3_000_000_019
EUROC_CHECK_HANDLES = 8
EUROC_BANK_MARGIN = 1e-3
# Phase 27: the benchmark's TUM cell, its seed, and the handles whose
# first frame is held to perfbench/rgbd_plain.py.  Tolerances against the
# float64 reference: a framepoint's depth and validity exactly (the same
# float32 pixel), its point within TUM_POINT_TOL_M (the program's float32
# back-projection lay within 1.2e-7 m of it on the cell's frames, an H100;
# the same in bfloat16 2.7e-2 m away); the frame's UVD pose within
# TUM_POSE_TOL_M and TUM_POSE_TOL_DEG (the frame program's float32 solve
# lay within 2.6e-7 m and 5e-6 deg of the converged float64 one there,
# and within 1.5e-7 m and 8e-7 deg on tests/test_perfbench_tum.py's
# problems; bfloat16's 2.4e-2 m and 0.53 deg away).
TUM_CELL = "proslam-tum.room1024"
TUM_SEED = 3_000_000_023
TUM_CHECK_HANDLES = 8
TUM_POINT_TOL_M = 1e-5
TUM_POSE_TOL_M = 1e-4
TUM_POSE_TOL_DEG = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed(kernel, plain, work, pixels, taps, card, label, plain_runs=20):
    """The kernel's warm and L2-cold medians, the plain version's (over
    plain_runs runs), and the bound and floor they are held to, printed
    and returned."""
    from vslam_tpu_torch.frontend import kernel_timing as kt

    rec = {"ms": kt.cuda_ms(kernel), "ms_l2_cold": kt.cuda_ms(kernel, setup=kt.l2_flush("cuda")),
           "plain_ms": kt.cuda_ms(plain, runs=plain_runs)}
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
# Phases 7 and 8 on the card before the fused tracker ran as a replayed
# graph (the eager step with the retry ladder, the snapshot and the
# eviction decided on the host): the program must give the same events
# and ATE.
CARD_CLOSED = {"n_local_maps": 42, "n_optimizations": 1, "n_merged_landmarks": 82,
               "ate_m": 0.0286, "closures": [(39, 0), (40, 0), (41, 0)]}
CARD_BA_CLOSED = {"n_ba_runs": 2, "ate_m": 0.0292}
JAX_CPU_TUM = {"n_local_maps": 10, "n_closures": 0, "n_optimizations": 0,
               "n_merged_landmarks": 0, "n_track_breaks": 0, "ate_m": 0.0078, "db_rows": 2723}
JAX_CPU_XTION = {"n_local_maps": 31, "n_closures": 0, "n_optimizations": 0,
                 "n_merged_landmarks": 0, "n_track_breaks": 0, "ate_m": 0.0093,
                 "db_rows": 5133}
JAX_CPU_KITTI_DOG = {"n_local_maps": 8, "n_track_breaks": 0, "ate_m": 0.0139}
JAX_CPU_K1_SLICE = {"n_local_maps": 21, "n_track_breaks": 0, "ate_m": 0.0043}
JAX_CPU_KITTI_CONFIG = {"n_local_maps": 8, "n_track_breaks": 0, "ate_m": 0.0138}
# Phases 15-16 step the split front-end in chunks of SPLIT_CHUNK frames
# (the card's frames_per_chunk); JAX's counts at that chunk on a CPU
# (chip_smoke_jax_reference.py k1-split kitti-split).
SPLIT_CHUNK = 32
JAX_CPU_K1_SPLIT = {"n_local_maps": 10, "n_track_breaks": 0, "ate_m": 0.0035}
JAX_CPU_KITTI_SPLIT = {"n_local_maps": 8, "n_track_breaks": 0, "ate_m": 0.0183}
# Phase 6c's EUROC_FRAMES frames (chip_smoke_jax_reference.py euroc-config).
JAX_CPU_EUROC = {"n_local_maps": 7, "n_track_breaks": 0, "ate_m": 0.0318}
# Phase 20: phase 7's workload on the JAX package's modular engine
# (tracking.use_fused_tracker false), frame by frame on a CPU
# (chip_smoke_jax_reference.py modular-closed).  Its three closures all
# agree with the estimate within the residual gate (0.10 m, 0.5 deg), so
# no pose-graph optimization runs: the phase is held to that count.
JAX_CPU_MODULAR_CLOSED = {"n_local_maps": 42, "n_closures": 3, "n_optimizations": 0,
                          "n_merged_landmarks": 69, "n_track_breaks": 0, "ate_m": 0.0112,
                          "db_rows": 7149, "closures": [(39, 0), (40, 0), (41, 0)]}
# Phase 20 on the card when the modular tracker ran eagerly, before its
# programs existed: the captured programs must give the same events and
# ATE.
CARD_MODULAR_CLOSED = {"n_local_maps": 42, "n_optimizations": 0, "n_merged_landmarks": 69,
                       "ate_m": 0.0112, "closures": [(39, 0), (40, 0), (41, 0)]}
# Phase 25: 32 frames of kitti-config and of tum-config on the modular
# tracker; the query program at the scale run's largest prefix on a
# database of the scale run's rows (PERF.md), SB queries.
MODULAR_CONFIG_FRAMES = 32
SCALE_DB_ROWS, SCALE_PREFIX, SCALE_SB = 45839, 65536, 16
# The scale run's peak device memory may not pass the highest it reached
# before the query ran as programs in row blocks (10,076.6 MiB, H100
# 80GB HBM3) + 10%.
SCALE_PEAK_MIB = 11100
# Phase 21 (device-program): the closed loop's first frames through the
# eager step and the FrameProgram side by side; each other captured route
# for PROGRAM_ROUTE_FRAMES frames (one eager, a capture, replays); device
# time profiled over PROFILED_REPLAYS replays.
DEVICE_PROGRAM_FRAMES = 64
PROGRAM_ROUTE_FRAMES = 4
PROFILED_REPLAYS = 8
# The program before its loops and conds became conditional nodes (every
# GN solve to its cap, the ladder's three attempts as one batched solve)
# on phase 21's 64 frames, an H100 80GB HBM3 at 700.00 W: kernels and
# device-busy ms a replay (torch.profiler), program ms/frame (PERF.md).
FIXED_CAP_PROGRAM = {"kernels": 38595, "busy_ms": 50.80, "ms_frame": 47.72}
FLOAT_DETECTORS = ("HARRIS", "GFTT", "DOG", "KAZE")
CLOSURE_STAGES = ("relocalization", "reloc_vote_icp", "pose_graph_optimization",
                  "pg_assembly", "pg_junction_solve", "pg_distribution", "pg_propagate",
                  "landmark_merging")


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


def circle_slice(cam, circle_frames, radius, n_frames):
    """A world of 7,000 points (seed 0) on a circle of circle_frames
    frames, cut to its first n_frames frames.  Returns (ground-truth
    poses, stereo frames)."""
    from vslam_tpu_torch.io import synthetic

    world = synthetic.make_world(
        cam, n_points=7000, seed=0,
        poses=synthetic.circle_trajectory(circle_frames, radius=radius))
    return (world.poses[:n_frames],
            [synthetic.render_frame(world, t)[:2] for t in range(n_frames)])


def kitti_world(cam, n_frames):
    """Phase 6b's world on its 64-frame 13 m circle, cut to its first
    n_frames frames."""
    return circle_slice(cam, KITTI_CIRCLE_FRAMES, 13.0, n_frames)


def within_15_percent(ref: int):
    return int(np.ceil(0.85 * ref)), int(np.floor(1.15 * ref))


def reset_counts():
    for c in counters().values():
        c.launches = 0
        c.batches.clear()


# The front end's kernels, whose launches every phase holds to a count a
# frame.  The matching kernel (phase 4d) launches once a match call: the
# retry ladder's attempts vary its count, so the phases leave it out.
FRONT_END_KERNELS = ("K1", "K2", "K3", "K4", "fast_cells", "box_blur")


def read_batches() -> dict:
    """Launches by batch size B, by front-end kernel (since reset_counts)."""
    return {k: dict(c.batches) for k, c in counters().items()
            if c.batches and k in FRONT_END_KERNELS}


def read_counts() -> dict:
    return {k: c.launches for k, c in counters().items() if k in FRONT_END_KERNELS}


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


def phase_fast_cells(kitti_frame, card):
    """Phase 4b: the staged detector's kernel against its plain version,
    every cell bit-equal; its times at both pyramid levels of a KITTI
    pair (bin 16, border 20, threshold 20: ProSLAM's KITTI settings)."""
    from vslam_tpu_torch.frontend import detect
    from vslam_tpu_torch.frontend import kernel_timing as kt

    rng = np.random.default_rng(4)
    pair = torch.from_numpy(np.stack(kitti_frame).astype(np.uint8).astype(np.float32)).cuda()
    level1 = detect.downsample2(pair)
    uniform = torch.from_numpy(np.round(rng.uniform(0, 255, (2, 376, 1241)))
                               .astype(np.float32)).cuda()
    stacks = {
        "rendered 2x376x1241": pair, "rendered 2x188x620": level1,
        "uniform 2x376x1241": uniform, "uniform 2x188x620": detect.downsample2(uniform),
        "3 grey levels 2x188x620": torch.from_numpy(
            rng.integers(0, 3, (2, 188, 620)).astype(np.float32) * 40).cuda(),
        "uniform 3x37x53": torch.from_numpy(np.round(rng.uniform(0, 255, (3, 37, 53)))
                                            .astype(np.float32)).cuda(),
    }
    n_cases = 0
    for name, x in stacks.items():
        for arc in (9, 12):
            for thr in (5.0, 20.0, 100.0):
                t = torch.tensor(thr, device="cuda")
                for border, bin_size in ((20, 16), (3, 16), (0, 24)):
                    got = detect.fast_cells(x, t, arc_len=arc, border=border, bin_size=bin_size)
                    ref = detect.fast_cells_reference(x, t, arc, border, bin_size)
                    for what, a, b in zip(("cell_score", "cell_best"), got, ref):
                        _require_equal(f"fast_cells {what} ({name}, arc {arc}, threshold "
                                       f"{thr}, border {border}, bin {bin_size})", a, b)
                    n_cases += 1
    torch.cuda.synchronize()
    t = torch.tensor(20.0)
    for a, b in zip(detect.fast_cells(pair, t.cuda()), detect.fast_cells(pair.cpu(), t)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("fast_cells on the card differs from the plain version on "
                                 "the CPU")
    print(f"[fast-cells] every cell bit-equal to the plain version in {n_cases} cases "
          f"({len(stacks)} stacks x 2 arc lengths x 3 thresholds x 3 (border, bin)) + 1 case "
          f"against the CPU")
    t = torch.tensor(20.0, device="cuda")
    out = {}
    for label, x in (("fast_cells", pair), ("fast_cells level 1", level1)):
        out[label] = {"max_abs_err": 0.0, "shape": "x".join(map(str, x.shape)), **timed(
            lambda x=x: detect.fast_cells(x, t), lambda x=x: detect.fast_cells_reference(x, t),
            kt.fast_cells_work(*x.shape, 16), x.numel(), kt.FAST_CELLS_TAPS, card,
            f"[fast-cells] median over 20 runs at {'x'.join(map(str, x.shape))}")}
    return out


# The box blur kernel's launches a frame on the cells' routes (label, B,
# H, W, radius): KITTI's staged BRIEF256 (the pair, then each level-1
# image), EuRoC's BRIEF256R (recovery's pair, then for each image the
# image at 2 and its two gradients at 7).
BOX_BLUR_LAUNCHES = (("kitti pair", 2, 376, 1241, 2), ("kitti level 1", 1, 188, 620, 2),
                     ("euroc pair", 2, 480, 752, 2), ("euroc image", 1, 480, 752, 2),
                     ("euroc gradients", 2, 480, 752, 7))
BOX_BLUR_FRAMES = {"kitti": {"kitti pair": 1, "kitti level 1": 2},
                   "euroc": {"euroc pair": 1, "euroc image": 2, "euroc gradients": 2}}


def phase_box_blur(kitti_frame, card):
    """Phase 4c: the box blur kernel against its plain version on the
    card, every pixel bit-equal, at each launch of the cells' routes
    (rendered or gradient and uniform-random stacks) and on a ragged
    3x37x53 stack at both radii it takes; one case against the CPU; the
    kernel's times warm and L2-cold at each launch beside the plain
    version's, and summed over a frame of each route."""
    from vslam_tpu_torch.frontend import detect, orb
    from vslam_tpu_torch.frontend import kernel_timing as kt
    from vslam_tpu_torch.io import synthetic
    from vslam_tpu_torch.ops import camera as cam_ops

    rng = np.random.default_rng(5)
    pair = torch.from_numpy(np.stack(kitti_frame).astype(np.uint8).astype(np.float32)).cuda()
    eworld = synthetic.make_world(cam_ops.make_camera(**EUROC_CAM), n_points=7000, seed=0,
                                  poses=synthetic.circle_trajectory(32, radius=4.0))
    epair = torch.from_numpy(np.stack(synthetic.render_frame(eworld, 0)[:2])
                             .astype(np.uint8).astype(np.float32)).cuda()
    sm = orb.box_blur_reference(epair[0], 2)
    grads = torch.stack([0.5 * (torch.roll(sm, -1, 0) - torch.roll(sm, 1, 0)),
                         0.5 * (torch.roll(sm, -1, 1) - torch.roll(sm, 1, 1))])
    rendered = {"kitti pair": pair, "kitti level 1": detect.downsample2(pair)[:1],
                "euroc pair": epair, "euroc image": epair[:1], "euroc gradients": grads}
    n_cases = 0
    for label, B, H, W, r in BOX_BLUR_LAUNCHES:
        uniform = torch.from_numpy(rng.uniform(0, 255, (B, H, W)).astype(np.float32)).cuda()
        for x in (rendered[label], uniform):
            _require_equal(f"box_blur {label}, radius {r}", orb.box_blur(x, r),
                           orb.box_blur_reference(x, r))
            n_cases += 1
    ragged = torch.from_numpy(rng.uniform(0, 255, (3, 37, 53)).astype(np.float32)).cuda()
    for r in orb.BOX_BLUR.radii:
        _require_equal(f"box_blur 3x37x53, radius {r}", orb.box_blur(ragged, r),
                       orb.box_blur_reference(ragged, r))
        n_cases += 1
    torch.cuda.synchronize()
    if not torch.equal(orb.box_blur(pair, 2).cpu(), orb.box_blur(pair.cpu(), 2)):
        raise AssertionError("box_blur on the card differs from the plain version on the CPU")
    print(f"[box-blur] every pixel bit-equal to the plain version in {n_cases} cases "
          f"({len(BOX_BLUR_LAUNCHES)} launches of the routes x 2 stacks, a ragged stack at "
          f"radii {orb.BOX_BLUR.radii}) + 1 case against the CPU")
    out = {}
    for label, B, H, W, r in BOX_BLUR_LAUNCHES:
        x = rendered[label]
        out[f"box_blur {label}"] = {"max_abs_err": 0.0, "shape": f"{B}x{H}x{W}", "radius": r,
                                    **timed(lambda x=x, r=r: orb.box_blur(x, r),
                                            lambda x=x, r=r: orb.box_blur_reference(x, r),
                                            kt.box_blur_work(B, H, W, r), x.numel(),
                                            kt.box_blur_taps(r), card,
                                            f"[box-blur] {label} median over 20 runs at "
                                            f"{B}x{H}x{W}, radius {r}")}
    for route, launches in BOX_BLUR_FRAMES.items():
        tot = {key: sum(n * out[f"box_blur {label}"][key] for label, n in launches.items())
               for key in ("ms", "ms_l2_cold", "plain_ms", "bound_ms")}
        print(f"[box-blur] {route} frame ({sum(launches.values())} launches): kernel "
              f"{tot['ms']:.4f} ms warm, {tot['ms_l2_cold']:.4f} ms with L2 flushed; plain "
              f"version {tot['plain_ms']:.4f} ms; bound {tot['bound_ms']:.4f} ms ({card})")
    return out


def graph_replay(fn):
    """fn captured in a CUDA graph after a warm run on a side stream: the
    graph's replay, which enqueues its launches in one call."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def phase_hamming_match(kitti_frame, card):
    """Phase 4d: the matching kernel (csrc/hamming_match.cu) against the
    plain version on the card at the cells' shape: the staged front end's
    1,024 keypoints an image of a KITTI pair (capacity 1,024), the stereo
    match at KITTI's gates and a projective match of the left image's
    points, shifted 2 px, into the right one's at A = 1 and A = 3; all
    three outputs of every row equal on the card and one case against the
    CPU; the kernel's times warm and L2-cold beside the plain version's
    (each a replay of a captured call) and the bound
    (kernel_timing.hamming_match_bound)."""
    from vslam_tpu_torch.frontend import kernel_timing as kt
    from vslam_tpu_torch.frontend import matching
    from vslam_tpu_torch.mapping import frame
    from vslam_tpu_torch.ops import hamming

    pair = torch.from_numpy(np.stack(kitti_frame).astype(np.uint8).astype(np.float32)).cuda()
    kps, descs, _ = frame._stereo_detect_describe(pair, torch.tensor(15.0, device="cuda"), 1024,
                                                  16, 20, "BRIEF256", "FAST", False, 2)
    kl, kr = kps
    Q, D = kl.uv.shape[0], kr.uv.shape[0]
    stereo = (kl.uv, descs[0], kl.valid, kr.uv, descs[1], kr.valid, 60, 1.5, 0.0, 200.0)
    shift = torch.tensor([2.0, -1.0], device="cuda")
    radius3 = torch.tensor([8.0, 16.0, 1e6], device="cuda")
    gate3 = torch.tensor([50, 60, 90], dtype=torch.int32, device="cuda")
    cases = {
        "stereo": (matching.match_stereo, matching.match_stereo_reference, stereo, 1),
        "projective": (matching.match_projective, matching.match_projective_reference,
                       ((kl.uv + shift)[None].contiguous(), descs[0], kl.valid[None], kr.uv,
                        descs[1], kr.valid, radius3[:1], gate3[:1]), 1),
        "projective A=3": (matching.match_projective, matching.match_projective_reference,
                           (torch.stack([kl.uv + shift] * 3), descs[0],
                            kl.valid.expand(3, Q).contiguous(), kr.uv, descs[1], kr.valid,
                            radius3, gate3), 3),
    }
    k = hamming.HAMMING_MATCH
    n0 = k.launches
    for label, (fn, plain, args, _) in cases.items():
        got, want = fn(*args), plain(*args)
        for name, a, b in zip(want._fields, got, want):
            _require_equal(f"hamming_match {label} {name}", a, b)
        print(f"[hamming-match] {label} at {Q} x {D}: idx, distance and valid equal to the "
              f"plain version in every row ({int(got.valid.sum())} valid)")
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in stereo]
    for name, a, b in zip(matching.StereoMatches._fields, matching.match_stereo(*stereo),
                          matching.match_stereo_reference(*cpu)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"hamming_match stereo {name} differs from the CPU's")
    torch.cuda.synchronize()
    if k.launches - n0 != len(cases) + 1:
        raise AssertionError(f"hamming_match: {k.launches - n0} launches, expected "
                             f"{len(cases) + 1}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = kt.sm_clock_hz()
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"[hamming-match] {k.blocks_per_sm(dev, k.STEREO)} blocks a SM "
          f"(256 threads); {sms} SMs at {clock / 1e9:.3f} GHz")
    out = {}
    for label, (fn, plain, args, A) in cases.items():
        # Timed as the frame programs run them, replays of a captured graph:
        # the wrapper's Python (~0.1 ms a call) would outlast cuda_ms's spin.
        kernel, ref = graph_replay(lambda: fn(*args)), graph_replay(lambda: plain(*args))
        rec = {"ms": kt.cuda_ms(kernel),
               "ms_l2_cold": kt.cuda_ms(kernel, setup=kt.l2_flush("cuda")),
               "plain_ms": kt.cuda_ms(ref)}
        rec["bound_ms"], rec["bound_by"] = kt.hamming_match_bound(Q, D, A, sms, clock)
        rec["roofline_share"] = rec["bound_ms"] / rec["ms_l2_cold"]
        print(f"[hamming-match] {label} median over 20 runs at {Q} x {D}, A = {A}: kernel "
              f"{rec['ms']:.4f} ms warm, {rec['ms_l2_cold']:.4f} ms with L2 flushed; plain "
              f"version {rec['plain_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), {100 * rec['roofline_share']:.1f}% of it ({card})")
        out[f"hamming_match {label}"] = {"shape": f"{Q}x{D}", "A": A, **rec}
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


def fresh_programs():
    """Forget the shared tracker, modular, query, ICP, pose-graph and BA
    programs: the engine built next runs its first frame (and its first
    query a key, ICP batch a bucket, pose-graph solve and BA a size)
    eagerly, as the first engine of a process does."""
    from vslam_tpu_torch.backend import ba
    from vslam_tpu_torch.backend import pose_graph as pg
    from vslam_tpu_torch.loop import relocalizer as rl
    from vslam_tpu_torch.tracking import fused, modular

    fused.clear_programs()
    modular.clear_programs()
    rl.clear_query_programs()
    rl.clear_icp_programs()
    pg.clear_programs()
    ba.clear_programs()


def run_engine(cam, cfg, frames, device, n_frames, harvest_every=None):
    from vslam_tpu_torch.system.engine import SlamEngine

    fresh_programs()
    engine = SlamEngine(cam, cfg, landmark_capacity=65536, device=device)
    if harvest_every is not None:
        engine.tracker.harvest_every = harvest_every
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


# ms/frame over the run, peak device MiB and launches by batch size of
# each drive_slice run, by label.
RUN_MS, PEAK_MIB, BATCHES = {}, {}, {}


def drive_slice(label, cam, cfg, gt_poses, frames, expect, local_maps, cpu_frames, card,
                cpu_harvest=None):
    """One run on the card through engine.process, with the launch counts
    zeroed just before it and read just after; checks and prints it, then
    compares its first frames with the same engine on the CPU (draining
    every cpu_harvest frames when given: the split front-end's chunks are
    the drains).  Returns the counts."""
    from vslam_tpu_torch.eval import trajectory as traj_eval

    from vslam_tpu_torch.eval import workloads

    n = len(frames)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    events = workloads.program_events()
    engine, traj, wall, times = run_engine(cam, cfg, frames, "cuda", n)
    counts = read_counts()
    events = workloads.program_events() - events
    BATCHES[label] = read_batches()
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
    print(f"[{label}] program events: "
          + ", ".join(f"{k} {v}" for k, v in sorted(events.items())))
    ms_frame = 1e3 * wall / n
    RUN_MS[label] = ms_frame
    # The second half alone: past the first runs' warm-ups, and for the
    # split front-end its second chunk whole (dispatched at its last frame).
    RUN_MS[label + " 2nd half"] = 1e3 * sum(times[n // 2:]) / (n - n // 2)
    PEAK_MIB[label] = torch.cuda.max_memory_allocated() / 2**20
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

    _, traj_cpu, _, _ = run_engine(cam, cfg, frames, "cpu", cpu_frames, cpu_harvest)
    dev = np.abs(traj[:cpu_frames, :3, 3] - traj_cpu[:, :3, 3]).max()
    print(f"[{label}] first {cpu_frames} positions: card vs CPU max |diff| {dev:.2e} m")
    if not dev <= CPU_CHECK_TOL_M:
        raise AssertionError(f"{label}: card and CPU trajectories differ by {dev} m")
    return counts


def config_slice(label, name, cam_args, n_frames, circle_frames, radius, per_frame,
                 local_maps, cpu_frames, card):
    """A shipped configuration, open loop, on the first n_frames frames of
    a synthetic circle."""
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configurations", f"configuration_{name}.yaml"))
    cfg.command_line.option_disable_relocalization = True
    cam = cam_ops.make_camera(**cam_args)
    gt, frames = circle_slice(cam, circle_frames, radius, n_frames)
    expect = {k: per_frame.get(k, 0) * n_frames for k in FRONT_END_KERNELS}
    return drive_slice(label, cam, cfg, gt, frames, expect, local_maps, cpu_frames, card)


def phase_kitti_config(card):
    """Phase 6b: configuration_kitti.yaml, open loop, on the first half of
    its circle (phase 12 runs all of it from disk)."""
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    cam = cam_ops.make_camera(**KITTI_CAM)
    gt, frames = kitti_world(cam, KITTI_SLICE_FRAMES)
    print(f"[kitti-config] the JAX engine on a CPU: {JAX_CPU_KITTI_CONFIG}")
    return drive_slice("kitti-config", cam, kitti_config(load_config), gt, frames,
                       {"K1": 0, "K2": KITTI_SLICE_FRAMES, "K3": 2 * KITTI_SLICE_FRAMES, "K4": 0,
                        "fast_cells": 2 * KITTI_SLICE_FRAMES, "box_blur": 3 * KITTI_SLICE_FRAMES},
                       within_15_percent(JAX_CPU_KITTI_CONFIG["n_local_maps"]),
                       KITTI_CPU_FRAMES, card)


def phase_closed_loop(label, cam, cfg, world, frames, jax_cpu, card_before, card,
                      record=None):
    """A closed-loop engine run on the card through tracker.prestage +
    process_prestaged, the launch counts zeroed just before it and read
    just after; checked against phase 7's limits and held to the events
    and ATE of card_before (the card's run before the program).  With BA
    on it also
    requires >= 1 BA run and prints each BA problem's size and the BA
    stage.  Returns the launch counts.  `record` (a dict) receives the
    inputs of every closure ICP batch ("icp": (data, mask, T0, config)),
    the last BA window problem, its config and its true (P, L) ("ba"),
    the inputs of the last pose-graph solve ("pg": args, kwargs) and the
    engine ("engine"), for phases 17, 19 and 24."""
    from vslam_tpu_torch.backend import pose_graph as pg
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.loop import relocalizer as rl
    from vslam_tpu_torch.solve import aligners
    from vslam_tpu_torch.system import ba_runner
    from vslam_tpu_torch.system.engine import SlamEngine
    from vslam_tpu_torch.utils import log

    n = len(frames)
    ba_on = cfg.graph_optimization.enable_full_bundle_adjustment
    fresh_programs()
    engine = SlamEngine(cam, cfg, landmark_capacity=65536, device="cuda")
    handles = engine.tracker.prestage(frames)
    sizes = []  # (P, L) of each BA problem: true, then padded
    build, solve_pg = ba_runner.build_window_problem, pg.optimize_pose_graph_hierarchical
    run_icp, dispatch = rl.ICPProgram.run, rl.Relocalizer.dispatch_icp_batch
    query = rl.Relocalizer._query_and_insert
    icp_events, drains = [], []  # (start, end, how) of each ICP batch; jobs a dispatch
    if record is not None:
        record.update(icp=[], query=[], engine=engine)

    def build_and_record(*args, **kwargs):
        built = build(*args, **kwargs)
        if built is not None:
            prob, kf_ids, slots = built
            sizes.append(((len(kf_ids), len(slots)), (prob.T_wc.shape[0], prob.xyz.shape[0])))
            if record is not None:
                record["ba"] = (prob, ba_runner.ba_config(engine), (len(kf_ids), len(slots)))
        return built

    def pg_recorded(*args, **kwargs):
        if record is not None:
            record["pg"] = (args, kwargs)
        return solve_pg(*args, **kwargs)

    def icp_timed(prog, mov, fix, mask, T0):
        """One ICP batch between two CUDA events; its inputs recorded."""
        if record is not None:
            record["icp"].append((aligners.ICPData(mov.clone(), fix.clone(),
                                                   torch.ones(mov.shape[:2], device="cuda")),
                                  mask.clone(), T0.clone(), prog.config))
        how = "eager" if prog.uses == 0 else "capture" if prog.graph is None else "replay"
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = run_icp(prog, mov, fix, mask, T0)
        end.record()
        icp_events.append((start, end, how))
        return res

    def dispatch_counted(rel, candidates):
        jobs = dispatch(rel, candidates)
        if jobs:
            drains.append(len(jobs))
        return jobs

    def query_recorded(rel, q_desc, dest, row_map_id, max_map_id, prefix):
        """A drain's query program run; its key, inputs and the database
        before it recorded (phase 25)."""
        if record is not None:
            p = rel.params
            key = (q_desc.shape[0], q_desc.shape[1], prefix, rel.capacity,
                   int(p.maximum_descriptor_distance), int(p.minimum_second_best_margin),
                   rel.device)
            record["query"].append((key, (q_desc.clone(), dest.copy(), row_map_id.copy(),
                                          max_map_id.copy()),
                                    rel.db_desc.clone(), rel.db_map_id.clone()))
        return query(rel, q_desc, dest, row_map_id, max_map_id, prefix)

    ba_runner.build_window_problem = build_and_record
    pg.optimize_pose_graph_hierarchical = pg_recorded
    rl.ICPProgram.run = icp_timed
    rl.Relocalizer.dispatch_icp_batch = dispatch_counted
    rl.Relocalizer._query_and_insert = query_recorded
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
        pg.optimize_pose_graph_hierarchical = solve_pg
        rl.ICPProgram.run, rl.Relocalizer.dispatch_icp_batch = run_icp, dispatch
        rl.Relocalizer._query_and_insert = query
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
              f"problem, true and padded: {sizes}")
    icp_check(label, icp_events, drains, card)
    if counts != {"K1": n, "K2": 0, "K3": 0, "K4": 0, "fast_cells": 0, "box_blur": 0}:
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
    got["n_ba_runs"] = rep["n_ba_runs"]
    before = {k: got[k] for k in card_before}
    if before != card_before:
        raise AssertionError(f"{label}: {before}, the card gave {card_before} before the "
                             "fused tracker ran as a replayed graph")
    print(f"[{label}] the events and ATE of the card's eager run before the program: "
          f"{card_before}; {rep['tracker_step']}")
    return counts


def icp_check(label, icp_events, drains, card):
    """The closure ICP programs of a closed-loop run (the process's
    shared programs, emptied by fresh_programs before the run): each captured
    bucket's last replay bit-equal to the eager solve of the same padded
    batch (its input buffers still hold it); the device ms of the ICP
    batches (CUDA events around each ICPProgram.run) by route, and ICP ms
    a drain that dispatched ICP (the capturing batch, whose window holds
    the host's capture, left out)."""
    from vslam_tpu_torch.loop import relocalizer as rl

    progs = rl._PROGRAMS
    captured = [(key, p) for key, p in progs.items() if p.graph is not None]
    timing = []
    for key, prog in captured:
        want = prog.eager()
        for name, a, b in zip(want._fields, prog.out, want):
            if not torch.equal(a, b):
                raise AssertionError(f"[{label}] ICP bucket {key}: the replay's {name} "
                                     f"differs from the eager batch's")
        # The last batch again, eagerly and as replays, on warm buckets.
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        eager_ms, replay_ms = [], []
        for _ in range(3):
            start.record()
            prog.eager()
            end.record()
            torch.cuda.synchronize()
            eager_ms.append(start.elapsed_time(end))
            start.record()
            prog.graph.replay()
            end.record()
            torch.cuda.synchronize()
            replay_ms.append(start.elapsed_time(end))
        iters = [v for _, _, v in prog.record.read()]
        timing.append(f"bucket {key[1]}: eager {statistics.median(eager_ms):.3f} ms, replay "
                      f"{statistics.median(replay_ms):.3f} ms (WHILE iterations {iters})")
    ms = {}
    for start, end, how in icp_events:
        ms.setdefault(how, []).append(start.elapsed_time(end))
    timed = sum(sum(v) for how, v in ms.items() if how != "capture")
    by_route = ", ".join(f"{len(v)} {how} ({statistics.mean(v):.3f} ms a batch)"
                         for how, v in ms.items())
    print(f"[{label}] closure ICP: {len(icp_events)} batches over {len(drains)} drains "
          f"({sum(drains)} candidates), buckets {sorted(k[1] for k in progs)}: {by_route}; "
          f"{timed / max(len(drains) - ('capture' in ms), 1):.3f} ms of ICP a drain; "
          f"{len(captured)} captured bucket(s), each replay bit-equal to its eager batch; "
          f"its last batch again (median of 3, CUDA events): {'; '.join(timing)} ({card})")


def replay_checks(label, progs, state, card):
    """Each program of `progs` (name -> StaticProgram; one that ran only
    once, eagerly, is captured here) from the state its run ended in
    (`state()`: the tensors the programs read and write, put back before
    every run): its eager run and two replays give the same outputs and
    state bit for bit, the replays under torch.cuda.set_sync_debug_mode(
    "error") (a synchronization inside raises); its conditional nodes decide as the eager run's loops
    (check_record: each WHILE node's iterations against the eager loop's
    active rounds); eager and replayed ms (kernel_timing.cuda_ms, medians
    of 3, the state put back before each).  Returns {name: (eager ms,
    replayed ms, WHILE iterations a replay)}."""
    from torch.utils import _pytree as pytree

    from vslam_tpu_torch.frontend import kernel_timing as kt
    from vslam_tpu_torch.ops import control

    start = [t.clone() for t in state()]

    def restore():
        for d, s in zip(state(), start):
            d.copy_(s)

    def taken(out):
        return [t.clone() for t in pytree.tree_leaves(out)] + [t.clone() for t in state()]

    out, late = {}, []
    for name, prog in progs.items():
        if prog.uses == 0:
            raise AssertionError(f"[{label}] the {name} program never ran")
        restore()
        if prog.graph is None:  # it ran once, eagerly: captured here
            prog.capture()
            late.append(name)
        with control.recording() as rec:
            want = taken(prog.eager())
        got = []
        for _ in range(2):
            restore()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                prog.graph.replay()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got.append(taken(prog.out))
        for i, (a, b, c) in enumerate(zip(want, *got)):
            if not (torch.equal(a, b) and torch.equal(b, c)):
                raise AssertionError(f"[{label}] the {name} program: output or state tensor "
                                     f"{i} of a replay differs from its eager run's")
        values, reached = check_record(f"{label} {name}", 0, prog, rec)
        iters = sum(v for (k, _, v), r in zip(values, reached) if k == "while" and r)
        out[name] = (kt.cuda_ms(prog.eager, 3, restore), kt.cuda_ms(prog.graph.replay, 3, restore),
                     iters)
    restore()
    print(f"[{label}] programs from the run's last state: eager run and two replays equal bit "
          f"for bit (outputs and state), no synchronization inside a replay, WHILE nodes as "
          f"the eager run's active rounds; eager / replayed ms (median of 3, CUDA events), "
          f"WHILE iterations: "
          + "; ".join(f"{k} {e:.3f} / {r:.3f} ms, {w}"
                      for k, (e, r, w) in out.items())
          + (f"; captured here (one eager run in the run): {late}" if late else "")
          + f" ({card})")
    return out


def phase_modular_closed(cam, cfg, world, frames, card):
    """Phase 20: the closed loop on the modular tracker, through
    engine.process frame by frame (the modular engine has no prestaged
    playback), on its captured programs, the launch counts zeroed just
    before and read just after.  Held to CARD_MODULAR_CLOSED.  Returns
    the launch counts."""
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.eval import workloads
    from vslam_tpu_torch.system.engine import SlamEngine
    from vslam_tpu_torch.tracking.tracker import PoseTracker
    from vslam_tpu_torch.utils import log

    label, n, ref = "modular-closed", len(frames), JAX_CPU_MODULAR_CLOSED
    cfg = closed_loop_config(cfg)
    cfg.tracking.use_fused_tracker = False
    fresh_programs()
    engine = SlamEngine(cam, cfg, landmark_capacity=65536, device="cuda")
    if not isinstance(engine.tracker, PoseTracker):
        raise AssertionError(f"{label}: the engine built {type(engine.tracker).__name__}")
    progs = engine.tracker.programs
    track = progs.track
    # Each track replay's record slots, copied on the device (read after
    # the run): its WHILE iterations.
    slots, evaluate = [], track.evaluate

    def track_recorded():
        res = evaluate()
        if track.graph is not None:
            slots.append(track.record.slots[:len(track.record.entries)].clone())
        return res

    track.evaluate = track_recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log.chronometers.clear()
    reset_counts()
    events = workloads.program_events()
    times = []
    t0 = time.perf_counter()
    for left, right in frames:
        t1 = time.perf_counter()
        engine.process(left, right)
        times.append(time.perf_counter() - t1)
    traj = engine.trajectory
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del track.evaluate
    counts = read_counts()
    events = workloads.program_events() - events
    rep = engine.report()
    if traj.shape != (n, 4, 4) or not np.all(np.isfinite(traj)):
        raise AssertionError(f"{label}: trajectory shape {traj.shape} or non-finite poses")
    rmse, _, _ = traj_eval.ate_rmse(traj, world.poses[:n])
    got = {k: rep[k] for k in ref if k in rep}
    got.update(ate_m=round(float(rmse), 4), db_rows=engine.relocalizer.n_rows,
               closures=[(c.query_id, c.reference_id) for c in engine.world_map.closures])
    print(f"[{label}] {n} frames, card: {got}")
    print(f"[{label}] {n} frames, the JAX modular engine on a CPU: {ref}")
    print(f"[{label}] launches {counts}, {rep['n_landmarks']} landmarks")
    ms_frame = 1e3 * wall / n
    RUN_MS[label] = ms_frame
    print(f"[{label}] {ms_frame:.2f} ms/frame over the run ({1e3 / ms_frame:.2f} fps), "
          f"median {1e3 * statistics.median(times[16:]):.2f} ms/frame after the first 16, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    print(f"[{label}] program events over the run: "
          + ", ".join(f"{k} {v}" for k, v in sorted(events.items())))
    iters = [int(v.sum()) for v in torch.stack(slots).cpu()] if slots else []
    print(f"[{label}] WHILE iterations a track replay: {min(iters)}-{max(iters)} (mean "
          f"{statistics.mean(iters):.2f}) over {len(iters)} replays; the eager run takes "
          f"every GN phase to its cap ({engine.tracker.gn_config.max_iterations} + "
          f"{engine.tracker.gn_config.refine_iterations} rounds)")
    table = rep["stage_table"]
    for stage in CLOSURE_STAGES:
        row = table.get(stage, {"seconds": 0.0, "calls": 0})
        print(f"[{label}] stage {stage:24s} {row['seconds']:8.4f} s in {row['calls']} calls")
    for stage, sec in rep["stage_seconds"].items():
        print(f"[{label}] tracker stage {stage:12s} {sec:8.4f} s")
    replay_checks(label, progs.programs, lambda: [*progs.table, *progs.prev, *progs.cur,
                                                  progs.T_cur_prev, progs.prev_to_cur], card)
    if counts != {"K1": n, "K2": 0, "K3": 0, "K4": 0, "fast_cells": 0, "box_blur": 0}:
        raise AssertionError(f"{label}: launches {counts}, expected {n} K1 only")
    if rep["n_track_breaks"] != 0:
        raise AssertionError(f"{label}: {rep['n_track_breaks']} tracking breaks")
    if not rmse <= ATE_LIMIT_M:
        raise AssertionError(f"{label}: ATE {rmse:.4f} m > {ATE_LIMIT_M} m")
    lo, hi = within_15_percent(ref["n_local_maps"])
    if not lo <= rep["n_local_maps"] <= hi:
        raise AssertionError(f"{label}: {rep['n_local_maps']} local maps outside {(lo, hi)}")
    if not (rep["n_closures"] >= 1 and rep["n_optimizations"] == ref["n_optimizations"]
            and rep["n_merged_landmarks"] > 0):
        raise AssertionError(f"{label}: {rep['n_closures']} closures, "
                             f"{rep['n_optimizations']} optimizations, "
                             f"{rep['n_merged_landmarks']} merged landmarks")
    before = {k: got[k] for k in CARD_MODULAR_CLOSED}
    if before != CARD_MODULAR_CLOSED:
        raise AssertionError(f"{label}: {before}, the card gave {CARD_MODULAR_CLOSED} when "
                             "the modular tracker ran eagerly")
    if any(events.get(f"modular {k} eager", 0) != 1 for k in progs.programs):
        raise AssertionError(f"{label}: {dict(events)}: not one eager run a program")
    print(f"[{label}] the events and ATE of the card's eager modular run: "
          f"{CARD_MODULAR_CLOSED}")
    return counts


def query_checks(closed, card):
    """The query programs (relocalizer.query_program) on phase 7's own
    query batches, each from the database it met, fresh: captured, its
    eager run and two replays bit-equal (best, ok and the database after
    the insert) with no synchronization inside a replay (replay_checks);
    then one at the scale run's largest prefix (SCALE_PREFIX rows
    searched, SCALE_DB_ROWS live, SCALE_SB queries of phase 7's width) on
    a random database, the same checks and its peak device memory."""
    from vslam_tpu_torch.loop import relocalizer as rl

    def check(label, key, inputs, db_desc, db_map_id):
        rl.clear_query_programs()
        prog = rl.query_program(*key)
        store = rl._database(key[3], key[6])

        def load():
            store.desc.copy_(db_desc)
            store.map_id.copy_(db_map_id)
            prog.load(inputs)

        load()
        prog.evaluate()  # eager
        load()
        prog.evaluate()  # captured, replayed
        load()
        return replay_checks(label, {f"SB {key[0]} prefix {key[2]}": prog},
                             lambda: [store.desc, store.map_id], card)

    batches = closed["query"]
    if not batches:
        raise AssertionError("[query] phase 7 ran no query")
    for i, (key, inputs, db_desc, db_map_id) in enumerate(batches):
        check(f"query {i}", key, inputs, db_desc, db_map_id)
    key = batches[-1][0]
    CAP, capacity, dev = key[1], key[3], key[6]
    rng = np.random.default_rng(0)
    db_desc = torch.from_numpy(rng.integers(0, 2**32, (capacity, 8), dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(dev)
    db_desc[SCALE_DB_ROWS:] = 0
    db_map_id = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    db_map_id[:SCALE_DB_ROWS] = torch.from_numpy(
        np.sort(rng.integers(0, 320, SCALE_DB_ROWS)).astype(np.int32)).to(dev)
    q = db_desc[torch.from_numpy(rng.integers(0, SCALE_DB_ROWS, (SCALE_SB, CAP))).to(dev)]
    q[:, CAP // 2:] = torch.from_numpy(rng.integers(0, 2**31, (SCALE_SB, CAP - CAP // 2, 8))
                                       .astype(np.int32)).to(dev)
    dest = np.full(SCALE_SB * CAP, -1, np.int32)
    dest[CAP // 2::2] = SCALE_DB_ROWS + np.arange(len(dest[CAP // 2::2]))
    row_mid = np.where(dest >= 0, 330, 0).astype(np.int32)
    maxm = (320 - 20 - np.arange(SCALE_SB)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = check("query scale", (SCALE_SB, CAP, SCALE_PREFIX) + key[3:],
                (q, dest, row_mid, maxm), db_desc, db_map_id)
    print(f"[query scale] {SCALE_SB} x {CAP} query rows against {SCALE_PREFIX} rows "
          f"({SCALE_DB_ROWS} live): peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB over its eager run, capture "
          f"and replays ({card})")
    rl.clear_query_programs()
    return res


def phase_modular_configs(closed, card):
    """Phase 25: configuration_kitti.yaml (staged front-end: K2 + K3 from
    the front-end program) and configuration_tum.yaml (RGB-D: K3) on the
    modular tracker, MODULAR_CONFIG_FRAMES frames each (phases 6b and 9's
    sequences), held to the fused runs' limits and their launch counts;
    then the query programs (query_checks).  Returns the launch counts."""
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    n = MODULAR_CONFIG_FRAMES
    cam = cam_ops.make_camera(**KITTI_CAM)
    gt, frames = kitti_world(cam, n)
    cfg = kitti_config(load_config)
    cfg.tracking.use_fused_tracker = False
    print(f"[modular kitti-config] the JAX (fused) engine on a CPU: {JAX_CPU_KITTI_CONFIG}")
    kitti = drive_slice("modular kitti-config", cam, cfg, gt, frames,
                        {"K1": 0, "K2": n, "K3": 2 * n, "K4": 0, "fast_cells": 2 * n,
                         "box_blur": 3 * n},
                        within_15_percent(JAX_CPU_KITTI_CONFIG["n_local_maps"]),
                        KITTI_CPU_FRAMES, card)
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configurations", "configuration_tum.yaml"))
    cfg.tracking.use_fused_tracker = False
    cam = cam_ops.make_camera(**TUM_CAM)
    gt, frames = tum_world(cam, TUM_FRAMES, n)
    print(f"[modular tum-config] the JAX (fused) engine on a CPU: {JAX_CPU_TUM}")
    tum = drive_slice("modular tum-config", cam, cfg, gt, frames,
                      {"K1": 0, "K2": 0, "K3": n, "K4": 0, "fast_cells": n, "box_blur": n},
                      within_15_percent(JAX_CPU_TUM["n_local_maps"]), TUM_CPU_FRAMES, card)
    query_checks(closed, card)
    return {k: kitti[k] + tum[k] for k in kitti}


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
                       {"K1": 0, "K2": 0, "K3": TUM_CONFIG_FRAMES, "K4": 0,
                        "fast_cells": TUM_CONFIG_FRAMES, "box_blur": TUM_CONFIG_FRAMES},
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
                       # ORB256 blurs the image to describe the front end's
                       # keypoints, and again to describe recovery's.
                       {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "fast_cells": XTION_FRAMES,
                        "box_blur": 2 * XTION_FRAMES},
                       within_15_percent(JAX_CPU_XTION["n_local_maps"]), TUM_CPU_FRAMES, card)


# The kernels' symbols in their sources: K1's, and the one dense-BRIEF
# kernel that K2, K3 and K4 launch with different tables.
KERNEL_SYMBOLS = {"K1": "fast_brief_tile_kernel", "K2-K4": "dense_brief_kernel",
                  "fast_cells": "fast_cells_kernel", "box_blur": "box_blur_kernel"}


def profiled_replays(label, prog, inputs):
    """Replays prog once for each frame of inputs under torch.profiler and
    counts, in the device's own kernel records, the kernels of K1 and of
    K2-K4 by name.  Each must equal the launches that the wrappers'
    counters add for those replays (the capture's counts, once a replay),
    so the counts the smoke reports are launches the card made.  Returns
    the CUDA kernel records."""
    from torch.profiler import ProfilerActivity, profile

    before = read_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for imgs in inputs:
            prog.run(imgs)
        torch.cuda.synchronize()
    added = {k: read_counts()[k] - before[k] for k in before}
    # The raw kineto records: building prof.events() for ~900,000 kernels
    # takes the host ~4x longer (78 s against 22 s on an H100 host).
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    seen = {k: sum(sym in e.name() for e in kernels) for k, sym in KERNEL_SYMBOLS.items()}
    want = {"K1": added["K1"], "K2-K4": added["K2"] + added["K3"] + added["K4"],
            "fast_cells": added["fast_cells"], "box_blur": added["box_blur"]}
    if seen != want or not kernels:
        raise AssertionError(f"[{label}] {len(inputs)} replays ran {seen} kernels by name, "
                             f"the counters added {want}")
    print(f"[{label}] {len(inputs)} profiled replays: {seen} kernels by name in the "
          f"device's records, as the counters added")
    return kernels


def check_record(label, i, prog, eager_rec):
    """After frame i: the program's conditional nodes against the eager
    step's record (control.recording) of the same frame -- the same loops
    and conds; each WHILE node reached ran as many iterations as the
    eager loop's active rounds, each cond's predicate is the eager one's,
    and a loop in a branch not taken ran none.  Returns (the record's
    values, which entries were reached)."""
    got = prog.record.read()
    want = eager_rec.read()
    if [(k, p) for k, p, _ in got] != [(k, p) for k, p, _ in want]:
        raise AssertionError(f"[{label}] frame {i}: the program's loops and conds "
                             f"{[(k, p) for k, p, _ in got]} differ from the eager step's")
    reached = prog.record.reached(got)
    for (kind, _, g), (_, _, w), r, name in zip(got, want, reached, prog.record.names()):
        if (g != w) if r else (g != 0):
            raise AssertionError(f"[{label}] frame {i}: {kind} {name!r} gave {g} in the "
                                 f"replay, the eager step {w} (reached: {r})")
    return got, reached


def while_iterations(values, reached, names):
    """Total WHILE iterations of one replay, and those of attempt 1's two
    GN phases (the loops reached outside every cond)."""
    total = sum(v for (k, _, v), r in zip(values, reached) if k == "while" and r)
    first = [v for (k, p, v), n in zip(values, names) if k == "while" and p is None]
    return total, tuple(first[:2])


def program_parity(label, cam, cfg, frames, card, measure=False):
    """The eager fused.step and the FrameProgram side by side on the card
    from the same start: after every frame every state tensor must be
    equal bit for bit, and the replay's conditional nodes must have
    decided as the eager step (check_record).  The program's first frame
    runs eagerly, then it is captured, and every replay runs under
    torch.cuda.set_sync_debug_mode("error"), so a synchronization inside
    a frame raises.  Prints the WHILE iterations a replay.  With measure,
    also ms/frame of both paths, the host's enqueue time of a replay, and
    on a second program over the same frames: ms a replay by CUDA events
    and device-busy ms and kernels a replay (torch.profiler), the
    capture's seconds and peak memory.  Returns (the launch counts of the
    program's frames, its replays' included; each replay's (record values,
    entries reached, entry names); the final kf_count)."""
    from vslam_tpu_torch.ops import control
    from vslam_tpu_torch.tracking import fused
    from vslam_tpu_torch.tracking import tracker as ttr

    dev = torch.device("cuda")
    params = ttr.params_from_config(cam, cfg, dev)
    fp, tr = cfg.framepoint_generation, cfg.tracking
    motion_on = tr.motion_model == "CONSTANT_VELOCITY"
    calib = ttr._depth_calibration(fp, dev)
    dtype = np.uint8 if params.mode == "stereo" else np.float32
    staged = torch.from_numpy(np.stack([np.stack(f) for f in frames]).astype(dtype)).to(dev)
    thr0 = fp.detector_threshold_starting_value

    def program():
        return fused.FrameProgram(cam, params, fused.init_state(cam, params, 65536, thr0),
                                     motion_on, staged.dtype, depth_calib=calib)

    eager = fused.init_state(cam, params, 65536, thr0)
    prog = program()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    prog_counts = dict.fromkeys(read_counts(), 0)
    eager_ms, prog_ms, enqueue_ms, iters, records = [], [], [], [], []
    for i, imgs in enumerate(staged):
        t0 = time.perf_counter()
        with control.recording() as eager_rec:
            eager = fused.step(cam, params, eager, imgs, motion_on, None, calib)
        torch.cuda.synchronize()
        eager_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 1:
            prog.capture()
        launches_before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            prog.run(imgs)
            t1 = time.perf_counter()
        else:
            torch.cuda.set_sync_debug_mode("error")
            try:
                prog.run(imgs)
                t1 = time.perf_counter()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        prog_ms.append(1e3 * (time.perf_counter() - t0))
        enqueue_ms.append(1e3 * (t1 - t0))
        frame_counts = {k: read_counts()[k] - launches_before[k] for k in launches_before}
        if i == 0:
            first = frame_counts
        elif frame_counts != first:
            raise AssertionError(f"[{label}] frame {i}: the replay counted {frame_counts} "
                                 f"launches, its eager first frame {first}")
        prog_counts = {k: prog_counts[k] + frame_counts[k] for k in prog_counts}
        for (name, a), (_, b) in zip(fused.state_tensors(eager), fused.state_tensors(prog.state)):
            if not torch.equal(a, b):
                raise AssertionError(f"[{label}] frame {i}: state {name} of the program "
                                     f"differs from the eager step's")
        if i > 0:
            values, reached = check_record(label, i, prog, eager_rec)
            records.append((values, reached, prog.record.names()))
            iters.append(while_iterations(values, reached, prog.record.names()))
    counts = prog_counts
    totals = [t for t, _ in iters]
    p1 = sorted({a[0] for _, a in iters})
    p2 = sorted({a[1] for _, a in iters})
    print(f"[{label}] {len(frames)} frames: every state tensor of the program equal to the "
          f"eager step's after every frame, every conditional node deciding as the eager "
          f"step, no synchronization inside a replay; the program's launches {counts}; "
          f"{prog.record.names().count('gn phase 1')} GN WHILE pairs and {sum(k == 'if' for k, _, _ in records[0][0])} conds captured; "
          f"WHILE iterations a replay {min(totals)}-{max(totals)} (mean "
          f"{statistics.mean(totals):.2f}), attempt 1's GN phase 1 {p1} and phase 2 {p2} "
          f"rounds, as the eager step's active rounds")
    if not measure:
        profiled_replays(label, prog, staged[:2])
        return counts, records, int(prog.state.kf_count)
    steady = slice(2, None)  # past the eager first frame and the capture
    e_ms, p_ms = statistics.median(eager_ms[steady]), statistics.median(prog_ms[steady])
    q_ms = statistics.median(enqueue_ms[steady])
    # A second program over the same frames, so that the timed replays are
    # frames of the sequence in order: frames 0 to n-2P-1 as above, then P
    # replays back to back between CUDA events, then P under the profiler.
    P = PROFILED_REPLAYS
    second = program()
    for imgs in staged[:-2 * P]:
        second.run(imgs)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for imgs in staged[-2 * P:-P]:
        second.run(imgs)
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / P
    t0 = time.perf_counter()
    kernels = profiled_replays(label, second, staged[-P:])
    busy_us = sum(e.duration_ns() for e in kernels) / 1e3
    for (name, a), (_, b) in zip(fused.state_tensors(prog.state),
                                 fused.state_tensors(second.state)):
        if not torch.equal(a, b):
            raise AssertionError(f"[{label}] the second program's state {name} differs")
    print(f"[{label}] profiling {P} replays took {time.perf_counter() - t0:.1f} s of host "
          f"time")
    print(f"[{label}] eager step {e_ms:.2f} ms/frame, program {p_ms:.2f} ms/frame (median "
          f"of frames 2-{len(frames) - 1}, synchronized); host enqueue of one replay "
          f"{q_ms:.3f} ms; device busy {busy_us / 1e3 / P:.2f} ms a replay "
          f"and {len(kernels) / P:.0f} kernels a replay (torch.profiler over frames "
          f"{len(frames) - P}-{len(frames) - 1}), {replay_ms:.2f} ms a replay by CUDA events "
          f"over frames {len(frames) - 2 * P}-{len(frames) - P - 1} back to back; peak device "
          f"memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    print(f"[{label}] the fixed-cap program (every GN solve to its cap) on an H100 80GB "
          f"HBM3 at 700.00 W: {FIXED_CAP_PROGRAM['kernels']:,} kernels and "
          f"{FIXED_CAP_PROGRAM['busy_ms']} ms device-busy a replay, "
          f"{FIXED_CAP_PROGRAM['ms_frame']} ms/frame")
    return counts, records, int(prog.state.kf_count)


def guided_ladder(card):
    """The retry ladder's IF nodes on the card: eight frames of
    tests/test_torch_device_program.py's guided world (320 x 640, odometry
    guesses from the ground truth, frame 5's off by 0.15 rad of yaw, frame
    6's by 0.25 rad, frame 7 uniform noise).  For each frame the host
    ladder (attempts solved one by one, each verdict read back) gives the
    attempt it stops at; in the program's replay the cond "attempt 2"
    must take its retry branch exactly where the host ladder reaches
    attempt 2, and "attempt 3" where it reaches 3; every state tensor
    equal to the eager step's."""
    from vslam_tpu_torch.io import synthetic
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.ops import camera as cam_ops
    from vslam_tpu_torch.tracking import fused
    from vslam_tpu_torch.tracking import tracker as ttr

    def yaw(a):
        T = np.eye(4, dtype=np.float32)
        T[0, 0] = T[2, 2] = np.cos(a)
        T[0, 2], T[2, 0] = np.sin(a), -np.sin(a)
        return T

    dev = torch.device("cuda")
    cam = cam_ops.make_camera(fx=500.0, fy=500.0, cx=320.0, cy=160.0, baseline_m=0.4,
                              rows=320, cols=640)
    world = synthetic.make_world(cam, n_frames=16, n_points=2200, seed=19, step=0.4)
    noise = np.random.default_rng(0).integers(0, 256, (2, 320, 640)).astype(np.uint8)
    cfg = ParameterCollection()
    cfg.framepoint_generation.capacity = 512
    cfg.framepoint_generation.bin_size_pixels = 12
    cfg.framepoint_generation.border_pixels = 12
    params = ttr.params_from_config(cam, cfg, dev)
    eager = fused.init_state(cam, params, 16384, 20.0)
    prog = fused.FrameProgram(cam, params, fused.init_state(cam, params, 16384, 20.0),
                                 True, torch.uint8, odometry=True)
    reached, taken = [], []
    for t in range(8):
        imgs = torch.from_numpy(noise if t == 7 else np.stack(
            synthetic.render_frame(world, t)[:2]).astype(np.uint8)).to(dev)
        T = (np.linalg.inv(world.poses[t]) @ world.poses[max(t - 1, 0)]).astype(np.float32)
        T = torch.from_numpy({5: yaw(0.15), 6: yaw(0.25)}.get(t, np.eye(4, dtype=np.float32))
                             @ T).to(dev)
        cur = fused._front_end(cam, params, eager, imgs[0].float(), imgs[1].float())[0]
        weights = fused.lm_mod.landmark_weights(eager.table, eager.prev.landmark_slot)
        for k, (radius, gate, guess) in enumerate(fused._ladder_inputs(params, eager, T)):
            host = fused.frame_mod.track_and_align(cam, eager.prev, cur, guess, radius,
                                                   gate.to(torch.int32), weights,
                                                   params.gn_config)
            if bool(fused._accept(params, host)):
                break
        reached.append(k + 1)
        eager = fused.step(cam, params, eager, imgs, True, T)
        if t == 1:
            prog.capture()
        prog.run(imgs, T)
        for (name, a), (_, b) in zip(fused.state_tensors(eager), fused.state_tensors(prog.state)):
            if not torch.equal(a, b):
                raise AssertionError(f"[guided-ladder] frame {t}: state {name} differs")
        if t >= 1:
            value = dict(zip(prog.record.names(), (v for _, _, v in prog.record.read())))
            taken.append(1 + (value["attempt 2"] == 0) + (value["attempt 3"] == 0))
    if reached[1:] != [1, 1, 1, 1, 2, 3, 3] or taken != reached[1:]:
        raise AssertionError(f"[guided-ladder] the host ladder reached attempts {reached[1:]} "
                             f"on frames 1-7, the replays' IF nodes ran {taken}")
    print(f"[guided-ladder] frames 1-7 (yaw-perturbed odometry on 5 and 6, noise on 7): the "
          f"host ladder stops at attempts {reached[1:]}; each replay's IF nodes ran the "
          f"retries of exactly those attempts; every state tensor equal to the eager step's "
          f"({card})")


def split_program_parity(cam, cfg, frames, card):
    """The split front-end's route: one chunk's front-end (chunk_front_end)
    and then, frame by frame, the eager track_step beside the
    TrackProgram's replays (make_track_step, under sync debug "error"
    from the second frame), every state tensor equal after every frame.
    Each replay's conditional nodes decide as the eager tail (check_record).
    Returns the program's launch counts (its tails launch no kernel)."""
    from vslam_tpu_torch.ops import control
    from vslam_tpu_torch.tracking import fused
    from vslam_tpu_torch.tracking import tracker as ttr

    label = "device-program k1-split"
    dev = torch.device("cuda")
    params = ttr.params_from_config(cam, cfg, dev)
    thr0 = cfg.framepoint_generation.detector_threshold_starting_value
    chunk = torch.from_numpy(np.stack([np.stack(f) for f in frames]).astype(np.uint8)).to(dev)
    eager = fused.init_state(cam, params, 65536, thr0)
    prog = fused.TrackProgram(cam, params, fused.init_state(cam, params, 65536, thr0), True)
    reset_counts()
    imgs = fused._chunk_images(cam, params, chunk)
    front = fused.chunk_front_end(cam, params, eager.threshold.clone(), imgs)
    front_counts = read_counts()
    for i in range(len(frames)):
        with control.recording() as eager_rec:
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
            if not torch.equal(a, b):
                raise AssertionError(f"[{label}] frame {i}: state {name} of the program "
                                     f"differs from the eager track_step's")
        if i > 0:
            check_record(label, i, prog, eager_rec)
    counts = {k: read_counts()[k] - front_counts[k] for k in front_counts}
    print(f"[{label}] one {len(frames)}-frame chunk: every state tensor of the track "
          f"program equal to the eager track_step's after every frame, every conditional "
          f"node deciding as the eager tail, no synchronization inside a replay; the tails' "
          f"launches {counts} (the chunk's front-end "
          f"{front_counts}) ({card})")
    return counts


def phase_device_program(cam, cfg, frames, card):
    """Phase 21: the closed loop's first DEVICE_PROGRAM_FRAMES frames
    (bench.py's settings) through program_parity, measured; then one
    sequence of each other captured route (kitti-config, euroc-config,
    tum-config, xtion-config, kitti-dog) for PROGRAM_ROUTE_FRAMES frames;
    the guided ladder.  On the measured run the eviction cond must take
    its sweep on frames 31 and 63 alone and the snapshot cond fire as
    often as the state's kf_count says.  Returns the launch counts of the
    program's frames."""
    from vslam_tpu_torch.eval.workloads import closed_loop_config
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    launches, records, kf_count = program_parity(
        "device-program", cam, closed_loop_config(cfg), frames[:DEVICE_PROGRAM_FRAMES], card,
        measure=True)
    sweeps, fired = [], 0
    for i, (values, _, names) in enumerate(records, start=1):
        by_name = {}
        for (_, _, v), name in zip(values, names):
            by_name.setdefault(name, v)
        if by_name["eviction"]:
            sweeps.append(i)
        fired += by_name["snapshot"]
    if sweeps != [31, 63]:
        raise AssertionError(f"[device-program] the eviction cond swept on frames {sweeps}")
    if fired != int(kf_count):
        raise AssertionError(f"[device-program] the snapshot cond fired {fired} times, "
                             f"kf_count {int(kf_count)}")
    print(f"[device-program] the eviction IF node took its sweep on frames {sweeps} alone; "
          f"the snapshot IF node fired on {fired} frames, the state's kf_count ({card})")
    here = os.path.dirname(os.path.abspath(__file__))
    n = PROGRAM_ROUTE_FRAMES
    euroc = cam_ops.make_camera(**EUROC_CAM)
    tum = cam_ops.make_camera(**TUM_CAM)
    routes = (
        ("kitti-config", cam, kitti_config(load_config), kitti_world(cam, n)[1]),
        ("euroc-config", euroc, load_config(os.path.join(here, "configurations",
                                                          "configuration_euroc.yaml")),
         circle_slice(euroc, EUROC_CIRCLE_FRAMES, 4.0, n)[1]),
        ("tum-config", tum, load_config(os.path.join(here, "configurations",
                                                      "configuration_tum.yaml")),
         tum_world(tum, TUM_FRAMES, n)[1]),
        ("xtion-config", tum, load_config(os.path.join(here, "configurations",
                                                        "configuration_xtion.yaml")),
         tum_world(tum, XTION_CIRCLE_FRAMES, n)[1]),
        ("kitti-dog", cam, kitti_config(load_config, "DOG"), kitti_world(cam, n)[1]),
    )
    for label, route_cam, route_cfg, route_frames in routes:
        counts = program_parity(f"device-program {label}", route_cam, route_cfg,
                                route_frames, card)[0]
        launches = {k: launches[k] + counts[k] for k in launches}
    split_program_parity(cam, split_config(cfg), frames[:n], card)
    guided_ladder(card)
    return launches


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
                {"K1": 0, "K2": KITTI_SLICE_FRAMES, "K3": 2 * KITTI_SLICE_FRAMES, "K4": 0,
                 "fast_cells": 0, "box_blur": 3 * KITTI_SLICE_FRAMES},
                within_15_percent(JAX_CPU_KITTI_DOG["n_local_maps"]), KITTI_CPU_FRAMES, card)


def phase_build(card) -> dict:
    """Both nvcc builds at once; per kernel: blocks per SM and the shared
    loads of one pixel (the loads in its pixel loop, from the SASS)."""
    from vslam_tpu_torch.frontend import dense_brief as db
    from vslam_tpu_torch.frontend import detect
    from vslam_tpu_torch.frontend import fast_brief as fb
    from vslam_tpu_torch.frontend import orb
    from vslam_tpu_torch.ops.cuda_build import loop_shared_loads
    from vslam_tpu_torch.io import image
    from vslam_tpu_torch.ops import control, hamming

    t0 = time.perf_counter()
    libraries = {"K1": fb.K1.library, "K2/K3/K4": db.KERNEL.library,
                 "fast_cells": detect.FAST_CELLS.library, "box_blur": orb.BOX_BLUR.library,
                 "hamming_match": hamming.HAMMING_MATCH.library,
                 "conditional nodes": control._library, "PNG unfilter (host)": image.UNFILTER}
    for lib in libraries.values():
        lib.start()  # one compiler per source, all at once
    image.UNFILTER.load()  # seconds; the nvcc builds go on meanwhile
    fb.K1.build()
    db.KERNEL.build()
    detect.FAST_CELLS.build()
    orb.BOX_BLUR.build()
    hamming.HAMMING_MATCH.build()
    control.library()
    print(f"[build] the seven libraries built in {time.perf_counter() - t0:.2f} s of wall time")
    for name, lib in libraries.items():
        print(f"[build] {name} ({lib.src.name})")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    # name: (library, SASS name, blocks a SM, the launch that was asked
    # about, whether its largest loop is one pixel's).  The box blur's
    # pass loops have constant trip counts and unroll over several pixels.
    kernels = {"K1": (fb.K1.library, fb.K1.sass_name, fb.K1.blocks_per_sm(dev), "", True)}
    for name, table in (("K2", 0), ("K3", 0), ("K4", 6)):
        kernels[name] = (db.KERNEL.library, db.KERNEL.sass_name(table),
                         db.KERNEL.blocks_per_sm(dev, table), "", True)
    kernels["fast_cells"] = (detect.FAST_CELLS.library, detect.FAST_CELLS.sass_name,
                             detect.FAST_CELLS.blocks_per_sm(dev, 16), " at bin 16", True)
    for name, radius in (("box_blur", 2), ("box_blur r7", 7)):
        kernels[name] = (orb.BOX_BLUR.library, orb.BOX_BLUR.sass_name(radius),
                         orb.BOX_BLUR.blocks_per_sm(dev, radius), f" at radius {radius}", False)
    facts, sass = {}, {}
    for name, (lib, fn, blocks, at, one_pixel) in kernels.items():
        try:
            if lib not in sass:
                sass[lib] = lib.sass()
            loads = loop_shared_loads(sass[lib], fn) or None
            why = "" if loads else "no pixel loop found in the SASS"
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            loads, why = None, str(e)
        read = loads if loads else f"null ({why})"
        if one_pixel:
            facts[name] = {"blocks_per_sm": blocks, "lds_per_pixel": loads}
            what = f"{read} shared loads a pixel"
        else:
            facts[name] = {"blocks_per_sm": blocks, "lds_per_pixel": None,
                           "lds_largest_loop": loads}
            what = (f"null shared loads a pixel (its loops unroll over several pixels), "
                    f"{read} in its largest loop")
        print(f"[build] {name}: {blocks} blocks of 256 threads per SM{at}, {what} ({card})")
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
    got = {k: v for k, v in run["kernel_launches"].items() if k in FRONT_END_KERNELS}
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
              {"K1": 0, "K2": KITTI_CIRCLE_FRAMES, "K3": 2 * KITTI_CIRCLE_FRAMES, "K4": 0,
               "fast_cells": 2 * KITTI_CIRCLE_FRAMES, "box_blur": 3 * KITTI_CIRCLE_FRAMES})
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
    if counts != {"K1": 0, "K2": n_after, "K3": 2 * n_after, "K4": 0, "fast_cells": 2 * n_after,
                  "box_blur": 3 * n_after}:
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
              {"K1": 0, "K2": 0, "K3": len(frames), "K4": 0, "fast_cells": len(frames),
               "box_blur": len(frames)})
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
        launches = {k: counts[k] for k in FRONT_END_KERNELS}
        for more in (phase_checkpoint(est, decoded, cam, gt, ckpt, save_s, card),
                     phase_tum_disk(tmp, card)):
            launches = {k: launches[k] + more[k] for k in launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phases 15-19: the split front-end, FAST-ICP, the chain pose graph and the
# sharded database search and BA
# ---------------------------------------------------------------------------

CHAIN_POSES = 64
CHAIN_TOL = 1e-4
FAST_ICP_TOL = 1e-4
FAST_ICP_GN_TOL_M = 5e-3  # JAX's tests/test_anderson.py test_fast_icp_matches_gn_icp
SHARD_RANKS = 2
SHARD_TIMEOUT_S = 300


def split_config(cfg):
    """A configuration with the split front-end on (tracking.batch_frontend);
    the card's chunk is parallelism.frames_per_chunk = SPLIT_CHUNK frames."""
    import copy

    cfg = copy.deepcopy(cfg)
    cfg.tracking.batch_frontend = True
    cfg.parallelism.frames_per_chunk = SPLIT_CHUNK
    return cfg


def chunk_stack(frames):
    """The 2k images of a chunk as the split front-end stacks them: (2k, H,
    W) f32 of the uint8 frames, frame i's left at 2i and right at 2i+1."""
    pairs = np.stack([np.stack(f) for f in frames]).astype(np.uint8).astype(np.float32)
    return torch.from_numpy(pairs.reshape((-1,) + pairs.shape[2:])).cuda()


def phase_k1_split(cam, cfg, world, frames, card):
    """Phase 15: phase 6a's 64 frames with tracking.batch_frontend: K1 runs
    once a 32-frame chunk over its 64 images (B = 64) and is held bit-equal
    to its plain version at that shape; ms/frame beside phase 6a's."""
    from vslam_tpu_torch.frontend import fast_brief as fb

    print(f"[k1-split] the JAX engine on a CPU (chunks of {SPLIT_CHUNK}): {JAX_CPU_K1_SPLIT}")
    n = SPLIT_K1_FRAMES
    counts = drive_slice("k1-split", cam, split_config(cfg), world.poses[:n], frames[:n],
                         {"K1": n // SPLIT_CHUNK, "K2": 0, "K3": 0, "K4": 0, "fast_cells": 0,
                          "box_blur": 0},
                         within_15_percent(JAX_CPU_K1_SPLIT["n_local_maps"]),
                         CPU_CHECK_FRAMES, card, cpu_harvest=SPLIT_CHUNK)
    batches = BATCHES["k1-split"]
    print(f"[k1-split] launches by batch size {batches}; {RUN_MS['k1-split']:.2f} ms/frame "
          f"over its {n} frames against phase 6a's per-frame path {RUN_MS['k1-slice']:.2f} "
          f"over 64 in this call (phase 6a is the call's first engine; its frames 32-63 "
          f"alone: {RUN_MS['k1-slice 2nd half']:.2f}); peak "
          f"device memory {PEAK_MIB['k1-split']:.1f} MiB against {PEAK_MIB['k1-slice']:.1f} "
          f"({card})")
    if batches != {"K1": {2 * SPLIT_CHUNK: n // SPLIT_CHUNK}}:
        raise AssertionError(f"k1-split: launches by batch size {batches}")
    imgs = chunk_stack(frames[:SPLIT_CHUNK])
    t = torch.tensor(18.0, device="cuda")
    err = 0.0
    for thr in (18.0, 40.0):
        t = torch.tensor(thr, device="cuda")
        got = fb.fast_brief_frontend_pair(imgs, t)
        ref = fb.fast_brief_frontend_pair_reference(imgs, t)
        for label, a, b in zip(("planes", "score", "rowmax", "rowarg"), got, ref):
            err = max(err, _require_equal(f"K1 {label} at B={imgs.shape[0]}", a, b))
        del got, ref
    print(f"[k1-split] K1 at {tuple(imgs.shape)} bit-equal to its plain version over every "
          "image (thresholds 18, 40)")
    from vslam_tpu_torch.frontend import kernel_timing as kt

    rec = timed(lambda: fb.fast_brief_frontend_pair(imgs, t),
                lambda: fb.fast_brief_frontend_pair_reference(imgs, t),
                kt.k1_work(*imgs.shape), imgs.numel(), kt.distinct_taps(fb.PATTERN), card,
                f"[k1-split] K1 median at {'x'.join(map(str, imgs.shape))} (plain: 3 runs)",
                plain_runs=3)
    rec.update(max_abs_err=err, shape="x".join(map(str, imgs.shape)),
               launches=batches["K1"][2 * SPLIT_CHUNK])
    return counts, rec


def phase_kitti_split(card):
    """Phase 16: phase 6b's 32 frames with the split front-end: the staged
    path's level-0 planes of the chunk's 64 images in one K2 launch, held
    bit-equal to its plain version at that shape."""
    from vslam_tpu_torch.frontend import dense_brief as db
    from vslam_tpu_torch.frontend import kernel_timing as kt
    from vslam_tpu_torch.frontend import orb
    from vslam_tpu_torch.io.config import load_config
    from vslam_tpu_torch.ops import camera as cam_ops

    cam = cam_ops.make_camera(**KITTI_CAM)
    gt, frames = kitti_world(cam, KITTI_SLICE_FRAMES)
    n = KITTI_SLICE_FRAMES
    print(f"[kitti-split] the JAX engine on a CPU (chunks of {SPLIT_CHUNK}): "
          f"{JAX_CPU_KITTI_SPLIT}")
    counts = drive_slice("kitti-split", cam, split_config(kitti_config(load_config)), gt,
                         frames, {"K1": 0, "K2": n // SPLIT_CHUNK, "K3": 2 * n, "K4": 0,
                                  "fast_cells": 2 * (n // SPLIT_CHUNK),
                                  "box_blur": n // SPLIT_CHUNK + 2 * n},
                         within_15_percent(JAX_CPU_KITTI_SPLIT["n_local_maps"]),
                         KITTI_CPU_FRAMES, card,
                         cpu_harvest=SPLIT_CHUNK)
    batches = BATCHES["kitti-split"]
    print(f"[kitti-split] launches by batch size {batches}; {RUN_MS['kitti-split']:.2f} "
          f"ms/frame against phase 6b's {RUN_MS['kitti-config']:.2f}; peak device memory "
          f"{PEAK_MIB['kitti-split']:.1f} MiB against {PEAK_MIB['kitti-config']:.1f} ({card})")
    if batches.get("K2") != {2 * SPLIT_CHUNK: n // SPLIT_CHUNK}:
        raise AssertionError(f"kitti-split: launches by batch size {batches}")
    smooth = torch.stack([orb.box_blur(im, 2) for im in chunk_stack(frames[:SPLIT_CHUNK])])
    err = _require_equal(f"K2 at B={smooth.shape[0]}", db.dense_bit_planes_batch(smooth),
                         db.dense_bit_planes_reference(smooth))
    print(f"[kitti-split] K2 at {tuple(smooth.shape)} bit-equal to its plain version")
    rec = timed(lambda: db.dense_bit_planes_batch(smooth),
                lambda: db.dense_bit_planes_reference(smooth),
                kt.dense_work(*smooth.shape), smooth.numel(), kt.distinct_taps(db.TABLES[0]),
                card, f"[kitti-split] K2 median at {'x'.join(map(str, smooth.shape))} "
                "(plain: 3 runs)", plain_runs=3)
    rec.update(max_abs_err=err, shape="x".join(map(str, smooth.shape)),
               launches=batches["K2"][2 * SPLIT_CHUNK])
    return counts, rec


def _icp_verdicts(res, mask, p):
    n = mask.sum(-1).cpu().numpy()
    inl = res.num_inliers.cpu().numpy()
    return (res.converged.cpu().numpy() & (inl >= p.icp_minimum_number_of_inliers)
            & (inl / np.maximum(n, 1) >= p.icp_minimum_inlier_ratio))


def count_syncs(fn):
    """The host synchronizations torch's sync debug mode reports in fn."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def gn_match_problem(n=120, noise=0.005, seed=11):
    """JAX's tests/test_anderson.py test_fast_icp_matches_gn_icp problem: 120
    points in a 10 m cube, a fixed twist, 5 mm noise on the fixed set."""
    from vslam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    T = lie.exp_se3(torch.tensor([0.4, -0.2, 0.3, 0.05, -0.08, 0.12])).numpy()
    mov = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    fix = (mov @ T[:3, :3].T + T[:3, 3] + rng.normal(0, noise, (n, 3))).astype(np.float32)
    return mov, fix


def phase_fast_icp(record, card):
    """Phase 17: phase 7's own closure ICP batches re-solved by FAST-ICP
    (solve/anderson.fast_icp_align) on the card and on the CPU (the same
    verdicts, accepted transforms within FAST_ICP_TOL), with GN ICP's verdicts
    (aligners.icp_align); JAX's GN-agreement problem on the card within
    FAST_ICP_GN_TOL_M of GN ICP.  On the closure batches the two robust
    estimators need not meet that bound: FAST-ICP converges to the IRLS
    fixed point (outliers kept at weight kernel / chi2), GN ICP's second
    phase refits the inliers alone, and with ~0.25 m residuals at ~10 m
    the two optima lie centimeters apart on the bench's closure batches
    (3.6-7.4 cm on a CPU and on an H100); the gap is printed.  The host
    synchronizations of one batch are counted by torch's sync debug
    mode.  The batches also run through FAST-ICP's closure ICP programs
    (relocalizer.ICPProgram, one a bucket, fresh: eager, captured,
    replayed): two replays of each batch bit-equal to each other and to
    the eager solve of its padded batch, the verdicts of the eager batch and of GN ICP, no host
    synchronization inside a replay; ms a batch eager and replayed."""
    from vslam_tpu_torch.loop import relocalizer as rl
    from vslam_tpu_torch.solve import aligners, anderson, gn

    p = record["engine"].relocalizer.params
    batches = record["icp"]
    if not batches:
        raise AssertionError("fast-icp: phase 7 dispatched no ICP batch")
    n_cand = n_acc = 0
    worst_cpu = worst_gn = worst_rej = 0.0
    for data, mask, T0, config in batches:
        fast = anderson.fast_icp_align(data, mask, T0, config)
        cpu = anderson.fast_icp_align(aligners.ICPData(*(x.cpu() for x in data)), mask.cpu(),
                                      T0.cpu(), config)
        gn_res = aligners.icp_align(data, mask, T0, config)
        v_fast, v_cpu, v_gn = (_icp_verdicts(r, mask, p) for r in (fast, cpu, gn_res))
        # Transforms are compared where the candidate is accepted: on a
        # rejected one (a wrong match, a handful of inliers) the IRLS
        # iteration has no stable optimum, and the card's and the CPU's
        # rounding walk it to different places (2.7e-3 apart on a
        # 1-inlier candidate of this workload on an H100).
        d_cpu = (fast.x.cpu() - cpu.x).abs().amax(dim=(1, 2)).numpy()
        both = v_fast & v_gn
        d_gn = (fast.x[:, :3, 3] - gn_res.x[:, :3, 3]).norm(dim=1).cpu().numpy()
        n_cand += len(v_fast)
        n_acc += int(v_fast.sum())
        worst_rej = max(worst_rej, float(d_cpu[~v_fast].max(initial=0.0)))
        if v_fast.any():
            worst_cpu = max(worst_cpu, float(d_cpu[v_fast].max()))
        if both.any():
            worst_gn = max(worst_gn, float(d_gn[both].max()))
        if not np.array_equal(v_fast, v_cpu) or worst_cpu > FAST_ICP_TOL:
            raise AssertionError(f"fast-icp: card and CPU differ (verdicts {v_fast} / {v_cpu}, "
                                 f"max |dT| {d_cpu.max():.2e})")
        if not np.array_equal(v_fast, v_gn):
            raise AssertionError(f"fast-icp: verdicts {v_fast}, GN ICP's {v_gn}")
    mov, fix = (torch.from_numpy(a)[None].cuda() for a in gn_match_problem())
    cfg = gn.GNConfig(kernel_max_error=0.5, min_num_inliers=20)
    args = (aligners.ICPData(mov, fix, torch.ones(mov.shape[:2], device="cuda")),
            torch.ones(mov.shape[:2], dtype=torch.bool, device="cuda"),
            torch.eye(4, device="cuda")[None], cfg)
    d_test = float((anderson.fast_icp_align(*args).x[0, :3, 3]
                    - aligners.icp_align(*args).x[0, :3, 3]).norm())
    if not d_test <= FAST_ICP_GN_TOL_M:
        raise AssertionError(f"fast-icp: {d_test:.4f} m from GN ICP on JAX's problem")
    data, mask, T0, config = batches[0]

    syncs = count_syncs(lambda: anderson.fast_icp_align(data, mask, T0, config))
    B = T0.shape[0]
    m3 = torch.eye(3, device="cuda").repeat(B, 1, 1) + 0.1
    m5 = torch.eye(5, device="cuda").repeat(B, 1, 1)
    per_op = {"svd (before PR 14)": count_syncs(lambda: torch.linalg.svd(m3)),
              "rotation_fit": count_syncs(lambda: anderson.rotation_fit(m3)),
              "solve_ex": count_syncs(lambda: torch.linalg.solve_ex(m5, m5[..., 0]))}
    ms_fast = _ms_per_call(lambda: anderson.fast_icp_align(data, mask, T0, config), runs=5)
    ms_gn = _ms_per_call(lambda: aligners.icp_align(data, mask, T0, config), runs=5)

    # The closure ICP programs with FAST-ICP, fresh, one a bucket.
    progs, replay_syncs = {}, []
    for data, mask, T0, config in batches:
        n = T0.shape[0]
        bucket = rl.icp_bucket(n)
        prog = progs.setdefault(bucket, rl.ICPProgram(anderson.fast_icp_align, config, bucket,
                                                      mask.shape[1], "cuda"))
        args = (data.p_moving, data.p_fixed, mask, T0)
        res = prog.run(*args)
        if prog.graph is None:  # eager: capture on the same batch
            res = prog.run(*args)
        again = []
        replay_syncs.append(count_syncs(lambda: again.append(prog.run(*args))))
        want = prog.eager()
        if not all(torch.equal(a, b) and torch.equal(b, c)
                   for a, b, c in zip(res, again[0], want)):
            raise AssertionError(f"fast-icp: the bucket-{bucket} replays differ from each other "
                                 "or from their eager batch")
        v_prog = _icp_verdicts(gn.GNResult(*(t[:n] for t in res)), mask, p)
        v_eager = _icp_verdicts(anderson.fast_icp_align(data, mask, T0, config), mask, p)
        v_gn = _icp_verdicts(aligners.icp_align(data, mask, T0, config), mask, p)
        if not (np.array_equal(v_prog, v_eager) and np.array_equal(v_prog, v_gn)):
            raise AssertionError(f"fast-icp: program verdicts {v_prog}, eager {v_eager}, GN "
                                 f"ICP {v_gn}")
    if not all(prog.graph is not None for prog in progs.values()) or any(replay_syncs):
        raise AssertionError(f"fast-icp: buckets captured "
                             f"{[b for b, q in progs.items() if q.graph is not None]} of "
                             f"{list(progs)}; host synchronizations a replay {replay_syncs}")
    timing = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for bucket, prog in sorted(progs.items()):
        ms = {}
        for how, fn in (("eager", prog.eager), ("replay", prog.graph.replay)) * 3:
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms.setdefault(how, []).append(start.elapsed_time(end))
        timing.append(f"bucket {bucket}: eager {statistics.median(ms['eager']):.3f} ms, "
                      f"replay {statistics.median(ms['replay']):.3f} ms")
    print(f"[fast-icp] the batches through FAST-ICP's closure ICP programs: "
          f"{len(batches)} runs, buckets {sorted(progs)} captured, two replays of each batch "
          f"bit-equal to each other and to its eager batch, the verdicts of the eager batch and of GN ICP; host "
          f"synchronizations a replayed run {replay_syncs}; a batch (median of 3, CUDA "
          f"events): {'; '.join(timing)} ({card})")
    print(f"[fast-icp] {len(batches)} ICP batches of phase 7, {n_cand} candidates, {n_acc} "
          f"accepted: FAST-ICP on the card and on the CPU give the same verdicts, accepted "
          f"transforms within {worst_cpu:.2e} (rejected ones {worst_rej:.2e}); GN ICP the same "
          f"verdicts, its translations {worst_gn:.4f} m "
          f"from FAST-ICP's where both accept (two robust estimators); on JAX's GN-agreement "
          f"problem {d_test:.2e} m (bound {FAST_ICP_GN_TOL_M}); a batch of {T0.shape[0]} x "
          f"{mask.shape[1]}: {syncs} host synchronizations (one call each on its batch "
          f"shapes: {per_op}; 30 rounds), "
          f"{ms_fast:.2f} ms (GN ICP {ms_gn:.2f} ms, synchronized host clock) ({card})")


def chain_problem(P=CHAIN_POSES, laps=1.2, radius=12.0, seed=5):
    """A P-pose chain on 1.2 laps of a circle with systematic odometry
    drift and three ground-truth closures from the second lap onto the
    first (tests/test_torch_pose_graph.py's drifted circle at 64 poses)."""
    from vslam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi * laps, P)
    gt = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    c, s_ = np.cos(angles), np.sin(angles)
    gt[:, 0, 0], gt[:, 0, 2], gt[:, 2, 0], gt[:, 2, 2] = c, s_, -s_, c
    gt[:, :3, 3] = np.stack([radius * c, np.zeros(P), radius * s_], 1)
    est = gt.copy()
    odo = np.zeros((P - 1, 4, 4), np.float32)
    for k in range(P - 1):
        xi = np.zeros(6, np.float32)
        xi[:3] = 1e-2 * (1 + 0.1 * rng.standard_normal(3))
        xi[4] = 5e-3 * (1 + 0.1 * rng.standard_normal())
        odo[k] = np.linalg.inv(gt[k]) @ gt[k + 1] @ lie.exp_se3(torch.from_numpy(xi)).numpy()
        est[k + 1] = est[k] @ odo[k]
    per_lap = int(P / laps)
    clo = [(j - per_lap, j) for j in (per_lap + 1, per_lap + 3, P - 1)]
    return gt, est, odo, clo


def phase_chain(card):
    """Phase 18: optimize_pose_graph_chain on a 64-pose chain with three
    closures, on the card against the CPU, both damping modes."""
    from vslam_tpu_torch.backend import pose_graph as pg

    gt, est, odo, clo = chain_problem()
    P, C = len(est), 8

    def graph(device):
        odo_T = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        odo_T[:P - 1] = odo
        clo_T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        ci = np.zeros(C, np.int64)
        cj = np.zeros(C, np.int64)
        for n, (i, j) in enumerate(clo):
            ci[n], cj[n] = i, j
            clo_T[n] = np.linalg.inv(gt[i]) @ gt[j]
        t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
        return pg.ChainPoseGraph(
            poses=t(est), odo_T=t(odo_T), odo_weight=t(np.r_[np.ones(P - 1), 0.0]
                                                       .astype(np.float32)),
            odo_valid=t(np.arange(P) < P - 1), clo_i=t(ci), clo_j=t(cj), clo_T=t(clo_T),
            clo_weight=t(np.where(np.arange(C) < len(clo), 10.0, 0.0).astype(np.float32)),
            clo_valid=t(np.arange(C) < len(clo)), pose_valid=t(np.ones(P, bool)))

    before = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    for levenberg in (False, True):
        card_poses, card_chi2 = pg.optimize_pose_graph_chain(graph("cuda"), levenberg=levenberg)
        cpu_poses, cpu_chi2 = pg.optimize_pose_graph_chain(graph("cpu"), levenberg=levenberg)
        dev = float((card_poses.cpu() - cpu_poses).abs().max())
        after = float(np.linalg.norm(card_poses.cpu().numpy()[:, :3, 3] - gt[:, :3, 3],
                                     axis=1).max())
        ms = _ms_per_call(lambda: pg.optimize_pose_graph_chain(graph("cuda"),
                                                               levenberg=levenberg), runs=5)
        print(f"[chain-pg] {P} poses, {len(clo)} closures, levenberg {levenberg}: card vs CPU "
              f"max |diff| {dev:.2e}; drift {before:.3f} m -> {after:.3f} m; chi2 "
              f"{float(card_chi2):.6g} (CPU {float(cpu_chi2):.6g}); {ms:.2f} ms a call, 10 "
              f"rounds ({card})")
        if not np.all(np.isfinite(card_poses.cpu().numpy())) or not dev <= CHAIN_TOL:
            raise AssertionError(f"chain-pg: card and CPU differ by {dev}")
        if not after < 0.5 * before:
            raise AssertionError(f"chain-pg: drift {before} -> {after}")


def shard_worker(rank, world, port, src, out):
    """One rank of phase 19 (chip_smoke.py --shard-worker ...): its row
    block of phase 7's database searched by search_sharded_top2 and by the
    relocalizer's query, and its landmark block of phase 8's BA window,
    every tensor on the card; the process group is gloo."""
    from vslam_tpu_torch.backend import ba as ba_mod
    from vslam_tpu_torch.loop import relocalizer as reloc
    from vslam_tpu_torch.ops import camera as cam_ops
    from vslam_tpu_torch.parallel import launch
    from vslam_tpu_torch.parallel import mesh as mesh_mod
    from vslam_tpu_torch.parallel import sharded_ba, sharded_search

    launch.init(rank, world, port)
    try:
        mesh = mesh_mod.make_mesh()
        a = {k: torch.from_numpy(v).cuda() for k, v in np.load(src).items()}
        db, mid, q = a["db_desc"], a["db_map_id"], a["q"]
        elig = (mid[None] >= 0) & (mid[None] <= a["bound"][:, None])
        res = {"top2": torch.stack(sharded_search.search_sharded_top2(
            q, mesh_mod.shard_rows(db, mesh), mesh_mod.shard_rows(elig, mesh, axis=1),
            mesh)).cpu().numpy()}
        none = torch.full((q.shape[0],), -1, dtype=torch.int32, device="cuda")
        best, ok, _, _ = reloc._query_and_insert_many(
            q[None], none, none, db, mid, a["bound"][:1], int(a["max_distance"]),
            int(a["min_margin"]), db.shape[0], mesh=mesh)
        res["reloc_best"], res["reloc_ok"] = best.cpu().numpy(), ok.cpu().numpy()
        prob = ba_mod.BAProblem(**{k[3:]: a[k] for k in a if k.startswith("ba_")})
        block, L = sharded_ba.shard_problem(prob, mesh)
        config = ba_mod.BAConfig(iterations=int(a["iterations"]),
                                 robust_chi2=float(a["robust_chi2"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T, xyz, chi2 = sharded_ba.bundle_adjust_sharded(
            cam_ops.make_camera(**KITTI_CAM), block, mesh, config)
        torch.cuda.synchronize()
        res["ba_seconds"] = np.asarray(time.perf_counter() - t0)
        res["ba_T"], res["ba_chi2"] = T.cpu().numpy(), chi2.cpu().numpy()
        res["ba_xyz"] = mesh_mod.all_gather_rows(xyz, mesh)[:L].cpu().numpy()
        np.savez(f"{out}{rank}.npz", **res)
    finally:
        torch.distributed.destroy_process_group()


def blocks_in_one_process(cam, prob, config, ranks=SHARD_RANKS):
    """bundle_adjust_sharded's arithmetic in one process: each rank's block
    built as shard_problem gives it, the partial systems added in rank
    order (a sum of two f32 operands does not depend on the order), the
    replicated solve.  Returns (T_wc, xyz, chi2 history)."""
    from vslam_tpu_torch.backend import ba as ba_mod
    from vslam_tpu_torch.parallel import mesh as mesh_mod
    from vslam_tpu_torch.parallel import sharded_ba

    blocks = [sharded_ba.shard_problem(prob, mesh_mod.Mesh(r, ranks, None))[0]
              for r in range(ranks)]
    T, xs, chi2s = prob.T_wc, [b.xyz for b in blocks], []
    for _ in range(config.iterations):
        parts = [ba_mod.build_reduced_system(cam, T, b._replace(xyz=x), config)
                 for b, x in zip(blocks, xs)]
        flat = [torch.cat([p[0].reshape(-1), p[1].reshape(-1), p[5].reshape(1)]).cpu()
                for p in parts]
        flat = (flat[0] + flat[1] if ranks == 2 else sum(flat)).to(T.device)
        n_S = parts[0][0].numel()
        S = flat[:n_S].reshape(parts[0][0].shape)
        b_S = flat[n_S:-1].reshape(parts[0][1].shape)
        outs = [ba_mod.solve_reduced_and_backsub(T, b._replace(xyz=x), S, b_S, *p[2:5], config)
                for b, x, p in zip(blocks, xs, parts)]
        T, xs = outs[0][0], [o[1] for o in outs]
        chi2s.append(flat[-1])
    return T, torch.cat(xs)[:prob.xyz.shape[0]], torch.stack(chi2s)


def phase_sharded(closed, ba_closed, card):
    """Phase 19: SHARD_RANKS gloo ranks on the one card (NCCL refuses two
    ranks on one device).  search_sharded_top2 and the relocalizer's
    sharded query on phase 7's final database, each rank its row block,
    exact against the one-device search; bundle_adjust_sharded on phase
    8's last BA window against the one-device bundle_adjust (poses 1e-5,
    chi2 1e-4 relative) and bit for bit against its two blocks summed in
    one process (see below)."""
    import shutil
    import tempfile

    from vslam_tpu_torch.backend import ba as ba_mod
    from vslam_tpu_torch.loop import relocalizer as reloc
    from vslam_tpu_torch.ops import hamming
    from vslam_tpu_torch.parallel import launch

    eng = closed["engine"]
    rl = eng.relocalizer
    prefix = rl._active_prefix()
    maps = eng.world_map.local_maps[-4:]  # the newest local maps as queries
    q = torch.cat([m.desc_dev for m in maps])
    interspace = rl.params.preliminary_minimum_interspace_queries
    bound = torch.repeat_interleave(torch.tensor([m.map_id - interspace for m in maps],
                                                 dtype=torch.int32), rl.QUERY_CAP)
    prob, config, _ = ba_closed["ba"]
    inputs = dict(db_desc=rl.db_desc[:prefix], db_map_id=rl.db_map_id[:prefix], q=q,
                  bound=bound, max_distance=torch.tensor(rl.params.maximum_descriptor_distance),
                  min_margin=torch.tensor(rl.params.minimum_second_best_margin),
                  iterations=torch.tensor(config.iterations),
                  robust_chi2=torch.tensor(config.robust_chi2),
                  **{"ba_" + k: getattr(prob, k) for k in prob._fields})
    tmp = tempfile.mkdtemp(prefix="vslam_shard_")
    try:
        src = os.path.join(tmp, "inputs.npz")
        np.savez(src, **{k: v.cpu().numpy() for k, v in inputs.items()})
        port = launch.free_port()
        here = os.path.abspath(__file__)
        t0 = time.perf_counter()
        launch.run_ranks(lambda r: [sys.executable, here, "--shard-worker", str(r),
                                    str(SHARD_RANKS), str(port), src,
                                    os.path.join(tmp, "rank")], SHARD_RANKS, SHARD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(SHARD_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # The one-device search, brute force on the card: first-index arg-min
    # and runner-up, a masked pair counted 511.
    db = inputs["db_desc"]
    mid = inputs["db_map_id"]
    elig = (mid[None] >= 0) & (mid[None] <= bound.cuda()[:, None])
    d = torch.where(elig, hamming.hamming_matrix_bits(q, db), 511)
    best_d, best = hamming._min_first(d, 1)
    cols = torch.arange(d.shape[1], dtype=torch.int32, device="cuda")
    second = torch.where(cols[None] == best[:, None], 511, d).amin(dim=1)
    want = torch.stack([best, best_d, second]).cpu().numpy()
    none = torch.full((q.shape[0],), -1, dtype=torch.int32, device="cuda")
    r_best, r_ok, _, _ = reloc._query_and_insert_many(
        q[None], none, none, db, mid, bound[:1].cuda(), rl.params.maximum_descriptor_distance,
        rl.params.minimum_second_best_margin, prefix)
    T1, xyz1, chi1 = (t.cpu().numpy() for t in ba_mod.bundle_adjust(eng.cam, prob, config))
    # The same solve in f64: the f32 one-device BA's own error on this window.
    f64 = {k: getattr(prob, k).double() for k in ("T_wc", "xyz", "obs_uv4", "obs_weight",
                                                  "odo_T", "odo_weight", "odo_info")}
    cam64 = eng.cam._replace(K=eng.cam.K.double(), baseline_m=eng.cam.baseline_m.double(),
                             T_cam_robot=eng.cam.T_cam_robot.double(),
                             K_inv=eng.cam.K_inv.double())
    xyz64 = ba_mod.bundle_adjust(cam64, prob._replace(**f64), config)[1].cpu().numpy()
    err_one = np.linalg.norm(xyz1 - xyz64, axis=1).max()
    T2, xyz2, chi2 = (t.cpu().numpy() for t in blocks_in_one_process(eng.cam, prob, config))
    for r, out in enumerate(outs):
        if not np.array_equal(out["top2"], want):
            raise AssertionError(f"sharded: rank {r}'s search differs from the one-device "
                                 f"search in {int((out['top2'] != want).sum())} entries")
        if not (np.array_equal(out["reloc_best"][0], r_best[0].cpu().numpy())
                and np.array_equal(out["reloc_ok"][0], r_ok[0].cpu().numpy())):
            raise AssertionError(f"sharded: rank {r}'s relocalizer query differs")
        dT = np.abs(out["ba_T"] - T1).max()
        dc = np.abs(out["ba_chi2"] / chi1 - 1).max()
        # Points are held bit for bit to the same blocks summed in one
        # process, not to 1e-4 m of the one-device BA: on this window two
        # f32 sum orders of the same solve are 1e-4 to 8e-4 m apart (the
        # one-device BA itself is 1.0e-4 m from an f64 solve on an H100
        # and 4.2e-4 m on a CPU: far landmarks).
        same = all(np.array_equal(out[k], v) for k, v in
                   (("ba_T", T2), ("ba_xyz", xyz2), ("ba_chi2", chi2)))
        if not (dT <= 1e-5 and dc <= 1e-4 and same):
            raise AssertionError(f"sharded: rank {r}'s BA poses {dT:.2e} and chi2 {dc:.2e} "
                                 f"relative from the one-device BA; bit-equal to its blocks "
                                 f"summed in one process: {same}")
    n_ok = int(r_ok.sum())
    print(f"[sharded] {SHARD_RANKS} gloo ranks on one card, {wall:.1f} s for both processes: "
          f"search_sharded_top2 of {q.shape[0]} queries over phase 7's {prefix} database rows "
          f"({rl.n_rows} live) exact against the one-device search on every rank, the "
          f"relocalizer's sharded query too ({n_ok} rows pass its gates); BA on phase 8's "
          f"window (P {prob.T_wc.shape[0]}, L {prob.xyz.shape[0]}): poses within "
          f"{np.abs(outs[0]['ba_T'] - T1).max():.2e}, points within "
          f"{np.abs(outs[0]['ba_xyz'] - xyz1).max():.2e} m, chi2 within "
          f"{np.abs(outs[0]['ba_chi2'] / chi1 - 1).max():.2e} relative of the one-device BA; "
          f"points {np.linalg.norm(outs[0]['ba_xyz'] - xyz64, axis=1).max():.2e} m from an f64 "
          f"solve (one device {err_one:.2e} m), bit-equal to the two blocks summed in one "
          f"process; "
          f"{float(outs[0]['ba_seconds']):.3f} s a sharded solve ({card})")


# Phase 24: the junction-solve tiers (keyframes, closures): two laps of
# a circle with closures 4 keyframes apart give J = 2 + 2 C junctions and
# E = J - 1 + C edges, so (Jp, Ep) = (64, 128), (128, 256), (256, 512).
PG_TIERS = ((160, 20), (320, 40), (640, 80))
PG_TIER_JP = (64, 128, 256)


def drifted_hierarchical(P, C, radius=12.0, seed=5):
    """The hierarchical solve's inputs on two laps of a circle of P
    keyframes with drifting odometry and C ground-truth closures from the
    second lap onto the first, 4 keyframes apart (none compacted with
    another): (poses, odometry, weights, closures)."""
    from vslam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    a = np.linspace(0, 4 * np.pi, P, endpoint=False)
    gt = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    gt[:, 0, 0] = gt[:, 2, 2] = np.cos(a)
    gt[:, 0, 2], gt[:, 2, 0] = np.sin(a), -np.sin(a)
    gt[:, 0, 3], gt[:, 2, 3] = radius * np.cos(a), radius * np.sin(a)
    xi = np.zeros((P - 1, 6), np.float32)
    xi[:, :3] = 2e-3 * (1 + 0.1 * rng.normal(size=(P - 1, 3)))
    xi[:, 4] = 5e-4 * (1 + 0.1 * rng.normal(size=P - 1))
    odo = (np.linalg.inv(gt[:-1]) @ gt[1:] @ lie.exp_se3(torch.from_numpy(xi)).numpy())
    est = gt.copy()
    for k in range(P - 1):
        est[k + 1] = est[k] @ odo[k]
    lap = P // 2
    clo = [(j - lap, j, np.linalg.inv(gt[j - lap]) @ gt[j])
           for j in range(lap + 2, lap + 2 + 4 * C, 4)]
    return est, odo.astype(np.float32), np.ones(P - 1, np.float32), clo


def program_checks(label, prog, inputs):
    """A fresh StaticProgram on the card: its first run eager, then the
    capture (host seconds), a replayed run with no host synchronization
    (torch's sync debug mode), that replay bit-equal to the eager solve of
    the same buffers and to a second replay.  Returns (outputs, eager ms,
    replay ms, capture s): medians of 3, CUDA events."""
    from torch.utils import _pytree as pytree

    if prog.uses != 0:
        raise AssertionError(f"[backend] {label}: the program is not fresh")
    prog.run(inputs)
    t0 = time.perf_counter()
    prog.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    syncs = count_syncs(lambda: prog.run(inputs))
    first = pytree.tree_map(torch.clone, prog.out)
    prog.graph.replay()
    second = prog.out
    eager = prog.eager()
    leaves = [pytree.tree_leaves(x) for x in (eager, first, second)]
    if syncs or not all(torch.equal(a, b) and torch.equal(b, c) for a, b, c in zip(*leaves)):
        raise AssertionError(f"[backend] {label}: {syncs} host synchronizations in a replayed "
                             "run, or a replay differs from the eager solve or the next replay")
    ms = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for how, fn in (("eager", prog.eager), ("replay", prog.graph.replay)) * 3:
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.setdefault(how, []).append(start.elapsed_time(end))
    return (first, statistics.median(ms["eager"]), statistics.median(ms["replay"]), capture_s)


def padded_against_tight(poses, odometry, odo_weight, closures, **kw):
    """The junction solve of one hierarchical problem padded to its
    buckets against the tight one, eagerly on the card, beside the tight
    f32 solve's own error (its distance from the tight solve in f64):
    (J, Jp, Ep, max |dpose| padded - tight, the f32 error, chi2 padded against
    tight and tight f32 against f64, relative).
    padding_ok holds padded within 1e-5 of tight, or within 3x the f32
    error (the system carries a 1e6 gauge anchor beside 1e-3 damping: its f32
    Cholesky is off by 5e-5 to 1.2e-3 of f64 at the tiers of phase 24,
    and padding then moves the f32 answer as much as any other sum
    order does; padded and tight agree to 1e-12 in f64)."""
    from vslam_tpu_torch.backend import pose_graph as pg

    opts = dict(iterations=kw.get("iterations", 10),
                robust_kernel_chi2=kw.get("robust_kernel_chi2", 1.0),
                levenberg=kw.get("levenberg", False))
    args = (poses, odometry, odo_weight, closures, 10.0, kw.get("closure_bucket", 4))

    def dev(g, dtype=torch.float32):
        return pg.PoseGraph(*(torch.as_tensor(a).cuda().to(
            dtype if a.dtype == np.float32 else None) for a in g))

    g, _, J, _ = pg.junction_graph(*args)
    tight = pg.junction_graph(*args, pad=False)[0]
    pad_T, pad_chi2 = pg.optimize_pose_graph(dev(g), **opts)
    T, chi2 = pg.optimize_pose_graph(dev(tight), **opts)
    T64, chi2_64 = pg.optimize_pose_graph(dev(tight, torch.float64), **opts)
    d = float((pad_T[:J] - T).abs().max())
    e32 = float((T.double() - T64).abs().max())
    rel = lambda a, b: abs(float(a) / max(float(b), 1e-30) - 1)  # noqa: E731
    return (J, len(g.poses), len(g.edge_i), d, e32, rel(pad_chi2, chi2), rel(chi2, chi2_64))


def padding_ok(d, e32, dchi2, echi2):
    """Poses padded within 1e-5 of tight, or within 3x the tight f32
    solve's own distance from f64; chi2 within 1e-3 relative (a final
    chi2 of ~1e-4 is known in f32 to ~1e-4 relative: echi2)."""
    return (d <= 1e-5 or d <= 3 * e32) and dchi2 <= 1e-3


def phase_backend_programs(closed, ba_closed, card):
    """Phase 24: the back end's device programs, fresh, on the card.  The
    pose-graph junction solve at tiers Jp 64, 128 and 256 (PG_TIERS) and
    its distribution: each captured, a replay bit-equal to the eager run
    at the same padded shape and to a second replay, no host
    synchronization inside a replayed run, the padded solve against the
    tight one (padding_ok; also on phase 7's own graph);
    ms a solve eager and replayed.  The BA program on phase 8's last
    window (P 16, L padded to 2048): the same checks, its poses within
    1e-5 of the tight solve's, its points within 1e-3 m (two f32 sum
    orders of this window's far landmarks, phase 19), chi2 within 1e-4.
    (Phase 17 holds FAST-ICP's programs.)"""
    from vslam_tpu_torch.backend import ba
    from vslam_tpu_torch.backend import pose_graph as pg

    fresh_programs()
    dev = lambda a: torch.as_tensor(a).cuda()  # noqa: E731
    for (P, C), tier in zip(PG_TIERS, PG_TIER_JP):
        est, odo, w, clo = drifted_hierarchical(P, C)
        g, junc, J, E = pg.junction_graph(est, odo, w, clo)
        Jp, Ep = len(g.poses), len(g.edge_i)
        if Jp != tier:
            raise AssertionError(f"[backend] {P} keyframes, {C} closures: Jp {Jp}, not {tier}")
        prog = pg.junction_program(Jp, Ep, 10, False, "cuda")
        (opt, chi2), e_ms, r_ms, cap_s = program_checks(
            f"junction {Jp}", prog, (pg.PoseGraph(*map(dev, g)), dev(np.float32(1.0))))
        _, _, _, d, e32, dchi2, echi2 = padded_against_tight(est, odo, w, clo)
        if not padding_ok(d, e32, dchi2, echi2):
            raise AssertionError(f"[backend] junction {Jp}: padded and tight solves {d:.2e} "
                                 f"apart (the f32 solve {e32:.2e} from f64), chi2 {dchi2:.2e} "
                                 "relative")
        corr = opt[:J].cpu().numpy() @ np.linalg.inv(est[junc])
        P_pad = pg.pow2(P, pg.P_FLOOR)
        owner = np.clip(np.searchsorted(junc, np.arange(P), side="right") - 1, 0, J - 2)
        s = (np.arange(P) - np.asarray(junc)[owner]) / np.maximum(
            np.asarray(junc)[owner + 1] - np.asarray(junc)[owner], 1)
        eye = np.eye(4, dtype=np.float32)
        dist = pg.distribute_program(P_pad, Jp, "cuda")
        _, de_ms, dr_ms, dcap_s = program_checks(
            f"distribute {P_pad}", dist,
            (dev(pg._padded(est, P_pad, eye)), dev(pg._padded(corr.astype(np.float32), Jp, eye)),
             dev(pg._padded(owner.astype(np.int64), P_pad, 0)),
             dev(pg._padded(s.astype(np.float32), P_pad, 0.0))))
        print(f"[backend] pose graph, {P} keyframes and {C} closures: junction solve at (Jp "
              f"{Jp}, Ep {Ep}) for J {J}, E {E}: eager {e_ms:.3f} ms, replayed {r_ms:.3f} ms "
              f"(capture {cap_s:.2f} s), chi2 {float(chi2):.4e}; padded against tight "
              f"{d:.2e} (the tight f32 solve {e32:.2e} from f64), chi2 {dchi2:.1e} relative "
              f"({echi2:.1e} tight f32 against f64); distribution "
              f"at {P_pad}: eager {de_ms:.3f} ms, replayed {dr_ms:.3f} ms (capture "
              f"{dcap_s:.2f} s); each replay bit-equal to its eager run and to the next "
              f"replay, 0 host synchronizations in a replayed run ({card})")
    args, kwargs = closed["pg"]
    J, Jp, Ep, d, e32, dchi2, echi2 = padded_against_tight(*args, **kwargs)
    print(f"[backend] phase 7's pose graph (its last solve, {len(args[0])} keyframes, J {J}): "
          f"padded to (Jp {Jp}, Ep {Ep}) against tight {d:.2e} (the tight f32 solve {e32:.2e} "
          f"from f64), chi2 {dchi2:.1e} relative")
    if not padding_ok(d, e32, dchi2, echi2):
        raise AssertionError(f"[backend] phase 7's pose graph: padded and tight {d:.2e} apart")

    prob, config, (n_kf, n) = ba_closed["ba"]
    cam = ba_closed["engine"].cam
    P, (L, O) = prob.T_wc.shape[0], prob.obs_cam.shape
    prog = ba.ba_program(cam, P, L, O, config, True, "cuda")
    (T, X, chi2s), e_ms, r_ms, cap_s = program_checks(
        f"BA ({P}, {L})", prog, ((cam.K, cam.baseline_m), prob))
    cut = {f: getattr(prob, f)[:n] for f in ("xyz", "obs_cam", "obs_uv4", "obs_weight",
                                             "obs_mask", "lm_valid")}
    cut.update({f: getattr(prob, f)[:n_kf] for f in ("T_wc", "cam_fixed", "odo_T",
                                                     "odo_weight")})
    Tt, Xt, ct = ba.bundle_adjust(cam, prob._replace(**cut), config)
    dT = float((T[:n_kf] - Tt).abs().max())
    dX = float((X[:n] - Xt).abs().max())
    dc = float((chi2s / ct - 1).abs().max())
    print(f"[backend] BA on phase 8's last window (true P {n_kf}, L {n}; padded P {P}, L "
          f"{L}): eager {e_ms:.3f} ms, replayed {r_ms:.3f} ms (capture {cap_s:.2f} s); "
          f"each replay bit-equal to its eager run and to the next replay, 0 host "
          f"synchronizations in a replayed run; padded against tight: poses {dT:.2e}, "
          f"points {dX:.2e} m, chi2 {dc:.1e} relative ({card})")
    if not (dT <= 1e-5 and dX <= 1e-3 and dc <= 1e-4):
        raise AssertionError(f"[backend] BA: padded and tight solves apart: poses {dT:.2e}, "
                             f"points {dX:.2e} m, chi2 {dc:.2e}")


def cell_episode(cell_name, seed, render, check_handles):
    """A benchmark cell's episode for the closed-loop phases: the cell's
    configuration, traffic and world at `seed`, its frames rendered on the
    card by `render(world, n, "cuda")`, `check_handles` handles spread
    over the episode to check, every program forgotten, the launch counts
    and the peak reset, and a fresh engine."""
    from types import SimpleNamespace

    from perfbench import generator, spec, window
    from vslam_tpu_torch.ops import camera as cam_ops
    from vslam_tpu_torch.system.engine import SlamEngine

    bench = spec.load()
    cell = spec.cell(bench, cell_name)
    config = window.load_config(spec.config_path(bench, cell["config"]))
    traffic = generator.load_traffic(spec.traffic_path(cell["traffic"]))
    cfg = window.parameter_collection(config)
    c = config.camera
    cam = cam_ops.make_camera(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, baseline_m=c.baseline_m,
                              rows=c.rows, cols=c.cols, device="cpu")
    world = generator.make_world(traffic, c, seed)
    n = traffic.episode_frames
    t0 = time.perf_counter()
    frames = render(world, n, "cuda")
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    C = int(cfg.parallelism.frames_per_chunk)
    handles = n // C
    checks = set(np.linspace(1, handles - 1, check_handles).round().astype(int).tolist())
    fresh_programs()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    eng = SlamEngine(cam, cfg, landmark_capacity=config.landmark_capacity, device="cuda")
    return SimpleNamespace(config=config, cfg=cfg, cam=c, n=n, C=C, handles=handles,
                           checks=checks, seed=seed, gt=world.poses[:n].astype(np.float64),
                           frames=frames, render_s=render_s, eng=eng)


def finish_episode(label, what, ep, run_s, card):
    """Flush the episode's engine and print its summary and correctness
    numbers; returns (launch counts, the engine's report, the numbers,
    run_s with the flush)."""
    from perfbench import reference, window
    from vslam_tpu_torch.eval import trajectory as traj_eval

    eng, n = ep.eng, ep.n
    t1 = time.perf_counter()
    traj = eng.trajectory
    torch.cuda.synchronize()
    run_s += time.perf_counter() - t1
    counts = read_counts()
    rep_ = eng.report()
    episode = window.Episode(
        frames=n, trajectory=np.asarray(traj, np.float64), kf_frames=list(eng.kf_frame_indices),
        closures=[(cl.query_id, cl.reference_id, np.asarray(cl.T_ref_query, np.float64))
                  for cl in eng.world_map.closures],
        breaks=int(eng.tracker.stats.n_breaks))
    numbers = reference.compare([episode], ep.gt)
    rmse, _, _ = traj_eval.ate_rmse(np.asarray(traj), ep.gt)
    print(f"[{label}] {n} {what} (seed {ep.seed}, rendered in {ep.render_s:.1f} s): "
          f"ATE {rmse:.4f} m, {rep_['n_local_maps']} local maps, {rep_['n_closures']} closures, "
          f"{rep_['n_optimizations']} optimizations, {rep_['n_merged_landmarks']} merged, "
          f"{rep_['n_track_breaks']} breaks, {rep_['n_recovered_landmarks']} recovered; "
          f"launches {counts}; {1e3 * run_s / n:.2f} ms/frame (first engine, eager frames "
          f"and captures included), peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"({card})")
    print(f"[{label}] correctness numbers {json.dumps(numbers)}")
    if rep_["n_track_breaks"] != 0 or numbers["frames_missing"] != 0:
        raise AssertionError(f"[{label}] {rep_['n_track_breaks']} breaks, "
                             f"{numbers['frames_missing']} frames without a pose")
    if rep_["n_closures"] < 1:
        raise AssertionError(f"[{label}] no closure")
    return counts, rep_, numbers, run_s


def phase_euroc_closed(card):
    """Phase 26: the benchmark's EuRoC cell closed loop, with the frame
    program's rotated descriptors held to the plain reference.  Returns
    the launch counts."""
    from perfbench import brief256r_plain
    from perfbench.handoffs import prestaged_rolled
    from vslam_tpu_torch.frontend import brief
    from vslam_tpu_torch.frontend.fast_brief import gather_descriptors
    from vslam_tpu_torch.frontend.orb import box_blur
    from vslam_tpu_torch.tracking import fused

    rotated0 = fused.EVENTS["rotated keypoints"]
    ep = cell_episode(EUROC_CELL, EUROC_SEED, prestaged_rolled.render_frames,
                      EUROC_CHECK_HANDLES)
    eng, frames, C, n, checks = ep.eng, ep.frames, ep.C, ep.n, ep.checks
    seen = {"keypoints": 0, "bank_differs": 0, "bank_differs_far_from_boundary": 0,
            "tie_bits": 0, "descriptors_differ": 0}
    ring_size = eng.tracker.params.ring_size
    run_s, ref_s = 0.0, 0.0
    for h in range(ep.handles):
        t1 = time.perf_counter()
        eng.process_prestaged(frames[h * C:(h + 1) * C])
        run_s += time.perf_counter() - t1
        if h not in checks:
            continue
        t1 = time.perf_counter()
        f = (h + 1) * C - 1
        st = eng.tracker.state
        prev = st.prev
        n_rec = int(st.ring[f % ring_size, fused._R_NRECOVER])
        valid = prev.valid.cpu()
        n_front = int(valid.sum()) - n_rec
        if n_front <= 0 or not bool(valid[:n_front].all()):
            raise AssertionError(f"[euroc-closed] frame {f}: {int(valid.sum())} valid rows, "
                                 f"{n_rec} recovered: no front-end block")
        uv = prev.uv4[:n_front, :2]
        desc = prev.desc[:n_front]
        img = frames[f, 0].to(torch.float32)
        bins = gather_descriptors(brief.orientation_bin_map(box_blur(img, 2))[None],
                                  img.shape, uv)[:, 0]
        ref = brief256r_plain.describe(img.cpu(), uv.cpu())
        ok, counts = brief256r_plain.agrees(desc, bins, ref, EUROC_BANK_MARGIN)
        for k, v in counts.items():
            seen[k] += v
        ref_s += time.perf_counter() - t1
        if not ok:
            raise AssertionError(f"[euroc-closed] frame {f}: descriptors off the plain "
                                 f"reference: {counts}")
    counts, _, _, run_s = finish_episode("euroc-closed", "rolled frames", ep, run_s, card)
    rotated = fused.EVENTS["rotated keypoints"] - rotated0
    print(f"[euroc-closed] rotated keypoints {rotated} ({rotated / n:.1f} a frame; left "
          f"images' keypoints {eng.tracker.stats.n_keypoints}); descriptors after "
          f"{len(checks)} handles against the plain reference: {seen} ({ref_s:.1f} s)")
    # The descriptor checks blur on the card too: two launches a check
    # (the image, then its gradient pair for the orientation bins).
    expect = {"K1": 0, "K2": n, "K3": 0, "K4": 32 * n, "fast_cells": 2 * n,
              "box_blur": 5 * n + 2 * len(checks)}
    if counts != expect:
        raise AssertionError(f"[euroc-closed] launches {counts}, expected {expect}")
    if not eng.tracker.stats.n_keypoints < rotated <= 2 * n * int(
            ep.cfg.framepoint_generation.capacity):
        raise AssertionError(f"[euroc-closed] rotated keypoints {rotated}")
    if seen["keypoints"] < 100 * len(checks):
        raise AssertionError(f"[euroc-closed] only {seen['keypoints']} keypoints checked")
    del eng, frames, ep
    return counts


def phase_tum_closed(card):
    """Phase 27: the benchmark's TUM cell closed loop, with the frame
    program's depth framepoints and UVD poses held to the plain reference.
    Returns the launch counts."""
    from unittest import mock

    from perfbench import reference, rgbd_plain
    from perfbench.handoffs import prestaged_depth
    from vslam_tpu_torch.frontend import detect
    from vslam_tpu_torch.mapping import frame as frame_mod
    from vslam_tpu_torch.mapping import landmarks as lm_mod
    from vslam_tpu_torch.solve import aligners
    from vslam_tpu_torch.tracking import fused

    keys = ("depth keypoints", "depth framepoints", "depth recovered")
    before = {k: fused.EVENTS[k] for k in keys}
    ep = cell_episode(TUM_CELL, TUM_SEED, prestaged_depth.render_frames, TUM_CHECK_HANDLES)
    eng, frames, C, n, checks, c = ep.eng, ep.frames, ep.C, ep.n, ep.checks, ep.cam
    fp = ep.cfg.framepoint_generation
    K = torch.tensor([[c.fx, 0.0, c.cx], [0.0, c.fy, c.cy], [0.0, 0.0, 1.0]])
    tr = eng.tracker
    params, R = tr.params, tr.params.ring_size
    gn_cfg = params.gn_config
    seen = {"frames": 0, "keypoints": 0, "framepoints": 0, "point_gap_m": 0.0,
            "bf16_point_gap_m": 0.0, "poses": 0, "poses_skipped": 0, "pose_gap_m": 0.0,
            "pose_gap_deg": 0.0, "eager_gap_m": 0.0, "bf16_pose_gap_m": None,
            "bf16_pose_gap_deg": None, "thresholds": []}

    def gap(A, B):
        t, r = reference.relative_gap(*(x.cpu().double().numpy() for x in (A, B)))
        return float(t), float(r)

    run_s, ref_s = 0.0, 0.0
    for h in range(ep.handles):
        a, b = h * C, (h + 1) * C
        if h not in checks:
            t1 = time.perf_counter()
            eng.process_prestaged(frames[a:b])
            run_s += time.perf_counter() - t1
            continue
        # Frame a's inputs as the program's buffers hold them, then frame a
        # alone (no drain falls inside a handle, so the drains stay where
        # they were), then the rest of the handle.
        st = fused.clone_state(tr.state)
        seen["thresholds"].append(float(st.threshold))
        t1 = time.perf_counter()
        eng.process_prestaged(frames[a:a + 1])
        run_s += time.perf_counter() - t1
        t1 = time.perf_counter()
        prog = fused.clone_state(tr.state)
        ring = prog.ring[a % R].cpu()
        img, depth = frames[a, 0], frames[a, 1]
        # The program's framepoints against the plain reference on the
        # keypoints its front end detected (detection is deterministic).
        kp = detect.detect_pyramid(detect.pyramid(img[None], params.octaves), st.threshold,
                                   params.bin_size, params.capacity, params.border,
                                   params.detector)
        uv = kp.uv[0][kp.valid[0]]
        z, valid, p = rgbd_plain.framepoints(depth, uv, K, fp.minimum_depth_meters,
                                             fp.maximum_depth_meters)
        nf = int(valid.sum())
        if (int(ring[fused._R_NKP]) != len(uv) or int(ring[fused._R_NFP]) != nf
                or not bool(prog.prev.valid[:nf].all())):
            raise AssertionError(f"[tum-closed] frame {a}: the program's {int(ring[fused._R_NKP])} "
                                 f"keypoints / {int(ring[fused._R_NFP])} framepoints against "
                                 f"{len(uv)} / {nf} on its own detection")
        rows = prog.prev.uv4[:nf].cpu()
        if not (torch.equal(rows[:, :2], uv.cpu()[valid])
                and torch.equal(rows[:, 2].double(), z[valid])):
            raise AssertionError(f"[tum-closed] frame {a}: framepoints or depths off the plain "
                                 "reference")
        pg = float((prog.prev.p_cam[:nf].cpu().double() - p[valid]).abs().max())
        bz, bv, bp = rgbd_plain.framepoints(depth, uv, K, fp.minimum_depth_meters,
                                            fp.maximum_depth_meters, dtype=torch.bfloat16)
        bg = float((bp[valid].double() - p[valid]).abs().max())
        seen["frames"] += 1
        seen["keypoints"] += len(uv)
        seen["framepoints"] += nf
        seen["point_gap_m"] = max(seen["point_gap_m"], pg)
        seen["bf16_point_gap_m"] = max(seen["bf16_point_gap_m"], bg)
        if pg > TUM_POINT_TOL_M or bg <= TUM_POINT_TOL_M:
            raise AssertionError(f"[tum-closed] frame {a}: points {pg:.2e} m from the plain "
                                 f"reference (bfloat16 {bg:.2e} m), tolerance {TUM_POINT_TOL_M}")
        # Attempt 1's pose solve on the same inputs: the front end and the
        # match again eagerly from the state before frame a, the solver's
        # arguments recorded.
        cur = frame_mod.process_depth_frame(
            tr.cam, img, depth, st.threshold, params.min_depth, params.max_depth,
            capacity=params.capacity, bin_size=params.bin_size, border=params.border,
            descriptor=params.descriptor, detector=params.detector, octaves=params.octaves)[0]
        radius, gate, guess = fused._ladder_inputs(params, st, st.last_motion)[0]
        weights = lm_mod.landmark_weights(st.table, st.prev.landmark_slot)
        with mock.patch.object(aligners, "uvd_align", wraps=aligners.uvd_align) as solve:
            res = frame_mod._one_attempt(tr.cam, st.prev, cur, guess, radius,
                                         gate.to(torch.int32), weights, gn_cfg, depth=True)
        T_prog = torch.linalg.inv(ring[:16].reshape(4, 4).double()) @ st.T_world_cam.cpu().double()
        if not bool(fused._accept(params, res)) or not bool(st.has_prev):
            seen["poses_skipped"] += 1  # another attempt decided the pose
            ref_s += time.perf_counter() - t1
            t1 = time.perf_counter()
            eng.process_prestaged(frames[a + 1:b])
            run_s += time.perf_counter() - t1
            continue
        _, data, mask, T0, _ = solve.call_args.args
        args = (K, data.p_prev, data.meas[0], data.weight, data.depth_reliable[0], mask[0], T0[0])
        kw = dict(kernel=gn_cfg.kernel_max_error, min_inliers=gn_cfg.min_num_inliers)
        T_plain = rgbd_plain.uvd_solve(*args, **kw)[0]
        dt, dr = gap(T_prog, T_plain)
        seen["eager_gap_m"] = max(seen["eager_gap_m"], gap(T_prog, res.T_cur_prev.cpu())[0])
        seen["poses"] += 1
        seen["pose_gap_m"] = max(seen["pose_gap_m"], dt)
        seen["pose_gap_deg"] = max(seen["pose_gap_deg"], dr)
        if seen["bf16_pose_gap_m"] is None:
            bt, br = gap(rgbd_plain.uvd_solve(*args, **kw, dtype=torch.bfloat16)[0], T_plain)
            seen["bf16_pose_gap_m"], seen["bf16_pose_gap_deg"] = bt, br
            if bt <= TUM_POSE_TOL_M or br <= TUM_POSE_TOL_DEG:
                raise AssertionError(f"[tum-closed] frame {a}: the bfloat16 solve lies within "
                                     f"the tolerance ({bt:.2e} m, {br:.2e} deg)")
        ref_s += time.perf_counter() - t1
        if dt > TUM_POSE_TOL_M or dr > TUM_POSE_TOL_DEG:
            raise AssertionError(f"[tum-closed] frame {a}: the program's pose {dt:.2e} m, "
                                 f"{dr:.2e} deg from the plain solve's: {seen}")
        t1 = time.perf_counter()
        eng.process_prestaged(frames[a + 1:b])
        run_s += time.perf_counter() - t1
    counts, _, _, run_s = finish_episode("tum-closed", "RGB-D frames", ep, run_s, card)
    got = {k: fused.EVENTS[k] - before[k] for k in keys}
    print(f"[tum-closed] depth counters {got} ({got['depth keypoints'] / n:.1f} keypoints, "
          f"{got['depth framepoints'] / n:.1f} framepoints, {got['depth recovered'] / n:.2f} "
          f"recovered a frame); against the plain reference at {len(checks)} frames: "
          f"{json.dumps(seen)} ({ref_s:.1f} s)")
    # Every check detects once more and runs the front end once more
    # eagerly: two FAST cells, one box blur and one K3 launch.
    k = len(checks)
    expect = {"K1": 0, "K2": 0, "K3": n + k, "K4": 0, "fast_cells": n + 2 * k,
              "box_blur": n + k}
    if counts != expect:
        raise AssertionError(f"[tum-closed] launches {counts}, expected {expect}")
    stats = eng.tracker.stats
    if got != {"depth keypoints": stats.n_keypoints, "depth framepoints": stats.n_framepoints,
               "depth recovered": stats.n_recovered}:
        raise AssertionError(f"[tum-closed] depth counters {got} against the tracker's stats")
    if seen["poses"] < k // 2 or seen["framepoints"] < 100 * k:
        raise AssertionError(f"[tum-closed] too little checked: {seen}")
    del eng, frames, ep
    return counts


def phase_bench(card):
    """Phases 22-23: run_bench as bench.py runs it (an empty program
    cache first, so its warm engine and warm-ups do the warming), the
    scale run inside it counted on its own (launches and peak memory
    around scale_run.run_scale).  The timed closed and ba-closed engines
    are held to phases 7-8's events and ATE and to no eager frame, no
    capture and no eager ICP batch.  Returns (bench launches, scale
    launches)."""
    from vslam_tpu_torch.backend import pose_graph as pg
    from vslam_tpu_torch.eval import scale_run, workloads
    from vslam_tpu_torch.frontend import kernel_timing as kt
    from vslam_tpu_torch.loop import relocalizer as rl

    fresh_programs()
    run_scale, solve_pg, scale = scale_run.run_scale, pg.optimize_pose_graph_hierarchical, {}

    def pg_largest(*args, **kwargs):
        if "pg" not in scale or len(args[0]) >= len(scale["pg"][0][0]):
            scale["pg"] = (args, kwargs)
        return solve_pg(*args, **kwargs)

    def scale_counted(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, events = read_counts(), workloads.program_events()
        uses = {k: p.uses for k, p in rl._QUERY_PROGRAMS.items()}
        pg.optimize_pose_graph_hierarchical = pg_largest
        try:
            out = run_scale(*args, **kwargs)
        finally:
            pg.optimize_pose_graph_hierarchical = solve_pg
        scale.update(out=dict(out), launches={k: v - before[k] for k, v in read_counts().items()},
                     peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                     reserved_mib=torch.cuda.max_memory_reserved() / 2**20,
                     events=dict(workloads.program_events() - events),
                     queries={k: p for k, p in rl._QUERY_PROGRAMS.items()
                              if p.uses > uses.get(k, 0)})
        return out

    scale_run.run_scale = scale_counted
    reset_counts()
    t0 = time.perf_counter()
    try:
        line = workloads.run_bench("cuda")
    finally:
        scale_run.run_scale = run_scale
    wall = time.perf_counter() - t0
    total = read_counts()
    if "launches" not in scale:
        raise AssertionError("[scale] run_bench did not run the scale run")
    bench = {k: total[k] - scale["launches"][k] for k in total}
    x = line["extra"]
    print(json.dumps(line))
    n = x["n_frames"]
    print(f"[bench] {wall:.1f} s in all; warm-up {x['warmup_s']:.2f} s (an engine over the BA "
          f"run's {n} frames, then the pose-graph, BA, ICP and query warm-ups); closed "
          f"{x['ms_per_frame']:.2f} ms/frame ({line['value']} fps), its first handle "
          f"{x['first_chunk_ms_per_frame']:.2f} ms/frame; ba-closed "
          f"{x['ms_per_frame_with_ba']:.2f} ms/frame, first handle "
          f"{x['first_chunk_ms_per_frame_with_ba']:.2f}; tracker only "
          f"{x['tracker_only_fps']} fps, split front-end {x['tracker_split_frontend_fps']} fps; "
          f"device only {x['device_compute_fps']} fps ({x['device_ms_per_frame']} ms/frame) "
          f"({card})")
    print(f"[bench] stage ms/frame of the closed run: {x['stage_ms_per_frame']}")
    print(f"[bench] program events inside the timed runs: closed {x['program_events']}, "
          f"ba-closed {x['program_events_with_ba']}; launches {bench} (by batch size "
          f"{read_batches()})")
    got = {"n_local_maps": x["n_local_maps"], "n_optimizations": x["n_pose_graph_optimizations"],
           "n_merged_landmarks": x["n_merged_landmarks"], "ate_m": x["ate_rmse_m"],
           "closures": [tuple(c) for c in x["closures"]]}
    if got != CARD_CLOSED or x["tracking_breaks"] != 0:
        raise AssertionError(f"[bench] closed: {got}, {x['tracking_breaks']} breaks; phase 7 "
                             f"gives {CARD_CLOSED}")
    got_ba = {"n_ba_runs": x["n_ba_runs"], "ate_m": x["ate_rmse_m_with_ba"]}
    if got_ba != CARD_BA_CLOSED or x["tracking_breaks_with_ba"] != 0:
        raise AssertionError(f"[bench] ba-closed: {got_ba}; phase 8 gives {CARD_BA_CLOSED}")
    one_time = [f"{prog}{how}" for prog in ("", "icp ", "query ", "pose graph ",
                                            "pose graph distribute ", "ba ")
                for how in ("eager", "capture")]
    for run in ("program_events", "program_events_with_ba"):
        ev = x[run]
        if (any(ev.get(k, 0) for k in one_time) or ev.get("replay", 0) != n
                or ev.get("query replay", 0) < 1):
            raise AssertionError(f"[bench] {run}: {ev}: a timed engine ran an eager frame, a "
                                 f"capture, an eager query, ICP batch, pose-graph solve or "
                                 f"BA, or not {n} replays, or no query replay")
    if not (x["program_events"].get("pose graph replay", 0) >= 1
            and x["program_events_with_ba"].get("ba replay", 0) >= 1):
        raise AssertionError("[bench] the timed runs replayed no pose-graph or no BA program")
    # Warm-up, closed, ba-closed, tracker only and device only one K1 a
    # frame; the split front-end one a chunk of 32 frames (B = 64).
    want = {"K1": 5 * n + -(-n // SPLIT_CHUNK), "K2": 0, "K3": 0, "K4": 0, "fast_cells": 0,
            "box_blur": 0}
    if bench != want:
        raise AssertionError(f"[bench] launches {bench}, expected {want}")

    out = scale["out"]
    print(f"[scale] {out['n_frames']} frames of a {out['path_length_m']} m circuit: ATE "
          f"{out['ate_rmse_m']} m (ate_ok {out['ate_ok']}), {out['n_local_maps']} local maps, "
          f"{out['n_closures']} closures ({out['closures_after_map_150']} after map 150), "
          f"{out['n_pose_graph_optimizations']} optimizations, {out['n_ba_runs']} BA runs, "
          f"{out['n_merged_landmarks']} merged, {out['reloc_db_rows']} DB rows, "
          f"{out['landmark_table_live_rows']} live table rows, {out['tracking_breaks']} breaks, "
          f"launches {scale['launches']}, peak device memory {scale['peak_mib']:.1f} MiB")
    print(f"[scale] {1e3 / out['fps']:.2f} ms/frame ({out['fps']} fps; process "
          f"{out['process_s']} s, render {out['render_s']} s off the clock) ({card})")
    for stage, row in out["stage_table"].items():
        print(f"[scale] stage {stage:24s} {row['seconds']:9.4f} s in {row['calls']} calls")
    print(f"[scale] program events over the run and its warm-ups: {scale['events']}")
    queries = scale["queries"]
    print(f"[scale] query programs (SB, prefix): uses in the run: "
          + ", ".join(f"({k[0]}, {k[2]}): {p.uses}" for k, p in sorted(queries.items(),
                                                                        key=lambda kv: kv[0][:3])))
    # The largest prefix's programs replayed again on the buffers as they
    # stand (their rows are in the database already: the insert adds 0).
    top = max(k[2] for k in queries)
    timed = {f"SB {k[0]}": kt.cuda_ms(p.replay, 3) for k, p in queries.items()
             if k[2] == top and p.graph is not None}
    print(f"[scale] query replays at prefix {top} ({out['reloc_db_rows']} DB rows), ms (median "
          f"of 3, CUDA events): {timed}; peak device memory {scale['peak_mib']:.1f} MiB, "
          f"reserved {scale['reserved_mib']:.1f} MiB ({card})")
    if scale["peak_mib"] > SCALE_PEAK_MIB:
        raise AssertionError(f"[scale] peak device memory {scale['peak_mib']:.1f} MiB > "
                             f"{SCALE_PEAK_MIB} MiB")
    args, kwargs = scale["pg"]
    J, Jp, Ep, d, e32, dchi2, echi2 = padded_against_tight(*args, **kwargs)
    print(f"[scale] its largest pose graph ({len(args[0])} keyframes, J {J}): padded to (Jp "
          f"{Jp}, Ep {Ep}) against tight {d:.2e} (the tight f32 solve {e32:.2e} from f64), "
          f"chi2 {dchi2:.1e} relative")
    if not padding_ok(d, e32, dchi2, echi2):
        raise AssertionError(f"[scale] the largest pose graph: padded and tight {d:.2e} apart")
    if out["n_frames"] != workloads.SCALE_FRAMES:
        raise AssertionError(f"[scale] {out['n_frames']} frames, not {workloads.SCALE_FRAMES}")
    if not (out["ate_ok"] and out["tracking_breaks"] == 0
            and out["closures_after_map_150"] > 0):
        raise AssertionError(f"[scale] ate_ok {out['ate_ok']}, {out['tracking_breaks']} "
                             f"breaks, {out['closures_after_map_150']} closures after map 150")
    if scale["launches"] != {"K1": out["n_frames"], "K2": 0, "K3": 0, "K4": 0, "fast_cells": 0,
                             "box_blur": 0}:
        raise AssertionError(f"[scale] launches {scale['launches']}")
    return bench, scale["launches"]


def mark(t_start, label):
    """The smoke's clock at the start of a phase (where the time goes)."""
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s: {label}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    import vslam_tpu_torch  # noqa: F401  (the port, from this checkout)
    from vslam_tpu_torch.frontend import dense_brief as db

    if sys.argv[1:2] == ["--shard-worker"]:  # one rank of phase 19
        rank, world, port, src, out = sys.argv[2:7]
        shard_worker(int(rank), int(world), int(port), src, out)
        return
    alone = {"--euroc-closed": phase_euroc_closed,  # phase 26 alone
             "--tum-closed": phase_tum_closed}  # phase 27 alone
    if sys.argv[1:2] and sys.argv[1] in alone:
        card = card_line()
        print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
        alone[sys.argv[1]](card)
        print(json.dumps({"ok": True, "device": {"name": torch.cuda.get_device_name(0),
                                                 "card": card}}))
        return

    t_start = time.perf_counter()
    card = card_line()
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    facts = phase_build(card)

    cam, cfg, world, frames = bench_setup()
    stats = {"K1": phase_k1(frames, card)}
    stats.update(phase_dense(frames[0], card))
    stats.update(phase_fast_cells(frames[0], card))
    stats.update(phase_box_blur(frames[0], card))
    stats.update(phase_hamming_match(frames[0], card))
    phase_k2_probe(card)
    mark(t_start, "device-program")
    program_launches = phase_device_program(cam, cfg, frames, card)

    mark(t_start, "k1-slice")
    print(f"[k1-slice] the JAX engine on a CPU: {JAX_CPU_K1_SLICE}")
    launches = drive_slice("k1-slice", cam, cfg, world.poses[:K1_SLICE_FRAMES],
                           frames[:K1_SLICE_FRAMES],
                           {"K1": K1_SLICE_FRAMES, "K2": 0, "K3": 0, "K4": 0, "fast_cells": 0,
                            "box_blur": 0},
                           within_15_percent(JAX_CPU_K1_SLICE["n_local_maps"]),
                           CPU_CHECK_FRAMES, card)
    launches = {k: launches[k] + program_launches[k] for k in launches}
    mark(t_start, "kitti-config")
    counts = phase_kitti_config(card)
    launches = {k: launches[k] + counts[k] for k in launches}
    # Phases 15-16 next to the per-frame runs they are compared with.
    chunk_stats = {}
    for phase, key in ((lambda: phase_k1_split(cam, cfg, world, frames, card), "K1"),
                       (lambda: phase_kitti_split(card), "K2")):
        mark(t_start, f"split ({key})")
        counts, chunk_stats[key] = phase()
        launches = {k: launches[k] + counts[k] for k in launches}
    mark(t_start, "chain-pg")
    phase_chain(card)
    closed, ba_closed = {}, {}
    mark(t_start, "euroc-config, euroc-closed, tum-closed, closed, ba-closed, "
                  "modular-closed, modular configs")
    for counts in (
        config_slice("euroc-config", "euroc", EUROC_CAM, EUROC_FRAMES, EUROC_CIRCLE_FRAMES,
                     4.0, {"K2": 1, "K4": 2 * db.N_ROT_BANKS, "fast_cells": 2, "box_blur": 5},
                     within_15_percent(JAX_CPU_EUROC["n_local_maps"]), 2, card),
        phase_euroc_closed(card),
        phase_tum_closed(card),
        phase_closed_loop("closed", cam, closed_loop_config(cfg), world, frames,
                          JAX_CPU_CLOSED_LOOP, CARD_CLOSED, card, record=closed),
        phase_closed_loop("ba-closed", cam, ba_closed_config(cfg), world, frames,
                          JAX_CPU_BA_CLOSED, CARD_BA_CLOSED, card, record=ba_closed),
        phase_modular_closed(cam, cfg, world, frames, card),
        phase_modular_configs(closed, card),
    ):
        launches = {k: launches[k] + counts[k] for k in launches}
    mark(t_start, "tum-config, xtion-config")
    for counts in (phase_tum(card), phase_xtion(card)):
        launches = {k: launches[k] + counts[k] for k in launches}
    mark(t_start, "detectors")
    phase_detectors(frames[0], card)
    mark(t_start, "kitti-disk, checkpoint, tum-disk")
    counts = phase_disk(card)
    launches = {k: launches[k] + counts[k] for k in launches}
    # Phases 17 and 19 last, on phases 7-8's records.
    mark(t_start, "fast-icp, sharded, backend programs")
    phase_fast_icp(closed, card)
    phase_sharded(closed, ba_closed, card)
    phase_backend_programs(closed, ba_closed, card)
    mark(t_start, "bench, scale")
    for counts in phase_bench(card):
        launches = {k: launches[k] + counts[k] for k in launches}

    sources = {"K1": ("fast_brief_frontend_pair", "fast_brief_frontend.cu",
                      "vslam_tpu/frontend/pallas_frontend.py:196")}
    for name, fn, line in (("K2", "dense_bit_planes_batch", 176), ("K3", "dense_bit_planes", 78),
                           ("K4", "dense_bit_planes_pattern", 116)):
        sources[name] = (fn, "dense_brief.cu", f"vslam_tpu/frontend/pallas_brief.py:{line}")
    sources["fast_cells"] = ("fast_cells", "fast_cells.cu",
                             "none: XLA in vslam_tpu/frontend/detect.py (fast_score_map, "
                             "nms3, keypoints_from_score's per-cell argmax)")
    sources["box_blur"] = ("box_blur", "box_blur.cu",
                           "none: XLA in vslam_tpu/frontend/orb.py (box_blur)")
    stats["box_blur"] = stats["box_blur kitti pair"]
    kernels = [{
        "name": fn,
        "route": "cuda",
        "source": f"vslam_tpu_torch/csrc/{src}",
        "replaces": replaces,
        "launches": launches[k],
        # No single PyTorch call computes any of these functions (256
        # packed compares of shifted taps; blur + FAST + NMS + band
        # argmax; the box blur in XLA-CPU's FMA chain, bit for bit).
        "library_ms": None,
        **stats[k],
        **facts[k],
    } for k, (fn, src, replaces) in sources.items()]
    # The staged detector at pyramid level 1, an entry of its own.
    fn, src, replaces = sources["fast_cells"]
    kernels.append({"name": f"{fn} (level 1)", "route": "cuda",
                    "source": f"vslam_tpu_torch/csrc/{src}", "replaces": replaces,
                    "library_ms": None, **stats["fast_cells level 1"], **facts["fast_cells"]})
    # The box blur's other launches on the cells' routes, entries of their own.
    fn, src, replaces = sources["box_blur"]
    for label, B, H, W, r in BOX_BLUR_LAUNCHES[1:]:
        kernels.append({"name": f"{fn} ({label}, radius {r})", "route": "cuda",
                        "source": f"vslam_tpu_torch/csrc/{src}", "replaces": replaces,
                        "library_ms": None, **stats[f"box_blur {label}"],
                        **facts["box_blur r7" if r == 7 else "box_blur"]})
    # The split front-end's chunk-sized launches (phases 15-16), their own
    # entries: launches at that shape, its times and bound.
    for k, rec in chunk_stats.items():
        fn, src, replaces = sources[k]
        kernels.append({"name": f"{fn} (split chunk, B={2 * SPLIT_CHUNK})", "route": "cuda",
                        "source": f"vslam_tpu_torch/csrc/{src}", "replaces": replaces,
                        "library_ms": None, **rec, **facts[k]})
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s from the start to the kernel "
          f"record, the builds included ({card})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
