"""Command-line interface of the port (port of vslam_tpu/system/cli.py).

Replaces the reference executables (executables/app.cpp CLI with its ~15
flags, parameters.cpp:182-270; trajectory_analyzer; trajectory_converter)
with subcommands:

  run       SLAM over a dataset -> trajectory files + report
            (app.cpp:6-146 parity: -c, -open-loop, -equalize-histogram,
            -save-pose-graph, -drop-framepoints flags)
  eval      ATE/RPE of an estimate vs ground truth
            (trajectory_analyzer.cpp parity)
  convert   trajectory/pose-graph format conversion
            (trajectory_converter.cpp parity)
  bench     bench.py on the port (eval/workloads.py): the warmed closed
            loop and its BA-enabled variant, the tracker-only and
            device-only rates, the stage ms/frame and the KITTI-00-scale
            run, as bench.py's one JSON line

`run` and `bench` run on the card (--device cuda, the default) unless
--device cpu is given; without a card the default raises.

Usage: python -m vslam_tpu_torch <subcommand> ...
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np


def write_engine_factor_graph(engine, path: str) -> None:
    """Assemble the FULL factor graph (poses + landmarks + measurement
    edges) from a finished engine and export it (writePoseGraphToFile
    parity, graph_optimizer.cpp:164-262)."""
    from vslam_tpu_torch.io import g2o_io

    gopt = engine.cfg.graph_optimization
    landmark_xyz: dict = {}
    observations = []
    for m in engine.world_map.local_maps:
        T = m.T_world_kf
        for slot, p_kf in zip(np.asarray(m.landmark_slots), np.asarray(m.xyz_kf)):
            slot, p_kf = int(slot), p_kf.astype(np.float64)
            if slot not in landmark_xyz:
                landmark_xyz[slot] = T[:3, :3] @ p_kf + T[:3, 3]
            # 1/depth information (reference _setPointEdge
            # information_factor_, graph_optimizer.cpp:232).
            observations.append((m.map_id, slot, p_kf, 1.0 / max(float(p_kf[2]), 0.1)))
    g2o_io.write_factor_graph(
        path, np.stack(engine.kf_poses), _pose_graph_edges(engine), landmark_xyz,
        observations,
        identifier_space=gopt.identifier_space,
        base_information_frame=gopt.base_information_frame,
        free_translation_for_poses=gopt.free_translation_for_poses,
        base_information_frame_factor_for_translation=(
            gopt.base_information_frame_factor_for_translation),
    )


def _pose_graph_edges(engine) -> list:
    """Odometry edges (break-aware weights) and closure edges (weight 10)."""
    return [(k - 1, k, engine.kf_odometry[k - 1], engine.kf_odom_weight[k - 1])
            for k in range(1, len(engine.kf_poses))
            ] + [(i, j, T, 10.0) for (i, j, T) in engine.closure_edges]


def card_line() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


@contextlib.contextmanager
def _trace(trace_dir: str | None, device):
    """A torch.profiler Chrome trace of the frame loop in trace_dir
    (easy_profiler parity), or nothing."""
    if not trace_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"device trace in {path}", file=sys.stderr)


def cmd_run(args):
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.io import datasets
    from vslam_tpu_torch.io.config import ParameterCollection, load_config
    from vslam_tpu_torch.ops.cuda_build import counters
    from vslam_tpu_torch.system.engine import SlamEngine

    cfg = load_config(args.config) if args.config else ParameterCollection()
    if args.open_loop:
        cfg.command_line.option_disable_relocalization = True
    if args.tracker_mode:
        cfg.command_line.tracker_mode = args.tracker_mode
    if args.depth_mode:
        cfg.command_line.tracker_mode = "RGB_DEPTH"
    if args.use_odometry:
        cfg.command_line.option_use_odometry = True
        cfg.tracking.motion_model = "CAMERA_ODOMETRY"
    if args.drop_framepoints is not None:
        cfg.command_line.option_drop_framepoints = args.drop_framepoints
    if args.recover_landmarks is not None:
        cfg.command_line.option_recover_landmarks = args.recover_landmarks
    if args.disable_bundle_adjustment:
        cfg.graph_optimization.enable_full_bundle_adjustment = False
    if args.dump:
        cfg.visualization.enable_image_dump = True
        if args.dump is not True:
            cfg.visualization.dump_directory = args.dump
    cfg.command_line.configuration_file_name = args.config or ""
    if not args.dataset:
        args.dataset = cfg.command_line.dataset_file_name
        if not args.dataset:
            raise SystemExit("no dataset: pass --dataset or set "
                             "command_line.dataset_file_name in the config")
    if cfg.visualization.enable_image_dump:
        from vslam_tpu_torch.viz import plots

        plots.require_matplotlib()  # before the run, not after it

    ds_kwargs = {}
    if args.format == "kitti" and (args.equalize_histogram
                                   or cfg.command_line.option_equalize_histogram):
        ds_kwargs["equalize_hist"] = True
    # Honor an explicitly-configured depth scale (reference
    # depth_scale_factor_intensity_to_meters, parameters.h:251); PNG
    # datasets otherwise keep the TUM 1/5000 convention.
    if args.format in ("tum", "icl") and (
            "framepoint_generation.depth_scale_factor_intensity_to_meters"
            in getattr(cfg, "explicit_keys", ())):
        ds_kwargs["depth_scale"] = cfg.framepoint_generation.depth_scale_factor_intensity_to_meters
    ds = datasets.load_dataset(args.dataset, args.format, **ds_kwargs)
    if args.format in ("tum", "icl"):
        cfg.command_line.tracker_mode = "RGB_DEPTH"

    engine = SlamEngine(ds.cam, cfg, device=args.device)
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    for c in counters().values():
        c.launches = 0
    timestamps = []
    wait = 0.0  # time the loop waited for decoded frames
    first = 0.0  # the first frame's process call, warm-up included
    t_run = time.perf_counter()
    with _trace(args.trace_dir, engine.device), contextlib.closing(iter(ds)) as frames:
        for i in range(n):
            t0 = time.perf_counter()
            frame = next(frames)
            t1 = time.perf_counter()
            wait += t1 - t0
            engine.process(frame.img_left, frame.img_right)
            if i == 0:
                first = time.perf_counter() - t1
            timestamps.append(frame.timestamp)
            if frame.index % 50 == 0:
                # report_lite: the full report() drains the device pipeline
                # and would stall the run at every status line.
                rep = engine.report_lite()
                print(f"frame {frame.index}/{n} | {rep['mean_frame_hz']:.1f} Hz | "
                      f"landmarks {rep['n_landmarks']} | local maps {rep['n_local_maps']} | "
                      f"closures {rep['n_closures']}", file=sys.stderr)
        est = engine.trajectory  # flushes the tracker and the closure pipeline
    run_seconds = time.perf_counter() - t_run
    if args.output_kitti:
        traj_eval.write_kitti(args.output_kitti, est)
    if args.output_tum:
        traj_eval.write_tum(args.output_tum, est, np.asarray(timestamps))
    save_pg = args.save_pose_graph or (
        "pose_graph.g2o" if cfg.command_line.option_save_pose_graph else None)
    if save_pg and engine.kf_poses:
        from vslam_tpu_torch.io import g2o_io

        g2o_io.write_pose_graph(save_pg, np.stack(engine.kf_poses), _pose_graph_edges(engine))
    if args.save_factor_graph and engine.kf_poses:
        write_engine_factor_graph(engine, args.save_factor_graph)
    if cfg.visualization.enable_image_dump:
        from vslam_tpu_torch.viz import plots

        out = plots.dump_run(engine, cfg.visualization.dump_directory)
        print(f"visualization artifacts in {out}", file=sys.stderr)
    engine.print_report()
    report = engine.report()
    report["run"] = {
        "device": str(engine.device),
        "frames": n,
        "seconds": round(run_seconds, 4),
        "ms_per_frame": round(1e3 * run_seconds / max(n, 1), 3),
        "frame_wait_seconds": round(wait, 4),
        "first_frame_seconds": round(first, 4),
        "kernel_launches": {k: c.launches for k, c in counters().items()},
    }
    with open(args.timing_output, "w") as f:
        json.dump(report, f, indent=2)


def cmd_eval(args):
    from vslam_tpu_torch.eval import trajectory as traj_eval

    if args.format == "kitti":
        est = traj_eval.read_kitti(args.estimate)
        gt = traj_eval.read_kitti(args.ground_truth)
    else:
        ts_e, est = traj_eval.read_tum(args.estimate)
        ts_g, gt = traj_eval.read_tum(args.ground_truth)
        ia, ib = traj_eval.associate_timestamps(ts_e, ts_g, args.max_dt)
        est, gt = est[ia], gt[ib]
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    rmse, _, raw = traj_eval.ate_rmse(est, gt, with_scale=args.scale)
    t_rpe, r_rpe = traj_eval.rpe(est, gt)
    print(json.dumps({
        "ate_rmse_m": round(rmse, 4),
        "ate_rmse_raw_m": round(raw, 4),
        "rpe_trans_m": round(t_rpe, 4),
        "rpe_rot_rad": round(r_rpe, 4),
        "n_poses": int(n),
    }))


def cmd_convert(args):
    from vslam_tpu_torch.eval import trajectory as traj_eval
    from vslam_tpu_torch.io import g2o_io

    if args.input_format == "tum":
        _, poses = traj_eval.read_tum(args.input)
    elif args.input_format == "g2o":
        poses, _ = g2o_io.read_pose_graph(args.input)
    else:
        poses = traj_eval.read_kitti(args.input)
    if args.output_format == "kitti":
        traj_eval.write_kitti(args.output, poses)
    else:
        traj_eval.write_tum(args.output, poses)
    print(f"converted {len(poses)} poses -> {args.output}")


def cmd_bench(args):
    from vslam_tpu_torch.eval import workloads

    out = workloads.run_bench(args.device)
    out["extra"]["card"] = card_line() if out["extra"]["backend"] == "cuda" else None
    print(json.dumps(out))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vslam_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("run", help="run SLAM over a dataset")
    pr.add_argument("--dataset", default=None,
                    help="dataset path (or command_line.dataset_file_name)")
    pr.add_argument("--format", default="kitti", choices=["kitti", "euroc", "tum", "icl"])
    pr.add_argument("-c", "--config", default=None, help="YAML configuration file")
    pr.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, the default, or cpu)")
    pr.add_argument("--open-loop", action="store_true",
                    help="disable relocalization (reference -open-loop)")
    pr.add_argument("--equalize-histogram", action="store_true")
    pr.add_argument("--tracker-mode", choices=["RGB_STEREO", "RGB_DEPTH"], default=None)
    pr.add_argument("--max-frames", type=int, default=None)
    pr.add_argument("--output-kitti", default="trajectory_kitti.txt")
    pr.add_argument("--output-tum", default=None)
    pr.add_argument("--save-pose-graph", default=None,
                    help="write g2o pose graph (reference -save-pose-graph)")
    pr.add_argument("--save-factor-graph", default=None,
                    help="write FULL g2o factor graph: poses + landmark vertices + "
                         "measurement edges (writePoseGraphToFile parity)")
    pr.add_argument("--timing-output", default="timing_vslam_tpu.json",
                    help="machine-readable report (timing_proslam.txt parity)")
    pr.add_argument("--dump", nargs="?", const=True, default=False, metavar="DIR",
                    help="dump per-keyframe overlays + final map plot (optional output "
                         "directory; default from the visualization config group); "
                         "needs matplotlib")
    pr.add_argument("--depth-mode", action="store_true",
                    help="RGB-D tracking (reference -dm; same as --tracker-mode RGB_DEPTH)")
    pr.add_argument("--use-odometry", action="store_true",
                    help="use external odometry instead of the inner motion model "
                         "(reference -uo); requires a dataset with per-frame odometry")
    pr.add_argument("--drop-framepoints", dest="drop_framepoints", action="store_true",
                    default=None,
                    help="recycle stale landmark slots at runtime (reference -df; on by "
                         "default here)")
    pr.add_argument("--no-drop-framepoints", dest="drop_framepoints", action="store_false",
                    help="keep every landmark slot live (unbounded map)")
    pr.add_argument("--recover-landmarks", dest="recover_landmarks", action="store_true",
                    default=None,
                    help="re-acquire lost landmarks at solved-pose projections "
                         "(reference -rl; on by default)")
    pr.add_argument("--no-recover-landmarks", dest="recover_landmarks", action="store_false")
    pr.add_argument("--disable-bundle-adjustment", action="store_true",
                    help="force periodic full BA off (reference -dba)")
    pr.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler Chrome trace of the run (trace.json; "
                         "easy_profiler parity)")
    pr.set_defaults(func=cmd_run)

    pe = sub.add_parser("eval", help="ATE/RPE evaluation")
    pe.add_argument("--estimate", required=True)
    pe.add_argument("--ground-truth", required=True)
    pe.add_argument("--format", default="kitti", choices=["kitti", "tum"])
    pe.add_argument("--scale", action="store_true", help="align with scale (monocular)")
    pe.add_argument("--max-dt", type=float, default=0.02)
    pe.set_defaults(func=cmd_eval)

    pc = sub.add_parser("convert", help="trajectory format conversion")
    pc.add_argument("--input", required=True)
    pc.add_argument("--input-format", default="tum", choices=["tum", "kitti", "g2o"])
    pc.add_argument("--output", required=True)
    pc.add_argument("--output-format", default="kitti", choices=["kitti", "tum"])
    pc.set_defaults(func=cmd_convert)

    pb = sub.add_parser("bench", help="bench.py's benchmark on the port (one JSON line)")
    pb.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, the default, or cpu)")
    pb.set_defaults(func=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
