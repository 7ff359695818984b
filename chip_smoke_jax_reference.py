"""The JAX engine (vslam_tpu) on the CPU for chip_smoke.py's workloads
that it holds to JAX's counts (JAX_CPU_K1_SLICE, JAX_CPU_KITTI_CONFIG,
JAX_CPU_CLOSED_LOOP, JAX_CPU_BA_CLOSED, JAX_CPU_TUM, JAX_CPU_XTION,
JAX_CPU_KITTI_DOG, JAX_CPU_K1_SPLIT, JAX_CPU_KITTI_SPLIT,
JAX_CPU_MODULAR_CLOSED, JAX_CPU_EUROC):

    python3 chip_smoke_jax_reference.py [k1-slice] [kitti-config] [closed]
        [ba-closed] [tum-config] [xtion-config] [kitti-dog] [k1-split]
        [kitti-split] [modular-closed] [euroc-config]

Each run uses chip_smoke.py's configuration and sequence, built with the
JAX package's classes, on one CPU device (no sharded database search or
BA), frame by frame; it prints one JSON line of counts per workload.  The
split runs (k1-split, kitti-split: k1-slice and kitti-config with
tracking.batch_frontend) step chunks of 32 frames through
make_chunk_step_split, as the card does (the JAX tracker's chunk on a CPU
is one frame).  modular-closed is closed with tracking.use_fused_tracker
false: the modular PoseTracker and the engine's synchronous keyframe
path.  At KITTI resolution a run takes about 1-2 s a frame.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from vslam_tpu.eval import trajectory as traj_eval  # noqa: E402
from vslam_tpu.io.config import ParameterCollection, load_config  # noqa: E402
from vslam_tpu.ops import camera as cam_ops  # noqa: E402
from vslam_tpu.system.engine import SlamEngine  # noqa: E402
from vslam_tpu_torch.eval import workloads  # noqa: E402
from vslam_tpu_torch.ops import camera as port_cam  # noqa: E402


def workload(name):
    """(JAX camera, JAX configuration, ground-truth poses, frames)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if name in ("tum-config", "xtion-config"):
        cfg = load_config(os.path.join(here, "configurations",
                                       f"configuration_{name.split('-')[0]}.yaml"))
        circle, n = ((chip_smoke.XTION_CIRCLE_FRAMES, chip_smoke.XTION_FRAMES)
                     if name == "xtion-config"
                     else (chip_smoke.TUM_FRAMES, chip_smoke.TUM_CONFIG_FRAMES))
        gt, frames = chip_smoke.tum_world(
            port_cam.make_camera(**chip_smoke.TUM_CAM, device="cpu"), circle, n)
        return cam_ops.make_camera(**chip_smoke.TUM_CAM), cfg, gt, frames
    if name in ("kitti-config", "kitti-dog"):
        cfg = chip_smoke.kitti_config(load_config, "DOG" if name == "kitti-dog" else None)
        gt, frames = chip_smoke.kitti_world(
            port_cam.make_camera(**workloads.KITTI_CAM, device="cpu"),
            chip_smoke.KITTI_SLICE_FRAMES)
        return cam_ops.make_camera(**workloads.KITTI_CAM), cfg, gt, frames
    if name == "euroc-config":
        cfg = load_config(os.path.join(here, "configurations", "configuration_euroc.yaml"))
        cfg.command_line.option_disable_relocalization = True
        gt, frames = chip_smoke.circle_slice(
            port_cam.make_camera(**chip_smoke.EUROC_CAM, device="cpu"),
            chip_smoke.EUROC_CIRCLE_FRAMES, 4.0, chip_smoke.EUROC_FRAMES)
        return cam_ops.make_camera(**chip_smoke.EUROC_CAM), cfg, gt, frames
    cfg = workloads.bench_config(ParameterCollection)
    n = {"k1-slice": chip_smoke.K1_SLICE_FRAMES,
         "k1-split": chip_smoke.SPLIT_K1_FRAMES}.get(name, workloads.N_FRAMES)
    if name not in ("k1-slice", "k1-split"):
        cfg = (workloads.ba_closed_config(cfg) if name == "ba-closed"
               else workloads.closed_loop_config(cfg))
    world, frames = workloads.bench_world(port_cam.make_camera(**workloads.KITTI_CAM,
                                                                device="cpu"), n)
    return cam_ops.make_camera(**workloads.KITTI_CAM), cfg, world.poses[:n], frames


# Workloads that are another's sequence and configuration with one key
# changed: the split front-end, or the modular tracker.
BASE = {"kitti-split": "kitti-config", "modular-closed": "closed"}
SPLIT = ("k1-split", "kitti-split")
MODULAR = ("modular-closed",)


def run(name):
    cam, cfg, gt, frames = workload(BASE.get(name, name))
    cfg.parallelism.shard_descriptor_db = False
    cfg.parallelism.shard_landmarks = False
    if name in SPLIT:
        cfg.tracking.batch_frontend = True
    if name in MODULAR:
        cfg.tracking.use_fused_tracker = False
    engine = SlamEngine(cam, cfg, landmark_capacity=65536)
    if name in SPLIT:  # the card's chunk: 32 frames a make_chunk_step_split call
        C = chip_smoke.SPLIT_CHUNK
        tr = engine.tracker
        tr.chunk_size = tr.harvest_every = C
        tr._odom_identity = jax.device_put(np.tile(np.eye(4, dtype=np.float32), (C, 1, 1)))
    for left, right in frames:
        engine.process(left, right)
    traj = np.asarray(engine.trajectory)
    rep = engine.report()
    out = {k: rep[k] for k in ("n_local_maps", "n_closures", "n_optimizations",
                               "n_merged_landmarks", "n_track_breaks", "n_ba_runs")}
    out.update(ate_m=round(float(traj_eval.ate_rmse(traj, gt)[0]), 4),
               db_rows=int(engine.relocalizer.n_rows),
               closures=[(c.query_id, c.reference_id) for c in engine.world_map.closures])
    print(json.dumps({"workload": name, **out}), flush=True)


if __name__ == "__main__":
    for name in sys.argv[1:] or ["k1-slice", "kitti-config", "closed", "ba-closed",
                                 "tum-config", "xtion-config", "kitti-dog", "k1-split",
                                 "kitti-split", "modular-closed", "euroc-config"]:
        run(name)
