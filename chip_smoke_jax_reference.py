"""The JAX engine (vslam_tpu) on the CPU for chip_smoke.py's closed-loop
workloads, whose counts chip_smoke.py prints beside the card's
(JAX_CPU_CLOSED_LOOP, JAX_CPU_BA_CLOSED, JAX_CPU_TUM):

    python3 chip_smoke_jax_reference.py [closed] [ba-closed] [tum-config]

Each run uses chip_smoke.py's configuration and sequence, built with the
JAX package's classes, on one CPU device (no sharded database search or
BA), frame by frame; it prints one JSON line of counts per workload.  At
KITTI resolution a run takes about 1-2 s a frame.
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
from vslam_tpu_torch.ops import camera as port_cam  # noqa: E402


def workload(name):
    """(JAX camera, JAX configuration, ground-truth poses, frames)."""
    if name == "tum-config":
        here = os.path.dirname(os.path.abspath(__file__))
        cfg = load_config(os.path.join(here, "configurations", "configuration_tum.yaml"))
        gt, frames = chip_smoke.tum_world(port_cam.make_camera(**chip_smoke.TUM_CAM,
                                                               device="cpu"))
        return cam_ops.make_camera(**chip_smoke.TUM_CAM), cfg, gt, frames
    cfg = chip_smoke.bench_config(ParameterCollection)
    cfg = (chip_smoke.ba_closed_config(cfg) if name == "ba-closed"
           else chip_smoke.closed_loop_config(cfg))
    world, frames = chip_smoke.bench_world(port_cam.make_camera(**chip_smoke.KITTI_CAM,
                                                                device="cpu"))
    return cam_ops.make_camera(**chip_smoke.KITTI_CAM), cfg, world.poses, frames


def run(name):
    cam, cfg, gt, frames = workload(name)
    cfg.parallelism.shard_descriptor_db = False
    cfg.parallelism.shard_landmarks = False
    engine = SlamEngine(cam, cfg, landmark_capacity=65536)
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
    for name in sys.argv[1:] or ["closed", "ba-closed", "tum-config"]:
        run(name)
