"""One rank of tests/test_torch_parallel.py's gloo runs (imports torch
and the port only, never jax).

    python torch_parallel_worker.py kernels RANK WORLD PORT IN.npz OUT_PREFIX
    python torch_parallel_worker.py engine RANK WORLD PORT CONFIG.json OUT_PREFIX

kernels: the sharded searches and the sharded BA on the inputs in IN.npz,
every rank its row block; each rank writes OUT_PREFIX<rank>.npz.
engine: SlamEngine on the synthetic sequence CONFIG.json names, with its
database search and windowed BA sharded over the ranks (unsharded at
WORLD 1); each rank writes its trajectory and report to
OUT_PREFIX<rank>.npz.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vslam_tpu_torch.backend import ba as ba_mod  # noqa: E402
from vslam_tpu_torch.ops import camera as cam_ops  # noqa: E402
from vslam_tpu_torch.parallel import launch  # noqa: E402
from vslam_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from vslam_tpu_torch.parallel import sharded_ba, sharded_search  # noqa: E402

BA_CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=160.0, baseline_m=0.4, rows=320, cols=640)


def ba_problem(arrays) -> ba_mod.BAProblem:
    t = {k: torch.from_numpy(arrays["ba_" + k]) for k in
         ("T_wc", "xyz", "obs_cam", "obs_uv4", "obs_weight", "obs_mask", "lm_valid",
          "cam_fixed")}
    t["obs_cam"] = t["obs_cam"].long()
    return ba_mod.BAProblem(**t)


def kernels(mesh, arrays, out):
    res = {}
    for case in ("search", "top2", "top2_shard_masked", "all_masked", "per_query"):
        q = torch.from_numpy(arrays[case + "_q"])
        db = torch.from_numpy(arrays[case + "_db"])
        valid = torch.from_numpy(arrays[case + "_valid"])
        valid_s = mesh_mod.shard_rows(valid, mesh, axis=valid.dim() - 1)
        db_s = mesh_mod.shard_rows(db, mesh)
        if case == "search":
            res[case] = torch.stack(sharded_search.search_sharded(q, db_s, valid_s, mesh)).numpy()
        else:
            res[case] = torch.stack(sharded_search.search_sharded_top2(q, db_s, valid_s,
                                                                       mesh)).numpy()
    cam = cam_ops.make_camera(**BA_CAM, device="cpu")
    prob = ba_problem(arrays)
    block, L = sharded_ba.shard_problem(prob, mesh)
    config = ba_mod.BAConfig(iterations=int(arrays["ba_iterations"]))
    T, xyz_block, chi2 = sharded_ba.bundle_adjust_sharded(cam, block, mesh, config)
    res["ba_T"] = T.numpy()
    res["ba_xyz"] = mesh_mod.all_gather_rows(xyz_block, mesh)[:L].numpy()
    res["ba_chi2"] = chi2.numpy()
    np.savez(out, **res)


def engine(mesh, spec, out):
    from vslam_tpu_torch.io import synthetic
    from vslam_tpu_torch.io.config import ParameterCollection
    from vslam_tpu_torch.system.engine import SlamEngine

    cam = cam_ops.make_camera(**spec["cam"], device="cpu")
    world = synthetic.make_world(cam, n_points=spec["n_points"], seed=spec["seed"],
                                 poses=synthetic.circle_trajectory(spec["frames"],
                                                                   radius=spec["radius"]))
    cfg = ParameterCollection()
    for group, values in spec["config"].items():
        for key, value in values.items():
            setattr(getattr(cfg, group), key, value)
    eng = SlamEngine(cam, cfg, landmark_capacity=spec["landmark_capacity"], device="cpu")
    if mesh is None:  # one rank: the unsharded engine
        assert eng.mesh is None and eng.relocalizer.mesh is None
    else:
        assert eng.mesh.size == mesh.size
        assert eng.relocalizer.mesh is not None and eng.landmark_mesh is not None
    for t in range(spec["frames"]):
        eng.process(*synthetic.render_frame(world, t)[:2])
    traj = eng.trajectory
    rep = eng.report()
    np.savez(out, traj=traj, report=json.dumps({k: v for k, v in rep.items()
                                                if isinstance(v, (int, float))}),
             closures=np.asarray([(c.query_id, c.reference_id)
                                  for c in eng.world_map.closures]).reshape(-1, 2))


def main():
    mode, rank, world, port, src, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    launch.init(rank, world, int(port))
    mesh = mesh_mod.make_mesh()
    try:
        if mode == "kernels":
            kernels(mesh, dict(np.load(src)), f"{out}{rank}.npz")
        else:
            with open(src) as f:
                engine(mesh, json.load(f), f"{out}{rank}.npz")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
