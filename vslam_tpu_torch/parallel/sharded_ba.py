"""Landmark-sharded Schur-complement bundle adjustment (port of
vslam_tpu/parallel/sharded_ba.py).

Each rank holds one block of the landmarks with their grouped
observations, builds its partial reduced camera system with
backend/ba.py's build_reduced_system, and one all_reduce(SUM) of (S,
b_S, chi2) gives every rank the whole 6P x 6P system, which each solves
(P is small); the landmark back-substitution is local to the block.  The
odometry pose factors are added inside solve_reduced_and_backsub, after
the reduction, so they count once.  The one-device and the sharded
solvers share those two functions and cannot drift apart.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vslam_tpu_torch.backend import ba as ba_mod
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.parallel import mesh as mesh_mod

# The landmark-indexed fields of a BAProblem: sharded by rows.
LANDMARK_FIELDS = ("xyz", "obs_cam", "obs_uv4", "obs_weight", "obs_mask", "lm_valid")


def shard_problem(prob: ba_mod.BAProblem, mesh: mesh_mod.Mesh):
    """This rank's block of a whole problem: the landmark rows padded (with
    lm_valid False) to a multiple of the mesh size and split; cameras and
    pose factors replicated.  Returns (block, number of real landmarks)."""
    L = prob.xyz.shape[0]
    fields = {k: mesh_mod.shard_rows(mesh_mod.pad_to_multiple(getattr(prob, k), mesh.size)[0],
                                     mesh)
              for k in LANDMARK_FIELDS}
    return prob._replace(**fields), L


def bundle_adjust_sharded(cam: cam_ops.CameraParams, prob_shard: ba_mod.BAProblem,
                          mesh: mesh_mod.Mesh, config: ba_mod.BAConfig = ba_mod.BAConfig()):
    """Distributed Schur BA over config.iterations rounds with no host read
    but the collectives.  prob_shard: this rank's landmark block (cameras
    and pose factors the same on every rank).  Returns (T_wc (P, 4, 4),
    the same on every rank; this rank's xyz block; chi2 history
    (iterations,))."""
    T_wc, xyz = prob_shard.T_wc, prob_shard.xyz
    chi2s = []
    for _ in range(config.iterations):
        p = prob_shard._replace(xyz=xyz)
        S, b_S, Winv, b_l, Y, chi2 = ba_mod.build_reduced_system(cam, T_wc, p, config)
        # One reduction a round: the partial camera systems of every block.
        P = S.shape[0]
        flat = mesh_mod.all_reduce(
            torch.cat([S.reshape(-1), b_S.reshape(-1), chi2.reshape(1)]), dist.ReduceOp.SUM,
            mesh)
        S = flat[:S.numel()].reshape(P, 6, P, 6)
        b_S = flat[S.numel():S.numel() + P * 6].reshape(P, 6)
        T_wc, xyz = ba_mod.solve_reduced_and_backsub(T_wc, p, S, b_S, Winv, b_l, Y, config)
        chi2s.append(flat[-1])
    return T_wc, xyz, torch.stack(chi2s)
