"""Pose-graph optimization on SE(3), the loop-closure back-end (port of the
production path of vslam_tpu/backend/pose_graph.py).

Vertices are keyframe poses; binary edges are odometry and loop-closure
constraints with residual log_se3(T_ij^-1 T_i^-1 T_j) (reference g2o pose
graph, graph_optimizer.cpp:264-317,411-457).  The engine calls
optimize_pose_graph_hierarchical: closures are compacted, the odometry
chain between closure endpoints ("junctions") contracts into composed
super-edges, the junction graph is solved by dense damped Gauss-Newton
(optimize_pose_graph) and the interior poses receive the geodesic blend of
their segment ends' corrections.

The JAX package pads the junction graph and the pose list to power-of-two
compile buckets; padded vertices are decoupled (no edges, a 1e12
diagonal), so the port solves at the true size and gets the same answer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vslam_tpu_torch.ops import lie
from vslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class PoseGraph(NamedTuple):
    """Edge-list pose graph (masked)."""

    poses: torch.Tensor  # (P, 4, 4) T_world_keyframe
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    edge_T_ij: torch.Tensor  # (E, 4, 4) measured T_i^-1 T_j
    edge_weight: torch.Tensor  # (E,) f32 information scale (closures x10)
    edge_valid: torch.Tensor  # (E,) bool
    pose_valid: torch.Tensor  # (P,) bool


def _edge_residual_jac(poses, i, j, T_ij):
    """Residuals and closed-form Jacobians wrt the left tangents of poses
    i and j, batched over edges.  With Q = T_ij^-1 T_i^-1 and
    r0 = log(Q T_j): r(dxj) ~= r0 + Jl^-1(r0) Ad_Q dxj, and Ji = -Jj (the
    residual is invariant under a common left perturbation)."""
    Q = lie.inverse(T_ij) @ lie.inverse(poses[i])
    r = lie.log_se3(Q @ poses[j])
    Jj = lie.jl_inv_se3(r) @ lie.adjoint_se3(Q)
    return r, -Jj, Jj


def optimize_pose_graph(graph: PoseGraph, iterations: int = 10, damping: float = 1e-3,
                        robust_kernel_chi2: float = 1.0, anchor_weight: float = 1e6,
                        levenberg: bool = False):
    """Dense damped GN; returns (optimized poses (P, 4, 4), final chi2).

    levenberg=True adapts the damping (halved after an improving
    iterate, quadrupled otherwise), rejects a non-improving iterate and
    returns the best (poses, chi2) seen — the reference's LEVENBERG (and
    DOGLEG) optimization_algorithm.  A failed Cholesky (cholesky_ex info
    != 0) counts as a non-finite step: the poses are kept, as the JAX
    package's NaN-returning cho_factor does."""
    P = graph.poses.shape[0]
    dev, dt = graph.poses.device, graph.poses.dtype
    ii, jj = graph.edge_i, graph.edge_j
    pr = torch.arange(P, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag_w = (anchor_weight * (pr == 0).to(dt)
              + torch.where(graph.pose_valid, 0.0, 1e12).to(dt))

    poses = graph.poses
    mu = torch.tensor(damping, dtype=dt, device=dev)
    best_poses = poses
    best_chi2 = torch.tensor(float("inf"), dtype=dt, device=dev)
    total_chi2 = best_chi2
    for _ in range(iterations):
        r, Ji, Jj = _edge_residual_jac(poses, ii, jj, graph.edge_T_ij)
        chi2 = torch.sum(r * r, dim=1)
        w = torch.where(chi2 > robust_kernel_chi2,
                        robust_kernel_chi2 / torch.clamp(chi2, min=1e-12), 1.0)
        w = w * graph.edge_weight * graph.edge_valid

        Hii = torch.einsum("eri,e,erj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eri,e,erj->eij", Jj, w, Jj)
        Hij = torch.einsum("eri,e,erj->eij", Ji, w, Jj)
        bi = torch.einsum("eri,e,er->ei", Ji, w, r)
        bj = torch.einsum("eri,e,er->ei", Jj, w, r)
        H = torch.zeros((P, P, 6, 6), dtype=dt, device=dev)
        H.index_put_((ii, ii), Hii, accumulate=True)
        H.index_put_((jj, jj), Hjj, accumulate=True)
        H.index_put_((ii, jj), Hij, accumulate=True)
        H.index_put_((jj, ii), Hij.transpose(-1, -2), accumulate=True)
        b = torch.zeros((P, 6), dtype=dt, device=dev).index_add(0, ii, bi).index_add(0, jj, bj)
        # Gauge anchor on vertex 0 + damping; invalid poses frozen.
        H.index_put_((pr, pr), (mu + diag_w)[:, None, None] * eye6, accumulate=True)

        L, info = torch.linalg.cholesky_ex(H.permute(0, 2, 1, 3).reshape(6 * P, 6 * P))
        dx = -torch.cholesky_solve(b.reshape(6 * P, 1), L).reshape(P, 6)
        norm = torch.linalg.vector_norm(dx, dim=1, keepdim=True)
        dx = dx * torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
        ok = torch.all(torch.isfinite(dx)) & (info == 0)
        new_poses = torch.where(
            ok, lie.orthonormalize_transform(lie.exp_se3(dx) @ poses), poses)
        total_chi2 = torch.sum(chi2 * w)
        if levenberg:
            # total_chi2 is the chi2 of the incoming iterate: a
            # non-improving one is rejected and the next linearization
            # restarts from the best iterate with raised damping.
            improved = total_chi2 < best_chi2
            best_poses = torch.where(improved, poses, best_poses)
            best_chi2 = torch.minimum(total_chi2, best_chi2)
            mu = torch.clamp(torch.where(improved, mu * 0.5, mu * 4.0), damping, 1e2)
            poses = torch.where(improved, new_poses, best_poses)
        else:
            poses = new_poses
    if levenberg:
        return best_poses, best_chi2
    return poses, total_chi2


def compact_closures(closures, bucket: int = 4):
    """Collapse closure edges to one per (ref // bucket, query // bucket)
    cell, keeping the most recently added edge of each cell.
    closures: iterable of (ref_id, query_id, T_ij)."""
    best = {}
    for e in closures:
        best[(e[0] // bucket, e[1] // bucket)] = e
    return sorted(best.values(), key=lambda e: (e[1], e[0]))


def _distribute_corrections(est, corr, owner, s):
    """Geodesic blend of segment-end corrections, batched over poses.

    est: (P, 4, 4) current poses; corr: (J, 4, 4) per-junction corrections
    (opt @ inv(est)); owner: (P,) segment index n (pose k lies in
    [junc[n], junc[n+1]]); s: (P,) arc position in [0, 1].
    Returns exp(s * log(C_{n+1} C_n^-1)) C_n @ est."""
    J = corr.shape[0]
    Ca = corr[owner]
    Cb = corr[torch.clamp(owner + 1, max=J - 1)]
    delta = lie.log_se3(Cb @ lie.inverse(Ca))
    Ck = lie.exp_se3(s[:, None] * delta) @ Ca
    return lie.orthonormalize_transform(Ck @ est)


def optimize_pose_graph_hierarchical(poses, odometry, odo_weight, closures,
                                     iterations: int = 10,
                                     robust_kernel_chi2: float = 1.0,
                                     closure_weight: float = 10.0,
                                     closure_bucket: int = 4,
                                     levenberg: bool = False, device=DEFAULT_DEVICE):
    """Hierarchical pose-graph optimization (the engine's back-end).

    poses: (P, 4, 4) np current keyframe poses; odometry: (P-1, 4, 4) np
    measured T_{k,k+1}; odo_weight: (P-1,) np break-aware edge weights;
    closures: list of (ref_id, query_id, T_ij) np closure edges.  The
    junction solve and the distribution run on `device`.
    Returns (optimized (P, 4, 4) np poses, final junction chi2)."""
    device = resolve_device(device)
    P = len(poses)
    if P < 3 or not closures:
        return poses.copy(), 0.0
    cc = compact_closures(closures, bucket=closure_bucket)
    junc = sorted({0, P - 1} | {int(i) for i, _, _ in cc} | {int(j) for _, j, _ in cc})
    jidx = {k: n for n, k in enumerate(junc)}
    J = len(junc)

    # Super-edges: composed odometry between consecutive junctions, with
    # information composed in series (w = 1 / sum(1 / w_k): a broken edge
    # inside a segment keeps the whole super-edge soft).
    se_i, se_j, se_T, se_w = [], [], [], []
    for a, b in zip(junc[:-1], junc[1:]):
        T = np.eye(4, dtype=np.float32)
        for k in range(a, b):
            T = T @ odometry[k]
        se_i.append(jidx[a])
        se_j.append(jidx[b])
        se_T.append(T)
        se_w.append(1.0 / float(np.sum(1.0 / np.maximum(odo_weight[a:b], 1e-9))))
    for (i, j, T_ij) in cc:
        se_i.append(jidx[int(i)])
        se_j.append(jidx[int(j)])
        se_T.append(np.asarray(T_ij, np.float32))
        se_w.append(closure_weight)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    E = len(se_i)
    graph = PoseGraph(
        poses=dev(poses[junc].astype(np.float32)),
        edge_i=dev(se_i, torch.int64),
        edge_j=dev(se_j, torch.int64),
        edge_T_ij=dev(np.stack(se_T).astype(np.float32)),
        edge_weight=dev(np.asarray(se_w, np.float32)),
        edge_valid=torch.ones(E, dtype=torch.bool, device=device),
        pose_valid=torch.ones(J, dtype=torch.bool, device=device),
    )
    opt, chi2 = optimize_pose_graph(graph, iterations=iterations,
                                    robust_kernel_chi2=robust_kernel_chi2,
                                    levenberg=levenberg)
    opt = opt.cpu().numpy()

    corr = np.einsum("jab,jbc->jac", opt, np.linalg.inv(poses[junc])).astype(np.float32)
    junc_arr = np.asarray(junc)
    k_idx = np.arange(P)
    owner = np.clip(np.searchsorted(junc_arr, k_idx, side="right") - 1, 0, J - 2)
    seg_len = np.maximum(junc_arr[owner + 1] - junc_arr[owner], 1)
    s = ((k_idx - junc_arr[owner]) / seg_len).astype(np.float32)
    out = _distribute_corrections(dev(poses.astype(np.float32)), dev(corr),
                                  dev(owner, torch.int64), dev(s))
    return out.cpu().numpy(), float(chi2)
