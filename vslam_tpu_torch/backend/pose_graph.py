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

The chain solver of the JAX package (optimize_pose_graph_chain: odometry
chain + closures solved in increment space by Woodbury) is here too; only
tests and the chip smoke call it.

The JAX package pads the junction graph and the pose list to power-of-two
compile buckets; padded vertices are decoupled (no edges, a 1e12
diagonal), so the port solves at the true size and gets the same answer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vslam_tpu_torch.ops import lie
from vslam_tpu_torch.solve import gn
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


# ---------------------------------------------------------------------------
# Chain + closure solver in increment space (the JAX package's
# optimize_pose_graph_chain; its tests and the chip smoke call it, the
# engine keeps the hierarchical solver, as the JAX engine does)
# ---------------------------------------------------------------------------
#
# The edge residual log(T_ij^-1 T_i^-1 T_j) is invariant under a common
# left perturbation of both endpoints, so Ji = -Jj.  In chain increments
# u_k = dx_k - dx_{k-1} every odometry edge (k, k+1) depends on u_{k+1}
# alone (a block-diagonal Hessian D) and a closure (i, j) on the signed
# sum of u over (min(i,j), max(i,j)].  The system (D + R^T R) u = -b is
# solved by Woodbury: batched 6x6 inverses of D and one (6C x 6C)
# capacitance system, then dx = cumsum(u).  The gauge is fixed by the
# damping on u_0, which has no data term.


class ChainPoseGraph(NamedTuple):
    """Chain-structured pose graph: odometry edges (k, k+1) + closures."""

    poses: torch.Tensor  # (P, 4, 4)
    odo_T: torch.Tensor  # (P, 4, 4); row k = measured T_{k,k+1} (row P-1 pad)
    odo_weight: torch.Tensor  # (P,) f32 (break-aware weights; row P-1 pad)
    odo_valid: torch.Tensor  # (P,) bool; True on rows k with a (k, k+1) edge
    clo_i: torch.Tensor  # (C,) int64
    clo_j: torch.Tensor  # (C,) int64
    clo_T: torch.Tensor  # (C, 4, 4)
    clo_weight: torch.Tensor  # (C,)
    clo_valid: torch.Tensor  # (C,) bool
    pose_valid: torch.Tensor  # (P,) bool


def _pcg_spd(A: torch.Tensor, b: torch.Tensor, iterations: int, tol: float = 1e-6):
    """Jacobi-preconditioned conjugate gradients for a small SPD system,
    iterations rounds with no host read: once the residual norm is at or
    below tol * |b| the system is frozen (x, r, p stop changing), where
    the JAX package's while_loop stops."""
    dinv = 1.0 / torch.clamp(torch.diagonal(A), min=1e-12)
    bnorm = torch.linalg.vector_norm(b)
    x = torch.zeros_like(b)
    r = b
    p = dinv * b
    rz = r @ p
    running = torch.ones((), dtype=torch.bool, device=b.device)
    for _ in range(iterations):
        running = running & (torch.linalg.vector_norm(r) > tol * bnorm)
        Ap = A @ p
        alpha = rz / torch.clamp(p @ Ap, min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = dinv * r_n
        rz_n = r_n @ z
        p_n = z + rz_n / torch.clamp(rz, min=1e-30) * p
        x = torch.where(running, x_n, x)
        r = torch.where(running, r_n, r)
        p = torch.where(running, p_n, p)
        rz = torch.where(running, rz_n, rz)
    return x


def _edge_residual_jac_j(poses, i, j, T_ij):
    """Residuals and the closed-form Jacobians wrt the left tangent of
    pose j only, batched over edges (wrt pose i it is the negation)."""
    Q = lie.inverse(T_ij) @ lie.inverse(poses[i])
    r = lie.log_se3(Q @ poses[j])
    return r, lie.jl_inv_se3(r) @ lie.adjoint_se3(Q)


def _robust_w(chi2, robust_kernel_chi2):
    return torch.where(chi2 > robust_kernel_chi2,
                       robust_kernel_chi2 / torch.clamp(chi2, min=1e-12), 1.0)


def optimize_pose_graph_chain(graph: ChainPoseGraph, iterations: int = 10,
                              damping: float = 1e-3, robust_kernel_chi2: float = 1.0,
                              levenberg: bool = False):
    """Chain + Woodbury Gauss-Newton in increment space; returns (optimized
    poses (P, 4, 4), final chi2).  The objective of optimize_pose_graph
    restricted to chain odometry edges (the damping acts on increments);
    O(P * C) work a round.  The capacitance system is factorized by
    Cholesky while 6C <= 1536 and solved by _pcg_spd above that.  A
    failed factorization (cholesky_ex info != 0) counts as a non-finite
    step: the poses are kept.  levenberg=True: adaptive damping with the
    best iterate carried, as optimize_pose_graph."""
    P = graph.poses.shape[0]
    C = graph.clo_i.shape[0]
    dev, dt = graph.poses.device, graph.poses.dtype
    ks = torch.arange(P, device=dev)
    odo_j = torch.clamp(ks + 1, max=P - 1)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    lo = torch.minimum(graph.clo_i, graph.clo_j)
    hi = torch.maximum(graph.clo_i, graph.clo_j)
    sgn = torch.where(graph.clo_j >= graph.clo_i, 1.0, -1.0).to(dt)
    # Signed interval indicator sm[c, m] = s_c * [lo_c < m <= hi_c].
    sm = sgn[:, None] * ((ks[None, :] > lo[:, None]) & (ks[None, :] <= hi[:, None])).to(dt)

    poses = graph.poses
    mu = torch.tensor(damping, dtype=dt, device=dev)
    best_poses = poses
    best_chi2 = torch.tensor(float("inf"), dtype=dt, device=dev)
    total_chi2 = best_chi2
    for _ in range(iterations):
        # Odometry (chain) edges: edge k acts on u_{k+1}, block-diagonal.
        r_o, J_o = _edge_residual_jac_j(poses, ks, odo_j, graph.odo_T)
        chi2_o = torch.sum(r_o * r_o, dim=1)
        w_o = _robust_w(chi2_o, robust_kernel_chi2) * graph.odo_weight * graph.odo_valid
        He = torch.einsum("eri,e,erj->eij", J_o, w_o, J_o)
        be = torch.einsum("eri,e,er->ei", J_o, w_o, r_o)
        # The damping pins u_0 (the gauge) and regularizes every
        # increment; padded poses see only the damping (their increments
        # are 0), so they move rigidly with the last real pose.
        D = torch.cat([torch.zeros((1, 6, 6), dtype=dt, device=dev), He[:-1]]) + mu * eye6
        b = torch.cat([torch.zeros((1, 6), dtype=dt, device=dev), be[:-1]])

        # Closure edges: signed interval rows.
        r_c, J_c = _edge_residual_jac_j(poses, graph.clo_i, graph.clo_j, graph.clo_T)
        chi2_c = torch.sum(r_c * r_c, dim=1)
        w_c = _robust_w(chi2_c, robust_kernel_chi2) * graph.clo_weight * graph.clo_valid
        sw = torch.sqrt(torch.clamp(w_c, min=0.0))
        Jtr = torch.einsum("cri,cr->ci", J_c, w_c[:, None] * r_c)
        b = b + torch.einsum("cp,ci->pi", sm, Jtr)

        # Woodbury with the block-diagonal D.
        Dinv = gn.inv6(D)
        y = torch.einsum("pij,pj->pi", Dinv, b)
        JT = sw[:, None, None] * J_c.transpose(-1, -2)  # sqrt(w) J^T
        Z = torch.einsum("cp,pij,cjk->pcik", sm, Dinv, JT)  # T^-1 R^T on intervals
        RJ = sw[:, None, None] * J_c
        Ry = torch.einsum("cri,ci->cr", RJ, torch.einsum("cp,pi->ci", sm, y)).reshape(C * 6)
        Zsum = torch.einsum("cp,pdik->cdik", sm, Z)
        M = (torch.eye(C * 6, dtype=dt, device=dev)
             + torch.einsum("cri,cdik->crdk", RJ, Zsum).reshape(C * 6, C * 6))
        if C * 6 <= 1536:
            L, info = torch.linalg.cholesky_ex(M)
            lam = torch.cholesky_solve(Ry[:, None], L)[:, 0]
            factored = info == 0
        else:
            lam = _pcg_spd(M, Ry, iterations=min(6 * C, 384))
            factored = torch.ones((), dtype=torch.bool, device=dev)
        u = -(y - torch.einsum("pcik,ck->pi", Z, lam.reshape(C, 6)))
        dx = torch.cumsum(u, dim=0)  # back to pose space

        norm = torch.linalg.vector_norm(dx, dim=1, keepdim=True)
        dx = dx * torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
        ok = torch.all(torch.isfinite(dx)) & factored
        new_poses = torch.where(
            ok, lie.orthonormalize_transform(lie.exp_se3(dx) @ poses), poses)
        total_chi2 = torch.sum(chi2_o * w_o) + torch.sum(chi2_c * w_c)
        if levenberg:
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


def warm_hierarchical_buckets(max_keyframes: int = 512, device=DEFAULT_DEVICE) -> None:
    """Run the hierarchical solver once at each of the JAX package's
    three program tiers (P poses, C closures: max_keyframes / 4 and 24,
    / 2 and 50, - 2 and 110) on `device`, so the first closure of a timed
    run meets a warm device (the JAX package's warm_hierarchical_buckets,
    which compiles them)."""
    for P, C in ((max_keyframes // 4, 24), (max_keyframes // 2, 50),
                 (max_keyframes - 2, 110)):
        poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        poses[:, 0, 3] = np.arange(P, dtype=np.float32)
        odo = np.tile(np.eye(4, dtype=np.float32), (P - 1, 1, 1))
        odo[:, 0, 3] = 1.0
        closures = [(i * ((P // 2) // C), P // 2 + i * ((P // 2) // C),
                     np.eye(4, dtype=np.float32)) for i in range(C)]
        optimize_pose_graph_hierarchical(poses, odo, np.ones(P - 1, np.float32), closures,
                                         iterations=10, device=device)
