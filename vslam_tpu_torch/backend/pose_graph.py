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

The junction solve and the distribution run as device programs at the
JAX package's compile buckets (ops/program.StaticProgram: on the card
one captured graph a bucket, replayed): the junction graph padded to
Jp = pow2(J, floor 64) poses and Ep = max(pow2(E, floor 128), 2 Jp)
edges, the pose list to pow2(P, floor 512).  Padded poses are decoupled
(no edges, a 1e12 diagonal) and padded edges weigh 0, so the padded
solve is the true-size one.  The normal equations are assembled by
one-hot products, not scatter-adds: every junction is the endpoint of
two or more edges, and a scatter-add with repeated indices sums in a
different order from run to run on CUDA.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from vslam_tpu_torch.ops import lie, program
from vslam_tpu_torch.solve import gn
from vslam_tpu_torch.utils import log
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


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) indicator of idx (torch's one_hot reads its input's range
    back on the CPU)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def normal_equations(r, Ji, Jj, w, ii, jj, P):
    """The Gauss-Newton system of the edge residuals r (E, 6) with
    Jacobians Ji, Jj (E, 6, 6) and weights w (E,) between poses ii, jj:
    H (P, 6, P, 6) and b (P, 6), by one-hot products in a fixed order.
    The four blocks of edge e go to (i, i), (j, j), (i, j) and (j, i);
    the last is the transpose of the third, so H = D + O + O^T with D
    block diagonal and O = sum_e E_i[e]^T (Ji^T w Jj)[e] E_j[e]."""
    E, dt = r.shape[0], r.dtype
    Ei, Ej = _one_hot(ii, P, dt), _one_hot(jj, P, dt)
    Hii = torch.einsum("eri,e,erj->eij", Ji, w, Ji)
    Hjj = torch.einsum("eri,e,erj->eij", Jj, w, Jj)
    Hij = torch.einsum("eri,e,erj->eij", Ji, w, Jj)
    bi = torch.einsum("eri,e,er->ei", Ji, w, r)
    bj = torch.einsum("eri,e,er->ei", Jj, w, r)
    diag = (Ei.T @ Hii.reshape(E, 36) + Ej.T @ Hjj.reshape(E, 36)).reshape(P, 6, 6)
    eyeP = torch.eye(P, dtype=dt, device=r.device)
    D = (diag[:, :, None, :] * eyeP[:, None, :, None]).reshape(6 * P, 6 * P)
    O = (Ei.T @ (Ej[:, :, None, None] * Hij[:, None]).reshape(E, P * 36))
    O = O.reshape(P, P, 6, 6).permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
    H = (D + O + O.T).reshape(P, 6, P, 6)
    b = Ei.T @ bi + Ej.T @ bj
    return H, b


def optimize_pose_graph(graph: PoseGraph, iterations: int = 10, damping: float = 1e-3,
                        robust_kernel_chi2=1.0, anchor_weight: float = 1e6,
                        levenberg: bool = False):
    """Dense damped GN; returns (optimized poses (P, 4, 4), final chi2).

    levenberg=True adapts the damping (halved after an improving
    iterate, quadrupled otherwise), rejects a non-improving iterate and
    returns the best (poses, chi2) seen — the reference's LEVENBERG (and
    DOGLEG) optimization_algorithm.  A failed Cholesky (cholesky_ex info
    != 0) counts as a non-finite step: the poses are kept, as the JAX
    package's NaN-returning cho_factor does.  robust_kernel_chi2: a
    float or a 0-d tensor (a program's buffer).  Nothing is read back and
    no tensor is made from host data, so the solve captures."""
    P = graph.poses.shape[0]
    dev, dt = graph.poses.device, graph.poses.dtype
    ii, jj = graph.edge_i, graph.edge_j
    pr = torch.arange(P, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eyeP = torch.eye(P, dtype=dt, device=dev)
    diag_w = (anchor_weight * (pr == 0).to(dt)
              + torch.where(graph.pose_valid, 0.0, 1e12).to(dt))

    poses = graph.poses
    mu = torch.full((), damping, dtype=dt, device=dev)
    best_poses = poses
    best_chi2 = torch.full((), float("inf"), dtype=dt, device=dev)
    total_chi2 = best_chi2
    for _ in range(iterations):
        r, Ji, Jj = _edge_residual_jac(poses, ii, jj, graph.edge_T_ij)
        chi2 = torch.sum(r * r, dim=1)
        w = torch.where(chi2 > robust_kernel_chi2,
                        robust_kernel_chi2 / torch.clamp(chi2, min=1e-12), 1.0)
        w = w * graph.edge_weight * graph.edge_valid
        H, b = normal_equations(r, Ji, Jj, w, ii, jj, P)
        # Gauge anchor on vertex 0 + damping; invalid poses frozen.
        H = H + torch.einsum("p,pq,ij->piqj", mu + diag_w, eyeP, eye6)

        L, info = torch.linalg.cholesky_ex(H.reshape(6 * P, 6 * P))
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


# ---------------------------------------------------------------------------
# The junction solve and the distribution as device programs
# ---------------------------------------------------------------------------

# The JAX package's bucket floors (log2): junctions, edges, keyframes.
J_FLOOR, E_FLOOR, P_FLOOR = 6, 7, 9  # 64, 128, 512
# Eager solves, captures and replays of the pose-graph programs (CUDA
# only): the junction solves under "eager", "capture", "replay", the
# distributions under "distribute eager", ... .
EVENTS: Counter = Counter()
# The process's programs, by ("junction", Jp, Ep, iterations, levenberg,
# device) or ("distribute", P_pad, Jp, device).
_PROGRAMS: dict[tuple, program.StaticProgram] = {}


def pow2(x: int, floor: int) -> int:
    """The power-of-two bucket of x, at least 2 ** floor."""
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), floor)


def junction_buckets(J: int, E: int) -> tuple[int, int]:
    """(Jp, Ep): the JAX package's padded junction and edge counts (the
    edge bucket tied to the junction tier, E ~ 1.5 J)."""
    Jp = pow2(J, J_FLOOR)
    return Jp, max(pow2(E, E_FLOOR), 2 * Jp)


def junction_program(Jp: int, Ep: int, iterations: int, levenberg: bool,
                     device) -> program.StaticProgram:
    """The process's junction-solve program at (Jp, Ep): the inputs are a
    PoseGraph at that size and the robust kernel (a 0-d buffer, as the
    JAX package traces it); the outputs (poses (Jp, 4, 4), chi2)."""
    device = resolve_device(device)
    key = ("junction", Jp, Ep, iterations, levenberg, device)
    if key not in _PROGRAMS:
        f32 = dict(dtype=torch.float32, device=device)
        eye = torch.eye(4, **f32)
        graph = PoseGraph(
            poses=eye.repeat(Jp, 1, 1),
            edge_i=torch.zeros(Ep, dtype=torch.int64, device=device),
            edge_j=torch.zeros(Ep, dtype=torch.int64, device=device),
            edge_T_ij=eye.repeat(Ep, 1, 1),
            edge_weight=torch.zeros(Ep, **f32),
            edge_valid=torch.zeros(Ep, dtype=torch.bool, device=device),
            pose_valid=torch.zeros(Jp, dtype=torch.bool, device=device))

        def solve(bufs):
            g, robust = bufs
            return optimize_pose_graph(g, iterations=iterations, robust_kernel_chi2=robust,
                                       levenberg=levenberg)

        _PROGRAMS[key] = program.StaticProgram(solve, (graph, torch.ones((), **f32)), EVENTS)
    return _PROGRAMS[key]


def distribute_program(P_pad: int, Jp: int, device) -> program.StaticProgram:
    """The process's distribution program: inputs (est (P_pad, 4, 4),
    corr (Jp, 4, 4), owner (P_pad,), s (P_pad,)), output the corrected
    poses (P_pad, 4, 4)."""
    device = resolve_device(device)
    key = ("distribute", P_pad, Jp, device)
    if key not in _PROGRAMS:
        f32 = dict(dtype=torch.float32, device=device)
        eye = torch.eye(4, **f32)
        bufs = (eye.repeat(P_pad, 1, 1), eye.repeat(Jp, 1, 1),
                torch.zeros(P_pad, dtype=torch.int64, device=device), torch.zeros(P_pad, **f32))
        _PROGRAMS[key] = program.StaticProgram(lambda b: _distribute_corrections(*b), bufs,
                                               EVENTS, label="distribute")
    return _PROGRAMS[key]


def clear_programs() -> None:
    """Forget every shared pose-graph program."""
    _PROGRAMS.clear()


def _padded(a: np.ndarray, n: int, fill) -> np.ndarray:
    """a with its leading axis padded to n rows of `fill`."""
    out = np.empty((n,) + a.shape[1:], a.dtype)
    out[:len(a)] = a
    out[len(a):] = fill
    return out


def junction_graph(poses, odometry, odo_weight, closures, closure_weight: float = 10.0,
                   closure_bucket: int = 4, pad: bool = True):
    """The junction graph of the hierarchical solve, assembled on the
    host: closures compacted, the odometry chain between closure
    endpoints ("junctions") composed into super-edges.  Returns
    (PoseGraph of numpy arrays, junction keyframe ids, J, E); with pad,
    at the junction_buckets size, padded as the JAX package pads it:
    identity poses frozen by pose_valid, edges 0 -> 0 of weight 0."""
    P = len(poses)
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

    E = len(se_i)
    Jp, Ep = junction_buckets(J, E) if pad else (J, E)
    eye = np.eye(4, dtype=np.float32)
    graph = PoseGraph(
        poses=_padded(poses[junc].astype(np.float32), Jp, eye),
        edge_i=_padded(np.asarray(se_i, np.int64), Ep, 0),
        edge_j=_padded(np.asarray(se_j, np.int64), Ep, 0),
        edge_T_ij=_padded(np.stack(se_T).astype(np.float32), Ep, eye),
        edge_weight=_padded(np.asarray(se_w, np.float32), Ep, 0.0),
        edge_valid=np.arange(Ep) < E,
        pose_valid=np.arange(Jp) < J)
    return graph, junc, J, E


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
    junction solve and the distribution run on `device` as the programs
    of their buckets; the stage clock splits the call into the host
    assembly (pg_assembly), the junction program (pg_junction_solve) and
    the distribution (pg_distribution), each ending in its host read.
    Returns (optimized (P, 4, 4) np poses, final junction chi2)."""
    device = resolve_device(device)
    P = len(poses)
    if P < 3 or not closures:
        return poses.copy(), 0.0
    with log.measure("pg_assembly"):
        graph, junc, J, _ = junction_graph(poses, odometry, odo_weight, closures,
                                           closure_weight, closure_bucket)
        Jp, Ep = len(graph.poses), len(graph.edge_i)
    with log.measure("pg_junction_solve"):
        prog = junction_program(Jp, Ep, iterations, levenberg, device)
        opt, chi2 = prog.run((graph, np.float32(robust_kernel_chi2)))
        opt = opt.cpu().numpy()[:J]
        chi2 = float(chi2)

    with log.measure("pg_distribution"):
        corr = np.einsum("jab,jbc->jac", opt, np.linalg.inv(poses[junc])).astype(np.float32)
        junc_arr = np.asarray(junc)
        k_idx = np.arange(P)
        owner = np.clip(np.searchsorted(junc_arr, k_idx, side="right") - 1, 0, J - 2)
        seg_len = np.maximum(junc_arr[owner + 1] - junc_arr[owner], 1)
        s = ((k_idx - junc_arr[owner]) / seg_len).astype(np.float32)
        P_pad = pow2(P, P_FLOOR)
        eye = np.eye(4, dtype=np.float32)
        dist = distribute_program(P_pad, Jp, device)
        out = dist.run((_padded(poses.astype(np.float32), P_pad, eye), _padded(corr, Jp, eye),
                        _padded(owner.astype(np.int64), P_pad, 0),
                        _padded(s, P_pad, 0.0)))
        out = out.cpu().numpy()[:P]
    return out, chi2


def warm_hierarchical_buckets(max_keyframes: int = 512, device=DEFAULT_DEVICE) -> None:
    """Run the hierarchical solver on each of the JAX package's three
    warm-up problems (P poses, C closures: max_keyframes / 4 and 24, / 2
    and 50, - 2 and 110) on `device` until its junction and distribution
    programs are captured, so the closures of a timed run replay them
    (the JAX package's warm_hierarchical_buckets, which compiles them).
    At the default the problems land at Jp 64, 64 and 256 (the middle
    one's closures, 2 keyframes apart, compact to 25), as in JAX: a
    graph of 65-128 junctions still captures its program in the run."""
    device = resolve_device(device)
    for P, C in ((max_keyframes // 4, 24), (max_keyframes // 2, 50),
                 (max_keyframes - 2, 110)):
        poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        poses[:, 0, 3] = np.arange(P, dtype=np.float32)
        odo = np.tile(np.eye(4, dtype=np.float32), (P - 1, 1, 1))
        odo[:, 0, 3] = 1.0
        closures = [(i * ((P // 2) // C), P // 2 + i * ((P // 2) // C),
                     np.eye(4, dtype=np.float32)) for i in range(C)]
        for _ in range(2 if device.type == "cuda" else 1):
            optimize_pose_graph_hierarchical(poses, odo, np.ones(P - 1, np.float32),
                                             closures, iterations=10, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
