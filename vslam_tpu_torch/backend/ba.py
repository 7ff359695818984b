"""Schur-complement bundle adjustment on one device (port of
vslam_tpu/backend/ba.py).

Observations are grouped by landmark with a fixed slot count O (L, O):
the landmark block of the Hessian is 3x3 block-diagonal, so landmark
elimination is a batch of 3x3 inversions, and the reduced camera system
(6P x 6P) is solved densely by Cholesky.

Differences from the JAX package, same answer:
  * Jacobians are closed forms (JAX takes jacfwd through exp(dx) @ T,
    the inverse and the stereo projection);
  * the reduced system is assembled by one-hot products, not scatter-adds
    with repeated indices: with E[l, a, p] = [obs_cam[l, a] == p] the
    Schur cross term is one (6P x 3L) @ (3L x 6P) product, so the sum
    order does not change from run to run on CUDA (atomics would), and
    JAX's (L, O, O, 6, 6) pair tensor is never built;
  * a failed Cholesky (cholesky_ex info != 0) gives the zero camera step
    that JAX's NaN-returning cho_factor gives after its isfinite guard.

ba_program gives the solve at one (P, L, O) bucket as a device program
(ops/program.StaticProgram; on the card one captured graph, replayed),
as the JAX package jits bundle_adjust at the runner's padded sizes.

Robust kernel: chi2 clamping as IRLS weights (reference-style).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from vslam_tpu_torch.backend import pose_graph as pg
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.ops import lie, program
from vslam_tpu_torch.solve.gn import inv3
from vslam_tpu_torch.utils.device import resolve_device


class BAProblem(NamedTuple):
    """Bundle-adjustment problem with landmark-grouped observations; the
    optional odometry rows add pose-pose factors between consecutive
    cameras (reference GraphOptimizer::_setPoseEdge)."""

    T_wc: torch.Tensor  # (P, 4, 4) camera poses (world <- cam)
    xyz: torch.Tensor  # (L, 3) landmark world positions
    obs_cam: torch.Tensor  # (L, O) int64 camera index per observation
    obs_uv4: torch.Tensor  # (L, O, 4) stereo measurements [uL, vL, uR, vR]
    obs_weight: torch.Tensor  # (L, O) f32
    obs_mask: torch.Tensor  # (L, O) bool
    lm_valid: torch.Tensor  # (L,) bool
    cam_fixed: torch.Tensor  # (P,) bool: gauge-fixed cameras
    # Row k is the measured T_{k,k+1}; odo_weight scales the information
    # diag (0 disables the edge; None disables the factor family).
    odo_T: torch.Tensor | None = None  # (P, 4, 4); row P-1 is padding
    odo_weight: torch.Tensor | None = None  # (P,) f32
    odo_info: torch.Tensor | None = None  # (6,) per-dim information diag


class BAConfig(NamedTuple):
    iterations: int = 10
    damping: float = 1.0
    robust_chi2: float = 25.0
    max_pose_step: float = 1.0
    max_point_step: float = 5.0
    fixed_weight: float = 1e8


def stereo_residual_jacobians(cam: cam_ops.CameraParams, T_wc: torch.Tensor,
                              xyz: torch.Tensor, uv4: torch.Tensor, eps: float = 1e-6):
    """Stereo reprojection residual of world points seen from cameras
    T_wc, and its closed-form Jacobians wrt the camera's left tangent
    [v, w] (exp(dx) @ T_wc) and wrt the world point; batched over leading
    dims (T_wc (..., 4, 4), xyz (..., 3), uv4 (..., 4)).

    p = R^T (x - t) gives dp/dv = -R^T, dp/dw = R^T hat(x) and dp/dx = R^T.
    Returns (r (..., 4), Jc (..., 4, 6), Jl (..., 4, 3))."""
    Rt = T_wc[..., :3, :3].transpose(-1, -2)
    p = torch.einsum("...ij,...j->...i", Rt, xyz - T_wc[..., :3, 3])
    uv_l, uv_r, z = cam_ops.project_stereo(cam, p, eps)
    r = torch.cat([uv_l, uv_r], dim=-1) - uv4
    zs = torch.clamp(z, min=eps)
    g = (z > eps).to(p.dtype)  # d max(z, eps) / dz
    zi2 = g / (zs * zs)
    zero = torch.zeros_like(z)
    du_l = torch.stack([cam.fx / zs, zero, -cam.fx * p[..., 0] * zi2], dim=-1)
    dv = torch.stack([zero, cam.fy / zs, -cam.fy * p[..., 1] * zi2], dim=-1)
    du_r = du_l + torch.stack([zero, zero, cam.fx * cam.baseline_m * zi2], dim=-1)
    Jp = torch.stack([du_l, dv, du_r, dv], dim=-2)  # (..., 4, 3)
    Jl = Jp @ Rt
    Jc = torch.cat([-Jl, Jl @ lie.hat(xyz)], dim=-1)
    return r, Jc, Jl


def _linearize(cam, T_wc, prob: BAProblem, robust_chi2: float):
    """Per-landmark linearization over its O observation slots.
    Returns (W (L,3,3), b_l (L,3), U (L,O,6,6), Y (L,O,6,3), b_c (L,O,6),
    chi2 (L,))."""
    r, Jc, Jl = stereo_residual_jacobians(cam, T_wc[prob.obs_cam], prob.xyz[:, None, :],
                                          prob.obs_uv4)
    chi2 = torch.sum(r * r, dim=-1)  # (L, O)
    rw = torch.where(chi2 > robust_chi2, robust_chi2 / torch.clamp(chi2, min=1e-12), 1.0)
    ww = prob.obs_weight * rw * prob.obs_mask.to(T_wc.dtype)
    W = torch.einsum("lori,lo,lorj->lij", Jl, ww, Jl)
    b_l = torch.einsum("lori,lo,lor->li", Jl, ww, r)
    U = torch.einsum("lori,lo,lorj->loij", Jc, ww, Jc)
    Y = torch.einsum("lori,lo,lorj->loij", Jc, ww, Jl)
    b_c = torch.einsum("lori,lo,lor->loi", Jc, ww, r)
    return W, b_l, U, Y, b_c, torch.sum(chi2 * ww, dim=-1)


def build_reduced_system(cam, T_wc, prob: BAProblem, config: BAConfig):
    """Assemble the Schur-reduced camera system.

    Returns (S (P,6,P,6), b_S (P,6), Winv (L,3,3), b_l (L,3), Y (L,O,6,3),
    chi2)."""
    P = T_wc.shape[0]
    L = prob.xyz.shape[0]
    dt = T_wc.dtype
    W, b_l, U, Y, b_c, chi2 = _linearize(cam, T_wc, prob, config.robust_chi2)
    lm_w = prob.lm_valid.to(dt)
    W = W * lm_w[:, None, None]
    b_l = b_l * lm_w[:, None]
    U = U * lm_w[:, None, None, None]
    Y = Y * lm_w[:, None, None, None]
    b_c = b_c * lm_w[:, None, None]
    chi2 = torch.sum(chi2 * lm_w)

    eye3 = torch.eye(3, dtype=dt, device=T_wc.device)
    Winv = inv3(W + config.damping * eye3)

    E = pg._one_hot(prob.obs_cam, P, dt)  # (L, O, P)
    eyeP = torch.eye(P, dtype=dt, device=T_wc.device)
    YW = Y @ Winv[:, None]  # (L, O, 6, 3)
    # Block diagonal and gradient, per observation's camera.
    S = torch.einsum("pij,pq->piqj", torch.einsum("lap,laij->pij", E, U), eyeP)
    b_S = (torch.einsum("lap,lai->pi", E, b_c)
           - torch.einsum("lap,lai->pi", E, (YW @ b_l[:, None, :, None])[..., 0]))
    # Schur cross terms: A[l, p] = sum_a E[l,a,p] YW[l,a], B likewise of Y;
    # S -= sum_l A[l]^T-blocks B[l] as one (6P x 3L) @ (3L x 6P) product.
    A = torch.einsum("lap,laik->pilk", E, YW).reshape(P * 6, L * 3)
    B = torch.einsum("lap,laik->pilk", E, Y).reshape(P * 6, L * 3)
    S = S - (A @ B.T).reshape(P, 6, P, 6)
    return S, b_S, Winv, b_l, Y, chi2


def _odometry_terms(T_wc, prob: BAProblem):
    """The pose-pose factors' normal-equation blocks (P, 6, P, 6) and
    gradient (P, 6), placed by one-hot products as the system above."""
    P = T_wc.shape[0]
    dt, dev = T_wc.dtype, T_wc.device
    ks = torch.arange(P, device=dev)
    jj = torch.clamp(ks + 1, max=P - 1)
    r_o, Ji, Jj = pg._edge_residual_jac(T_wc, ks, jj, prob.odo_T)
    w = prob.odo_weight * (ks < P - 1).to(dt)
    om = prob.odo_info
    Hii = torch.einsum("eri,e,r,erj->eij", Ji, w, om, Ji)
    Hjj = torch.einsum("eri,e,r,erj->eij", Jj, w, om, Jj)
    Hij = torch.einsum("eri,e,r,erj->eij", Ji, w, om, Jj)
    bi = torch.einsum("eri,e,r,er->ei", Ji, w, om, r_o)
    bj = torch.einsum("eri,e,r,er->ei", Jj, w, om, r_o)
    Ei = pg._one_hot(ks, P, dt)
    Ej = pg._one_hot(jj, P, dt)
    H = (torch.einsum("ep,eq,eij->piqj", Ei, Ei, Hii)
         + torch.einsum("ep,eq,eij->piqj", Ej, Ej, Hjj)
         + torch.einsum("ep,eq,eij->piqj", Ei, Ej, Hij)
         + torch.einsum("ep,eq,eji->piqj", Ej, Ei, Hij))
    b = torch.einsum("ep,ei->pi", Ei, bi) + torch.einsum("ep,ei->pi", Ej, bj)
    return H, b


def solve_reduced_and_backsub(T_wc, prob: BAProblem, S, b_S, Winv, b_l, Y,
                              config: BAConfig):
    """Solve the reduced camera system and back-substitute the landmark
    steps dx_l = -Winv (b_l + sum_a Y_a^T dx_{c_a}).  Returns (T_new, xyz_new)."""
    P = T_wc.shape[0]
    dt, dev = T_wc.dtype, T_wc.device
    diag = config.damping + torch.where(prob.cam_fixed, config.fixed_weight, 0.0).to(dt)
    S = S + torch.einsum("p,pq,ij->piqj", diag, torch.eye(P, dtype=dt, device=dev),
                         torch.eye(6, dtype=dt, device=dev))
    if prob.odo_T is not None:
        H_o, b_o = _odometry_terms(T_wc, prob)
        S = S + H_o
        b_S = b_S + b_o

    Lc, info = torch.linalg.cholesky_ex(S.reshape(P * 6, P * 6))
    dx_c = -torch.cholesky_solve(b_S.reshape(P * 6, 1), Lc).reshape(P, 6)
    dx_c = torch.where(info == 0, dx_c, 0.0)
    n = torch.linalg.vector_norm(dx_c, dim=1, keepdim=True)
    dx_c = dx_c * torch.clamp(config.max_pose_step / torch.clamp(n, min=1e-12), max=1.0)
    dx_c = torch.where(torch.isfinite(dx_c), dx_c, 0.0)

    corr = torch.einsum("loik,loi->lk", Y, dx_c[prob.obs_cam])
    dx_l = -torch.einsum("lij,lj->li", Winv, b_l + corr)
    nl = torch.linalg.vector_norm(dx_l, dim=1, keepdim=True)
    dx_l = dx_l * torch.clamp(config.max_point_step / torch.clamp(nl, min=1e-12), max=1.0)
    dx_l = torch.where(torch.isfinite(dx_l), dx_l, 0.0) * prob.lm_valid[:, None].to(dt)

    T_new = lie.orthonormalize_transform(lie.exp_se3(dx_c) @ T_wc)
    return T_new, prob.xyz + dx_l


def bundle_adjust(cam: cam_ops.CameraParams, prob: BAProblem,
                  config: BAConfig = BAConfig()):
    """Full single-device Schur BA: config.iterations rounds of
    linearize / solve / back-substitute, with no host read inside.
    Returns (T_wc (P,4,4), xyz (L,3), chi2_history (iterations,))."""
    T_wc, xyz = prob.T_wc, prob.xyz
    chi2s = []
    for _ in range(config.iterations):
        p = prob._replace(xyz=xyz)
        S, b_S, Winv, b_l, Y, chi2 = build_reduced_system(cam, T_wc, p, config)
        T_wc, xyz = solve_reduced_and_backsub(T_wc, p, S, b_S, Winv, b_l, Y, config)
        chi2s.append(chi2)
    return T_wc, xyz, torch.stack(chi2s)


# Eager solves, captures and replays of the BA programs (CUDA only).
EVENTS: Counter = Counter()
# The process's programs, by (P, L, O, config, odometry, device).
_PROGRAMS: dict[tuple, program.StaticProgram] = {}


def ba_program(cam: cam_ops.CameraParams, P: int, L: int, O: int, config: BAConfig,
               odometry: bool = True, device=None) -> program.StaticProgram:
    """The process's bundle_adjust program for problems of P cameras, L
    landmarks and O observation slots (with the odometry factors or
    without) under config.  Its inputs are ((K, baseline_m), BAProblem):
    the camera is an input too (a graph reads its tensors by address);
    its outputs bundle_adjust's (T_wc, xyz, chi2_history)."""
    device = resolve_device(cam.device if device is None else device)
    key = (P, L, O, config, odometry, device)
    if key not in _PROGRAMS:
        f32 = dict(dtype=torch.float32, device=device)
        eye = torch.eye(4, **f32)
        prob = BAProblem(
            T_wc=eye.repeat(P, 1, 1), xyz=torch.zeros((L, 3), **f32),
            obs_cam=torch.zeros((L, O), dtype=torch.int64, device=device),
            obs_uv4=torch.zeros((L, O, 4), **f32), obs_weight=torch.zeros((L, O), **f32),
            obs_mask=torch.zeros((L, O), dtype=torch.bool, device=device),
            lm_valid=torch.zeros(L, dtype=torch.bool, device=device),
            cam_fixed=torch.ones(P, dtype=torch.bool, device=device),
            odo_T=eye.repeat(P, 1, 1) if odometry else None,
            odo_weight=torch.zeros(P, **f32) if odometry else None,
            odo_info=torch.zeros(6, **f32) if odometry else None)
        template = cam._replace(K=torch.eye(3, **f32))

        def solve(bufs):
            (K, baseline), p = bufs
            return bundle_adjust(template._replace(K=K, baseline_m=baseline), p, config)

        bufs = ((torch.eye(3, **f32), torch.zeros((), **f32)), prob)
        _PROGRAMS[key] = program.StaticProgram(solve, bufs, EVENTS)
    return _PROGRAMS[key]


def clear_programs() -> None:
    """Forget every shared BA program."""
    _PROGRAMS.clear()


def bundle_adjust_program(cam: cam_ops.CameraParams, prob: BAProblem,
                          config: BAConfig = BAConfig()):
    """bundle_adjust through the program of prob's sizes on prob's device:
    on the card its first use at a size is eager, its second captures it
    and every later use replays it."""
    P, (L, O) = prob.T_wc.shape[0], prob.obs_cam.shape
    prog = ba_program(cam, P, L, O, config, prob.odo_T is not None, prob.T_wc.device)
    return prog.run(((cam.K, cam.baseline_m), prob))
