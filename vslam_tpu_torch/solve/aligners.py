"""Pose solvers (stereo UV, RGB-D UVD, closure ICP) and the batched
landmark refinements (port of vslam_tpu/solve/aligners.py).

All use closed-form Jacobians.  Each `lax.while_loop` of the JAX solver
becomes a Python loop to the iteration cap whose state is frozen, by a
per-solve `active` flag, once the loop condition fails: the result is the
while-loop's, and the loop needs no host sync to decide when to stop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.ops import lie
from vslam_tpu_torch.solve import gn


class StereoUVData(NamedTuple):
    """Per-measurement data, leading dim N (fixed capacity, masked)."""

    p_prev: torch.Tensor  # (N, 3) points in the previous camera frame
    meas: torch.Tensor  # (N, 4) measured [uL, vL, uR, vR] in the current frame
    weight: torch.Tensor  # (N,) e.g. 1 + log(n_updates) for landmarks


def _stereo_r_J_analytic(cam: cam_ops.CameraParams, p: torch.Tensor,
                         meas: torch.Tensor):
    """Closed-form stereo reprojection residual + Jacobian wrt the
    left-multiplicative se(3) tangent [v, w] (stereouv_aligner.cpp:142-177).

    p: (N, 3) points in the CURRENT camera frame; meas: (N, 4).
    Returns (r (N, 4), J (N, 4, 6), z (N,))."""
    x, y, z = p.unbind(-1)
    zi = 1.0 / torch.clamp(z, min=1e-6)
    fx, fy, b = cam.fx, cam.fy, cam.baseline_m
    u_l = fx * x * zi + cam.cx
    v_l = fy * y * zi + cam.cy
    u_r = fx * (x - b) * zi + cam.cx
    r = torch.stack([u_l, v_l, u_r, v_l], dim=-1) - meas
    fxzi = fx * zi
    fyzi = fy * zi
    zero = torch.zeros_like(x)
    Jp = torch.stack([
        torch.stack([fxzi, zero, -fxzi * x * zi], dim=-1),
        torch.stack([zero, fyzi, -fyzi * y * zi], dim=-1),
        torch.stack([fxzi, zero, -fxzi * (x - b) * zi], dim=-1),
        torch.stack([zero, fyzi, -fyzi * y * zi], dim=-1),
    ], dim=-2)  # (N, 4, 3)
    # d r / d w = -Jp @ skew(p): row-wise a @ skew(p) = cross(a, p).
    Jw = -torch.linalg.cross(Jp, p[..., None, :].expand_as(Jp), dim=-1)
    return r, torch.cat([Jp, Jw], dim=-1), z


def _keep_going(prev_chi2, chi2, step, it, first_rounds, config):
    rel = torch.abs(prev_chi2 - chi2) / torch.clamp(chi2, min=1e-12)
    return (it < first_rounds) | (rel > config.tolerance) | (
        step > config.step_tolerance
    )


def stereo_uv_align_fast(
    cam: cam_ops.CameraParams,
    data: StereoUVData,
    mask: torch.Tensor,
    T0: torch.Tensor,
    config: gn.GNConfig = gn.GNConfig(),
) -> gn.GNResult:
    """Two-phase robust stereo pose solve (robust GN to convergence, then
    inlier-only refinement with collapse rejection), analytic Jacobian."""
    p_prev, meas, weight = data
    kernel = config.kernel_max_error
    dev = T0.device

    def linearize(T, extra_mask):
        p = lie.transform_points(T, p_prev)
        r, J, z = _stereo_r_J_analytic(cam, p, meas)
        omega = weight * torch.clamp(10.0 / torch.clamp(z, min=0.1), 0.2, 2.0)
        vis = mask & extra_mask & (z > 0.01)
        chi2 = omega * torch.sum(r * r, dim=-1)
        w = torch.where(chi2 > kernel, kernel / torch.clamp(chi2, min=1e-12), 1.0)
        ow = torch.where(vis, omega * w, 0.0)
        H = torch.einsum("nri,nrj->ij", J * ow[:, None, None], J)
        b = torch.einsum("nri,nr->i", J, ow[:, None] * r)
        inliers = (chi2 <= kernel) & vis
        total = torch.sum(torch.where(vis, chi2 * w, 0.0))
        return H, b, total, inliers

    def one_round(T, extra_mask):
        H, b, total, inliers = linearize(T, extra_mask)
        dx = gn.solve_normal_equations(H, b, config.damping)
        norm = torch.linalg.vector_norm(dx)
        dx = dx * torch.clamp(config.max_step_norm / torch.clamp(norm, min=1e-12),
                              max=1.0)
        ok = torch.all(torch.isfinite(dx))
        T_new = torch.where(ok, gn.se3_retract(T, dx), T)
        return T_new, total, inliers, torch.where(ok, norm, 0.0)

    inf = torch.tensor(float("inf"), device=dev)
    all_true = torch.ones_like(mask)

    # Phase 1: robust GN over all measurements.
    T, prev, chi2 = T0, inf, torch.tensor(1e30, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    inl, step = mask, inf
    for _ in range(config.max_iterations):
        active = _keep_going(prev, chi2, step, it, 2, config)
        T2, new_chi2, inl2, step2 = one_round(T, all_true)
        T = torch.where(active, T2, T)
        prev = torch.where(active, chi2, prev)
        chi2 = torch.where(active, new_chi2, chi2)
        inl = torch.where(active, inl2, inl)
        step = torch.where(active, step2, step)
        it = it + active.to(torch.int32)
    iters = it

    # Phase 2: inlier-only refinement; a round that collapses the inlier
    # set below min_num_inliers is rejected.
    prev, step = inf, inf
    it = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(config.refine_iterations):
        active = _keep_going(prev, chi2, step, it, 1, config)
        T2, new_chi2, inl2, step2 = one_round(T, inl)
        keep = torch.sum(inl2) >= config.min_num_inliers
        upd = active & keep
        T = torch.where(upd, T2, T)
        prev = torch.where(active, chi2, prev)
        chi2 = torch.where(upd, new_chi2, chi2)
        inl = torch.where(upd, inl2, inl)
        step = torch.where(active, torch.where(keep, step2, 0.0), step)
        it = it + active.to(torch.int32)

    _, _, final_chi2, final_inl = linearize(T, inl)
    num_inliers = torch.sum(final_inl).to(torch.int32)
    return gn.GNResult(
        x=T,
        chi2=final_chi2 / torch.clamp(num_inliers.to(torch.float32), min=1.0),
        num_inliers=num_inliers,
        num_iterations=iters,
        inlier_mask=final_inl,
        converged=num_inliers >= config.min_num_inliers,
    )


def _two_phase_batched(linearize, T0: torch.Tensor, mask: torch.Tensor,
                       config: gn.GNConfig) -> gn.GNResult:
    """The JAX package's generic robust two-phase gauss_newton over B
    problems at once: robust GN to convergence, then inlier-only rounds
    that reject a collapse of the inlier set.  linearize(T, extra_mask)
    gives (H (B,6,6), b (B,6), total chi2 (B,), inliers (B,N)) with
    extra_mask ANDed into mask.  num_inliers counts the inlier set carried
    out of the refinement phase."""
    B, dev = T0.shape[0], T0.device

    def one_round(T, extra_mask):
        H, b, total, inliers = linearize(T, extra_mask)
        dx = gn.solve_normal_equations(H, b, config.damping)
        norm = torch.linalg.vector_norm(dx, dim=-1)
        dx = dx * torch.clamp(config.max_step_norm / torch.clamp(norm, min=1e-12),
                              max=1.0)[:, None]
        ok = torch.all(torch.isfinite(dx), dim=-1)
        T_new = torch.where(ok[:, None, None], gn.se3_retract(T, dx), T)
        return T_new, total, inliers, torch.where(ok, norm, 0.0)

    inf = torch.full((B,), float("inf"), device=dev)
    all_true = torch.ones_like(mask)

    # Phase 1: robust GN over all measurements.
    T, prev, chi2 = T0, inf, torch.full((B,), 1e30, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    inl, step = mask, inf
    for _ in range(config.max_iterations):
        active = _keep_going(prev, chi2, step, it, 2, config)
        T2, new_chi2, inl2, step2 = one_round(T, all_true)
        T = torch.where(active[:, None, None], T2, T)
        prev = torch.where(active, chi2, prev)
        chi2 = torch.where(active, new_chi2, chi2)
        inl = torch.where(active[:, None], inl2, inl)
        step = torch.where(active, step2, step)
        it = it + active.to(torch.int32)
    iters = it

    # Phase 2: inlier-only refinement with collapse rejection.
    prev, step = inf, inf
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(config.refine_iterations):
        active = _keep_going(prev, chi2, step, it, 1, config)
        T2, new_chi2, inl2, step2 = one_round(T, inl)
        keep = torch.sum(inl2, dim=-1) >= config.min_num_inliers
        upd = active & keep
        T = torch.where(upd[:, None, None], T2, T)
        prev = torch.where(active, chi2, prev)
        chi2 = torch.where(upd, new_chi2, chi2)
        inl = torch.where(upd[:, None], inl2, inl)
        step = torch.where(active, torch.where(keep, step2, 0.0), step)
        it = it + active.to(torch.int32)

    num_inliers = torch.sum(inl, dim=-1).to(torch.int32)
    _, _, final_chi2, _ = linearize(T, inl)
    return gn.GNResult(
        x=T,
        chi2=final_chi2 / torch.clamp(num_inliers.to(torch.float32), min=1.0),
        num_inliers=num_inliers,
        num_iterations=iters,
        inlier_mask=inl,
        converged=num_inliers >= config.min_num_inliers,
    )


class ICPData(NamedTuple):
    """Point-to-point closure verification data, leading dims (B, N)."""

    p_moving: torch.Tensor  # (B, N, 3) points in the query keyframe frame
    p_fixed: torch.Tensor  # (B, N, 3) corresponding reference-frame points
    weight: torch.Tensor  # (B, N) per-correspondence information


def icp_align(data: ICPData, mask: torch.Tensor, T0: torch.Tensor,
              config: gn.GNConfig = gn.GNConfig()) -> gn.GNResult:
    """Estimate T_ref_query aligning moving onto fixed points, for B
    candidates at once: the JAX package's icp_align (the generic robust
    two-phase gauss_newton) with the analytic Jacobian of R p + t - q wrt
    the left tangent, [I, -hat(R p + t)].

    mask: (B, N) valid correspondences; T0: (B, 4, 4).  Every field of
    the result has the leading dim B."""
    p_mov, p_fix, weight = data
    kernel = config.kernel_max_error
    eye3 = torch.eye(3, dtype=T0.dtype, device=T0.device)

    def linearize(T, extra_mask):
        p = lie.transform_points(T[:, None], p_mov)  # (B, N, 3)
        r = p - p_fix
        J = torch.cat([eye3.expand(p.shape + (3,)), -lie.hat(p)], dim=-1)  # (B,N,3,6)
        chi2 = weight * torch.sum(r * r, dim=-1)
        w = torch.where(chi2 > kernel, kernel / torch.clamp(chi2, min=1e-12), 1.0)
        w_eff = w * (mask & extra_mask).to(T.dtype)
        ow = weight * w_eff
        H = torch.einsum("bnri,bn,bnrj->bij", J, ow, J)
        b = torch.einsum("bnri,bnr->bi", J, ow[..., None] * r)
        inliers = (chi2 <= kernel) & mask & extra_mask
        return H, b, torch.sum(chi2 * w_eff, dim=-1), inliers

    return _two_phase_batched(linearize, T0, mask, config)


class UVDData(NamedTuple):
    """RGB-D pose-solve data, leading dim N (fixed capacity, masked)."""

    p_prev: torch.Tensor  # (N, 3) points in the previous camera frame
    meas: torch.Tensor  # (N, 3) measured [u, v, depth_m]
    weight: torch.Tensor  # (N,)
    depth_reliable: torch.Tensor  # (N,) bool; unreliable -> uv only


def uvd_align(cam: cam_ops.CameraParams, data: UVDData, mask: torch.Tensor,
              T0: torch.Tensor, config: gn.GNConfig = gn.GNConfig()) -> gn.GNResult:
    """RGB-D pose solve on [u, v, z] residuals (reference UVDAligner):
    the JAX package's uvd_align, the generic two-phase gauss_newton with
    the diagonal information [w, w, w * 10 * reliable] and the closed-form
    Jacobian [Jproj; e_z] @ [I, -hat(p)] of the left tangent."""
    p_prev, meas, weight, reliable = data
    kernel = config.kernel_max_error
    eps = 1e-6
    mask = mask & (lie.transform_points(T0, p_prev)[:, 2] > 0.01)
    dw = torch.where(reliable, 10.0, 0.0)  # the depth channel's information
    omega = torch.stack([weight, weight, weight * dw], dim=-1)  # (N, 3)
    eye3 = torch.eye(3, dtype=T0.dtype, device=T0.device)

    def linearize(T, extra_mask):
        p = lie.transform_points(T[0], p_prev)  # (N, 3)
        uv, z = cam_ops.project(cam, p, eps)
        r = torch.cat([uv, z[:, None]], dim=-1) - meas
        zs = torch.clamp(z, min=eps)
        zi2 = (z > eps).to(p.dtype) / (zs * zs)
        zero = torch.zeros_like(z)
        Jp = torch.stack([
            torch.stack([cam.fx / zs, zero, -cam.fx * p[:, 0] * zi2], dim=-1),
            torch.stack([zero, cam.fy / zs, -cam.fy * p[:, 1] * zi2], dim=-1),
            torch.stack([zero, zero, torch.ones_like(z)], dim=-1),
        ], dim=-2)  # (N, 3, 3)
        J = Jp @ torch.cat([eye3.expand(p.shape + (3,)), -lie.hat(p)], dim=-1)
        chi2 = torch.sum(r * omega * r, dim=-1)
        w = torch.where(chi2 > kernel, kernel / torch.clamp(chi2, min=1e-12), 1.0)
        w_eff = w * (mask & extra_mask[0]).to(T.dtype)
        ow = omega * w_eff[:, None]
        H = torch.einsum("nri,nr,nrj->ij", J, ow, J)
        b = torch.einsum("nri,nr->i", J, ow * r)
        inliers = (chi2 <= kernel) & mask & extra_mask[0]
        return H[None], b[None], torch.sum(chi2 * w_eff)[None], inliers[None]

    res = _two_phase_batched(linearize, T0[None], mask[None], config)
    return gn.GNResult(*(f[0] for f in res))


def update_landmarks(
    cam: cam_ops.CameraParams,
    xyz_world: torch.Tensor,  # (M, 3)
    H_acc: torch.Tensor,  # (M, 3, 3)
    T_world_cam: torch.Tensor,  # (4, 4)
    meas_uv4: torch.Tensor,  # (M, 4)
    obs_mask: torch.Tensor,  # (M,)
    kernel_max_error_px2: float = 9.0 * 4,
    prior_damping: float = 1.0,
    n_updates: torch.Tensor | None = None,
    min_forced_updates: int = 0,
    min_meas_for_opt: int = 0,
    max_t_err_depth_ratio: float = 0.0,
):
    """One information-form GN step per observed landmark, batched over M
    (redesign of Landmark::update, landmark.cpp:66-167).  The Jacobian of
    the stereo projection wrt the world position is closed-form (the JAX
    package takes it by jacfwd).

    Returns (xyz_new (M, 3), H_new (M, 3, 3), chi2 (M,), inlier (M,))."""
    eps = 1e-6
    T_cw = lie.inverse(T_world_cam)
    R_cw = T_cw[:3, :3]
    if n_updates is None:
        n_updates = torch.full(xyz_world.shape[:1], 1 << 20, dtype=torch.int32,
                               device=xyz_world.device)
    p = lie.transform_points(T_cw, xyz_world)
    uv_l, uv_r, z = cam_ops.project_stereo(cam, p, eps)
    r = torch.cat([uv_l, uv_r], dim=-1) - meas_uv4  # (M, 4)

    zs = torch.clamp(z, min=eps)
    g = (z > eps).to(p.dtype)  # d max(z, eps) / dz
    zi2 = g / (zs * zs)
    zero = torch.zeros_like(z)
    du_l = torch.stack([cam.fx / zs, zero, -cam.fx * p[:, 0] * zi2], dim=-1)
    dv = torch.stack([zero, cam.fy / zs, -cam.fy * p[:, 1] * zi2], dim=-1)
    du_r = du_l + torch.stack(
        [zero, zero, cam.fx * cam.baseline_m * zi2], dim=-1
    )
    J = torch.stack([du_l, dv, du_r, dv], dim=-2) @ R_cw  # (M, 4, 3)

    chi2 = torch.sum(r * r, dim=-1)
    w = torch.where(chi2 > kernel_max_error_px2,
                    kernel_max_error_px2 / torch.clamp(chi2, min=1e-9), 1.0)
    w = torch.where(n_updates < min_forced_updates, 1.0, w)
    Jt = J.transpose(-1, -2)
    H_new = H_acc + w[:, None, None] * (Jt @ J)
    bm = w[:, None] * (Jt @ r[..., None])[..., 0]
    dx = gn.solve_normal_equations(H_new, bm, prior_damping)
    step_ok = torch.ones_like(obs_mask)
    if max_t_err_depth_ratio > 0.0:
        step_ok = step_ok & (
            torch.linalg.vector_norm(dx, dim=-1)
            <= max_t_err_depth_ratio * torch.clamp(z, min=0.1)
        )
    if min_meas_for_opt > 0:
        step_ok = step_ok & (n_updates + 1 >= min_meas_for_opt)
    xyz_new = torch.where(step_ok[:, None], xyz_world + dx, xyz_world)
    xyz_out = torch.where(obs_mask[:, None], xyz_new, xyz_world)
    H_out = torch.where(obs_mask[:, None, None], H_new, H_acc)
    return xyz_out, H_out, chi2, (chi2 <= kernel_max_error_px2) & obs_mask


def update_landmarks_uvd(
    cam: cam_ops.CameraParams,
    xyz_world: torch.Tensor,  # (M, 3)
    H_acc: torch.Tensor,  # (M, 3, 3)
    T_world_cam: torch.Tensor,  # (4, 4)
    meas_uvd: torch.Tensor,  # (M, 3) measured [u, v, depth_m]
    obs_mask: torch.Tensor,  # (M,)
    kernel_max_error: float = 9.0 * 3,
    prior_damping: float = 1.0,
    depth_weight: float = 100.0,
):
    """RGB-D variant of update_landmarks: residual [u - u_m, v - v_m,
    (z - z_m) sqrt(depth_weight)], closed-form Jacobian wrt the world
    position.  Returns (xyz_new, H_new, chi2, inlier) as update_landmarks."""
    eps = 1e-6
    sqrt_dw = float(depth_weight) ** 0.5
    T_cw = lie.inverse(T_world_cam)
    R_cw = T_cw[:3, :3]
    p = lie.transform_points(T_cw, xyz_world)
    uv, z = cam_ops.project(cam, p, eps)
    r = torch.cat([uv - meas_uvd[:, :2], ((z - meas_uvd[:, 2]) * sqrt_dw)[:, None]], dim=-1)

    zs = torch.clamp(z, min=eps)
    zi2 = (z > eps).to(p.dtype) / (zs * zs)
    zero = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([cam.fx / zs, zero, -cam.fx * p[:, 0] * zi2], dim=-1),
        torch.stack([zero, cam.fy / zs, -cam.fy * p[:, 1] * zi2], dim=-1),
        torch.stack([zero, zero, torch.full_like(z, sqrt_dw)], dim=-1),
    ], dim=-2) @ R_cw  # (M, 3, 3)

    chi2 = torch.sum(r * r, dim=-1)
    w = torch.where(chi2 > kernel_max_error,
                    kernel_max_error / torch.clamp(chi2, min=1e-9), 1.0)
    Jt = J.transpose(-1, -2)
    H_new = H_acc + w[:, None, None] * (Jt @ J)
    dx = gn.solve_normal_equations(H_new, w[:, None] * (Jt @ r[..., None])[..., 0],
                                   prior_damping)
    xyz_out = torch.where(obs_mask[:, None], xyz_world + dx, xyz_world)
    H_out = torch.where(obs_mask[:, None, None], H_new, H_acc)
    return xyz_out, H_out, chi2, (chi2 <= kernel_max_error) & obs_mask
