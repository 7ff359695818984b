"""Pose solvers (stereo UV, RGB-D UVD, closure ICP) and the batched
landmark refinements (port of vslam_tpu/solve/aligners.py).

The production solvers (stereo_uv_align_fast, uvd_align, icp_align and
the landmark refinements) use closed-form Jacobians.  The residual
factories (make_stereo_uv_residual, make_uvd_residual, make_icp_residual)
and stereo_uv_align instantiate the generic engine gn.gauss_newton with
Jacobians by forward-mode autodiff through the left SE(3) tangent, as the
JAX package does everywhere: the reference the closed forms are held to.
Each `lax.while_loop` of the JAX solver is gn.two_phase's
ops/control.py while_loop: a WHILE node under a capture, no host sync
to decide when to stop.
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
    meas: torch.Tensor  # (N, 4) measured [uL, vL, uR, vR], (B, N, 4) batched
    weight: torch.Tensor  # (N,) e.g. 1 + log(n_updates) for landmarks


def _local_residual(r_of_T, T: torch.Tensor):
    """A residual and its Jacobian wrt the left-multiplicative se(3)
    tangent at T: r(exp(dx) T) and its forward-mode derivative at dx = 0."""
    zero = torch.zeros(6, dtype=T.dtype, device=T.device)

    def r_of_dx(dx):
        # The twist rides a batch of one: forward-mode through a 0-d
        # tensor times a Python float gives an f64 tangent (torch.func).
        return r_of_T(lie.exp_se3(dx[None])[0] @ T)

    return r_of_dx(zero), torch.func.jacfwd(r_of_dx)(zero)


def make_stereo_uv_residual(cam: cam_ops.CameraParams):
    """(residual_fn, diag_fn) of the stereo reprojection for
    gn.gauss_newton: r = [uL, vL, uR, vR](T p_prev) - meas, information
    weight x the inverse-depth emphasis of near points
    (stereouv_aligner.cpp:57-61) on the diagonal."""

    def residual_fn(T, datum):
        def r_of_T(Tx):
            uv_l, uv_r, _ = cam_ops.project_stereo(cam, lie.transform_points(Tx, datum.p_prev))
            return torch.cat([uv_l, uv_r], dim=-1) - datum.meas

        return _local_residual(r_of_T, T)

    def diag_fn(T, datum, r):
        z = lie.transform_points(T, datum.p_prev)[2]
        depth_w = torch.clamp(10.0 / torch.clamp(z, min=0.1), 0.2, 2.0)
        return datum.weight * depth_w * torch.ones_like(r)

    return residual_fn, diag_fn


def stereo_uv_align(cam: cam_ops.CameraParams, data: StereoUVData, mask: torch.Tensor,
                    T0: torch.Tensor, config: gn.GNConfig = gn.GNConfig()) -> gn.GNResult:
    """T_cur_prev from stereo reprojections by the generic engine (the
    reference stereo_uv_align_fast is checked against).  Points behind the
    camera under the initial guess are left out, as the reference skips
    them in linearize."""
    residual_fn, diag_fn = make_stereo_uv_residual(cam)
    mask = mask & (lie.transform_points(T0, data.p_prev)[:, 2] > 0.01)
    return gn.gauss_newton(residual_fn, T0, data, mask, config,
                           retract=gn.se3_retract, diag_fn=diag_fn)


def _stereo_r_J_analytic(cam: cam_ops.CameraParams, p: torch.Tensor,
                         meas: torch.Tensor):
    """Closed-form stereo reprojection residual + Jacobian wrt the
    left-multiplicative se(3) tangent [v, w] (stereouv_aligner.cpp:142-177).

    p: (..., N, 3) points in the CURRENT camera frame; meas: (..., N, 4).
    Returns (r (..., N, 4), J (..., N, 4, 6), z (..., N))."""
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


def _normal_equations(J: torch.Tensor, ow: torch.Tensor, r: torch.Tensor):
    """H = J^T diag(ow) J and b = J^T diag(ow) r summed over each problem's
    measurements, J (B, N, R, D), ow and r (B, N, R): one elementwise
    product summed over dims 1 and 2.  Unlike a matrix product's, its
    bits do not depend on B, so a problem solved in a batch is solved as
    alone."""
    D = J.shape[-1]
    Jr = torch.cat([J, r[..., None]], dim=-1) * ow[..., None]
    A = (Jr[..., :, None] * J[..., None, :]).sum(dim=(1, 2))  # (B, D + 1, D)
    return A[:, :D], A[:, D]


def stereo_uv_align_fast(
    cam: cam_ops.CameraParams,
    data: StereoUVData,
    mask: torch.Tensor,
    T0: torch.Tensor,
    config: gn.GNConfig = gn.GNConfig(),
) -> gn.GNResult:
    """Two-phase robust stereo pose solve (robust GN to convergence, then
    inlier-only refinement with collapse rejection), analytic Jacobian.

    B problems over one point set at once: T0 (B, 4, 4), mask (B, N) and
    data.meas (B, N, 4), every field of the result with the leading dim
    B; T0 (4, 4) is one problem, with no batch dim anywhere."""
    if T0.dim() == 2:
        res = stereo_uv_align_fast(cam, data._replace(meas=data.meas[None]), mask[None],
                                   T0[None], config)
        return gn.GNResult(*(f[0] for f in res))
    p_prev, meas, weight = data
    kernel = config.kernel_max_error

    def linearize(T, extra_mask):
        p = lie.transform_points(T[:, None], p_prev)  # (B, N, 3)
        r, J, z = _stereo_r_J_analytic(cam, p, meas)
        omega = weight * torch.clamp(10.0 / torch.clamp(z, min=0.1), 0.2, 2.0)
        vis = mask & extra_mask & (z > 0.01)
        chi2 = omega * torch.sum(r * r, dim=-1)
        w = torch.where(chi2 > kernel, kernel / torch.clamp(chi2, min=1e-12), 1.0)
        ow = torch.where(vis, omega * w, 0.0)
        H, b = _normal_equations(J, ow[..., None].expand_as(r), r)
        inliers = (chi2 <= kernel) & vis
        total = torch.sum(torch.where(vis, chi2 * w, 0.0), dim=-1)
        return H, b, total, inliers

    return gn.two_phase(linearize, T0, mask, config, recount=True)


class ICPData(NamedTuple):
    """Point-to-point closure verification data, leading dims (B, N)."""

    p_moving: torch.Tensor  # (B, N, 3) points in the query keyframe frame
    p_fixed: torch.Tensor  # (B, N, 3) corresponding reference-frame points
    weight: torch.Tensor  # (B, N) per-correspondence information


def make_icp_residual():
    """(residual_fn, diag_fn) of point-to-point ICP for gn.gauss_newton:
    r = T p_moving - p_fixed, the correspondence weight on the diagonal
    (xyz_aligner.cpp:13-40).  Takes one problem's (N, ...) data."""

    def residual_fn(T, datum):
        def r_of_T(Tx):
            return lie.transform_points(Tx, datum.p_moving) - datum.p_fixed

        return _local_residual(r_of_T, T)

    def diag_fn(T, datum, r):
        return datum.weight * torch.ones_like(r)

    return residual_fn, diag_fn


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

    return gn.two_phase(linearize, T0, mask, config)


class UVDData(NamedTuple):
    """RGB-D pose-solve data, leading dim N (fixed capacity, masked)."""

    p_prev: torch.Tensor  # (N, 3) points in the previous camera frame
    meas: torch.Tensor  # (N, 3) measured [u, v, depth_m] ((B, N, 3) batched)
    weight: torch.Tensor  # (N,)
    depth_reliable: torch.Tensor  # (N,) bool, (B, N) batched; unreliable -> uv only


def make_uvd_residual(cam: cam_ops.CameraParams, depth_info_weight: float = 10.0):
    """(residual_fn, diag_fn) of the RGB-D [u, v, depth] residual for
    gn.gauss_newton; the depth channel carries depth_info_weight where the
    depth is reliable and nothing where it is not (uvd_aligner.cpp:55-61)."""

    def residual_fn(T, datum):
        def r_of_T(Tx):
            uv, z = cam_ops.project(cam, lie.transform_points(Tx, datum.p_prev))
            return torch.cat([uv, z[None]], dim=-1) - datum.meas

        return _local_residual(r_of_T, T)

    def diag_fn(T, datum, r):
        dw = torch.where(datum.depth_reliable, depth_info_weight, 0.0)
        return torch.stack([datum.weight, datum.weight, datum.weight * dw]).to(r.dtype)

    return residual_fn, diag_fn


def uvd_align(cam: cam_ops.CameraParams, data: UVDData, mask: torch.Tensor,
              T0: torch.Tensor, config: gn.GNConfig = gn.GNConfig()) -> gn.GNResult:
    """RGB-D pose solve on [u, v, z] residuals (reference UVDAligner):
    the JAX package's uvd_align, the generic two-phase gauss_newton with
    the diagonal information [w, w, w * 10 * reliable] and the closed-form
    Jacobian [Jproj; e_z] @ [I, -hat(p)] of the left tangent.

    B problems over one point set at once as stereo_uv_align_fast's:
    T0 (B, 4, 4), mask, data.meas and data.depth_reliable with the
    leading dim B; T0 (4, 4) is one problem."""
    if T0.dim() == 2:
        res = uvd_align(cam, data._replace(meas=data.meas[None],
                                           depth_reliable=data.depth_reliable[None]),
                        mask[None], T0[None], config)
        return gn.GNResult(*(f[0] for f in res))
    p_prev, meas, weight, reliable = data
    kernel = config.kernel_max_error
    eps = 1e-6
    mask = mask & (lie.transform_points(T0[:, None], p_prev)[..., 2] > 0.01)
    dw = torch.where(reliable, 10.0, 0.0)  # the depth channel's information
    omega = torch.stack([weight.expand_as(dw), weight.expand_as(dw), weight * dw],
                        dim=-1)  # (B, N, 3)
    eye3 = torch.eye(3, dtype=T0.dtype, device=T0.device)

    def linearize(T, extra_mask):
        p = lie.transform_points(T[:, None], p_prev)  # (B, N, 3)
        uv, z = cam_ops.project(cam, p, eps)
        r = torch.cat([uv, z[..., None]], dim=-1) - meas
        zs = torch.clamp(z, min=eps)
        zi2 = (z > eps).to(p.dtype) / (zs * zs)
        zero = torch.zeros_like(z)
        Jp = torch.stack([
            torch.stack([cam.fx / zs, zero, -cam.fx * p[..., 0] * zi2], dim=-1),
            torch.stack([zero, cam.fy / zs, -cam.fy * p[..., 1] * zi2], dim=-1),
            torch.stack([zero, zero, torch.ones_like(z)], dim=-1),
        ], dim=-2)  # (B, N, 3, 3)
        J = Jp @ torch.cat([eye3.expand(p.shape + (3,)), -lie.hat(p)], dim=-1)
        chi2 = torch.sum(r * omega * r, dim=-1)
        w = torch.where(chi2 > kernel, kernel / torch.clamp(chi2, min=1e-12), 1.0)
        w_eff = w * (mask & extra_mask).to(T.dtype)
        H, b = _normal_equations(J, omega * w_eff[..., None], r)
        inliers = (chi2 <= kernel) & mask & extra_mask
        return H, b, torch.sum(chi2 * w_eff, dim=-1), inliers

    return gn.two_phase(linearize, T0, mask, config)


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
