"""FAST-ICP: Anderson-accelerated point-to-point ICP on SE(3) (port of
vslam_tpu/solve/anderson.py), batched over a leading B like
aligners.icp_align.

Each round is one IRLS-weighted Procrustes solve (the reference's
point_to_point, fast_aligner.cpp:282-315); type-II Anderson mixing runs
in se(3) log coordinates with a (6, m) history, and the mixing weights
come from an m x m solve with a 1e-10 ridge.  A round whose accelerated
iterate raises the robust energy keeps the plain Procrustes iterate and
restarts the history (the reference's energy check,
fast_aligner.cpp:150-176).  The rounds are a Python loop to max_rounds
with no host read: every decision is a torch.where.  The Procrustes
rotation comes from rotation_fit (Horn's quaternion, a fixed count of
f64 squarings) and the mixing solve from solve_ex: neither reads the
card, so relocalizer.ICPProgram captures the whole solve
(torch.linalg.svd, which the JAX package calls, synchronizes with the
host once a call).
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops import lie
from vslam_tpu_torch.solve import gn
from vslam_tpu_torch.solve.aligners import ICPData


# Squarings of Horn's shifted 4x4 matrix: the top eigenvector's share
# grows as ((l2 + s) / (l1 + s)) ** (2 ** SQUARINGS), which is below
# f64's resolution for an eigenvalue gap of 1e-7 of the spectrum's scale
# (a rotation that well-posed is unique; below it SVD's is arbitrary too).
SQUARINGS = 32


def rotation_fit(S: torch.Tensor) -> torch.Tensor:
    """The rotation R maximizing tr(R^T S) for a batch of 3x3 S (B, 3, 3),
    i.e. U diag(1, 1, det(U Vh)) Vh of S = U diag(s) Vh (Kabsch with the
    reflection fix): Horn's unit quaternion, the eigenvector of the
    largest eigenvalue of the symmetric 4x4 N(S^T).  It is found with no
    host read by repeated squaring of N + |N|_F I (all eigenvalues >= 0,
    the largest kept on top), normalized each time, in f64; the column of
    largest norm is the quaternion.  S = 0 gives the identity."""
    M = S.transpose(-1, -2).to(torch.float64)  # M[a, b] = sum m_a f_b
    xx, xy, xz = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    yx, yy, yz = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    zx, zy, zz = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    N = torch.stack([
        xx + yy + zz, yz - zy, zx - xz, xy - yx,
        yz - zy, xx - yy - zz, xy + yx, zx + xz,
        zx - xz, xy + yx, -xx + yy - zz, yz + zy,
        xy - yx, zx + xz, yz + zy, -xx - yy + zz,
    ], dim=-1).reshape(-1, 4, 4)
    eye = torch.eye(4, dtype=N.dtype, device=N.device)
    shift = torch.linalg.matrix_norm(N) + 1e-300
    A = N + shift[:, None, None] * eye
    for _ in range(SQUARINGS):
        A = A / A.abs().amax(dim=(1, 2), keepdim=True)
        A = A @ A
    col = torch.linalg.vector_norm(A, dim=1).argmax(dim=1)
    q = torch.gather(A, 2, col[:, None, None].expand(-1, 4, 1))[..., 0]
    w, x, y, z = (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)).unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)
    return R.to(S.dtype)


def _weighted_procrustes(p_mov: torch.Tensor, p_fix: torch.Tensor, w: torch.Tensor):
    """Closed-form weighted point-to-point alignment (Kabsch / Umeyama):
    (B, N, 3), (B, N, 3), (B, N) -> (B, 4, 4)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[:, None]
    mu_m = torch.einsum("bn,bni->bi", w, p_mov) / wsum
    mu_f = torch.einsum("bn,bni->bi", w, p_fix) / wsum
    S = torch.einsum("bn,bni,bnj->bij", w, p_fix - mu_f[:, None], p_mov - mu_m[:, None])
    R = rotation_fit(S)
    t = mu_f - torch.einsum("bij,bj->bi", R, mu_m)
    return lie.make_transform(R, t)


def _robust_weights(data: ICPData, mask: torch.Tensor, T: torch.Tensor, kernel: float):
    """IRLS weights, robust energy, inlier mask and chi2 at T (B, 4, 4);
    mask (B, N) f32."""
    p = lie.transform_points(T[:, None], data.p_moving)
    chi2 = torch.sum((p - data.p_fixed) ** 2, dim=-1)
    w = torch.where(chi2 > kernel, kernel / torch.clamp(chi2, min=1e-12), 1.0)
    w = w * data.weight * mask
    energy = torch.sum(torch.clamp(chi2, max=kernel) * data.weight * mask, dim=-1)
    inliers = (chi2 <= kernel) & (mask > 0)
    return w, energy, inliers, chi2


def fast_icp_align(data: ICPData, mask: torch.Tensor, T0: torch.Tensor,
                   config: gn.GNConfig = gn.GNConfig(), window: int = 5,
                   max_rounds: int = 30) -> gn.GNResult:
    """Anderson-accelerated ICP for B problems at once; the same result
    contract as aligners.icp_align.  data: (B, N, 3) point sets and (B, N)
    weights; mask: (B, N) valid correspondences; T0: (B, 4, 4)."""
    m = window
    kernel = config.kernel_max_error
    mask_f = mask.to(torch.float32)
    dev, dt = T0.device, T0.dtype
    B = T0.shape[0]

    def energy_of(T):
        return _robust_weights(data, mask_f, T, kernel)[1]

    cols = torch.arange(m, device=dev)
    ridge = 1e-10 * torch.eye(m, dtype=dt, device=dev)
    u = lie.log_se3(T0)  # the iterate in se(3) log coordinates
    Fh = torch.zeros((B, 6, m), dtype=dt, device=dev)  # residual history
    Gh = torch.zeros((B, 6, m), dtype=dt, device=dev)  # value history
    k = torch.zeros(B, dtype=torch.int64, device=dev)  # valid history length
    for _ in range(max_rounds):
        # One IRLS + Procrustes fixed-point step.
        w = _robust_weights(data, mask_f, lie.exp_se3(u), kernel)[0]
        g = lie.log_se3(_weighted_procrustes(data.p_moving, data.p_fixed, w))
        f = g - u
        # Shift the histories; the newest column goes to slot 0.
        Fh = torch.cat([f[..., None], Fh[..., :m - 1]], dim=-1)
        Gh = torch.cat([g[..., None], Gh[..., :m - 1]], dim=-1)
        k = torch.clamp(k + 1, max=m)
        # Type-II mixing: minimize ||F gamma|| with sum(gamma) = 1 over the
        # valid history, via differences against the newest column
        # (AndersonAcceleration.h:60-115's normal equations).
        valid = (cols[None, :] < k[:, None]).to(dt)  # (B, m)
        dF = (Fh - f[..., None]) * valid[:, None, :]  # column 0 becomes zero
        A = dF.transpose(1, 2) @ dF + ridge
        b = torch.einsum("bim,bi->bm", dF, f)
        theta = torch.linalg.solve_ex(A, b)[0]
        u_acc = g - torch.einsum("bim,bm->bi", Gh - g[..., None], theta * valid)
        # Safeguard: accept the acceleration only if it lowers the energy;
        # on rejection restart the history.
        e_plain = energy_of(lie.exp_se3(g))
        e_acc = energy_of(lie.exp_se3(u_acc))
        ok_acc = torch.isfinite(e_acc) & (e_acc <= e_plain)
        u = torch.where(ok_acc[:, None], u_acc, g)
        k = torch.where(ok_acc, k, 1)
    T = lie.orthonormalize_transform(lie.exp_se3(u))

    _, _, inliers, chi2 = _robust_weights(data, mask_f, T, kernel)
    num_inliers = inliers.sum(-1, dtype=torch.int32)
    mean_chi2 = torch.sum(torch.where(inliers, chi2, 0.0), dim=-1) / torch.clamp(
        num_inliers.to(torch.float32), min=1.0)
    return gn.GNResult(
        x=T,
        chi2=mean_chi2,
        num_inliers=num_inliers,
        num_iterations=torch.full((B,), max_rounds, dtype=torch.int32, device=dev),
        inlier_mask=inliers,
        converged=num_inliers >= config.min_num_inliers,
    )
