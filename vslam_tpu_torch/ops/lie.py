"""SE(3) / SO(3) operations on torch tensors (port of vslam_tpu/ops/lie.py).

Convention as in the JAX package: a pose T is a (4, 4) homogeneous matrix
mapping points from the local frame to the parent frame; twists are (6,)
= [v, w] (translation first).  All functions are f32 and batched over
leading dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """A = sin(t)/t, B = (1-cos(t))/t^2, C = (t-sin(t))/t^3 with the same
    f32 Taylor switch as the JAX package (t^2 < 1e-4)."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < 1e-4
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / ts)
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (ts * theta),
    )
    return a, b, c


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def exact_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA's: through f64 (exact
    after the second rounding).  torch's own f32 sqrt on the CPU is not
    correctly rounded (its AVX-512 path)."""
    return torch.sqrt(x.double()).to(x.dtype)


def rot_to_quat(R: torch.Tensor, sqrt=torch.sqrt) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z) with w >= 0
    (branch-free Shepperd selection, as in the JAX package).  The file
    writers pass sqrt=exact_sqrt, so that their digits are XLA's."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cand = torch.stack(
        [
            torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
        ],
        dim=-2,
    )
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1, keepdim=True)  # (..., 1)
    q = torch.gather(cand, -2, best[..., None].expand(*best.shape, 4))[..., 0, :]
    denom = 2.0 * sqrt(torch.clamp(torch.gather(mags, -1, best)[..., 0], min=_EPS))
    q = q / denom[..., None]
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix (a quaternion that
    is not unit is normalized on the way)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / torch.clamp(n, min=_EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle via the quaternion route."""
    q = rot_to_quat(R)
    qw, qv = q[..., 0], q[..., 1:]
    n = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    scale = torch.where(
        n < _EPS, 2.0 / torch.clamp(qw, min=_EPS), theta / torch.clamp(n, min=_EPS)
    )
    return qv * scale[..., None]


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # The bottom row [0, 0, 0, 1] made on R's device: no host data.
    bottom = torch.cat([torch.zeros(3, dtype=R.dtype, device=R.device),
                        torch.ones(1, dtype=R.dtype, device=R.device)])
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: (..., 6) twist [v, w] -> (..., 4, 4) transform."""
    v, w = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, c = _sinc_coeffs(theta_sq)
    W = hat(w)
    WW = W @ W
    eye = _eye3_like(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    t = torch.einsum("...ij,...j->...i", V, v)
    return make_transform(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: (..., 4, 4) -> (..., 6) twist [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3(R)
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    WW = W @ W
    small = theta_sq < 1e-4
    b_safe = torch.where(small, 0.5, b)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - a / (2.0 * b_safe)) / torch.clamp(theta_sq, min=_EPS),
    )
    V_inv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * WW
    v = torch.einsum("...ij,...j->...i", V_inv, t)
    return torch.cat([v, w], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to batched points (..., 3)."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def transform_point_cloud(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a single (4, 4) transform to an (N, 3) cloud."""
    return pts @ T[:3, :3].T + T[:3, 3]


def orthonormalize(R: torch.Tensor, iterations: int = 3) -> torch.Tensor:
    """Project a near-rotation onto SO(3): the orthogonal polar factor,
    by Newton's iteration R <- (R + R^-T) / 2.

    The JAX package takes U V^T from an SVD; for a matrix with positive
    determinant that is the same polar factor.  Newton converges
    quadratically (a 1e-2 perturbation is at f32 roundoff after three
    steps) and, unlike a 3x3 SVD on the GPU, is a handful of elementwise
    ops with no solver call.
    """
    from vslam_tpu_torch.solve.gn import inv3  # solve.gn imports this module

    for _ in range(iterations):
        R = 0.5 * (R + inv3(R).transpose(-1, -2))
    return R


def orthonormalize_transform(T: torch.Tensor) -> torch.Tensor:
    return make_transform(orthonormalize(T[..., :3, :3]), T[..., :3, 3])


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint on [v, w] twists: (..., 4, 4) -> (..., 6, 6) =
    [[R, hat(t) R], [0, R]], so T exp(xi) T^-1 = exp(Ad_T xi)."""
    R = T[..., :3, :3]
    top = torch.cat([R, hat(T[..., :3, 3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _jl_so3_coeffs(theta_sq: torch.Tensor) -> torch.Tensor:
    """e of the SO(3) left-Jacobian inverse Jl(w)^-1 = I - W/2 + e W^2,
    e = 1/t^2 - (1 + cos t) / (2 t sin t)."""
    small = theta_sq < 1e-4
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    t = torch.sqrt(ts)
    return torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       1.0 / ts - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t)))


def jl_inv_so3(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3): (..., 3) -> (..., 3, 3)."""
    e = _jl_so3_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye3_like(W) - 0.5 * W + e[..., None, None] * (W @ W)


def _se3_Q(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q(v, w): the off-diagonal block of the SE(3) left
    Jacobian [[Jl(w), Q], [0, Jl(w)]] (translation-first twists)."""
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < 1e-4
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    t = torch.sqrt(ts)
    st, ct = torch.sin(t), torch.cos(t)
    c2 = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (t - st) / (ts * t))
    c3 = torch.where(small, 1.0 / 24.0 - theta_sq / 720.0,
                     (ts + 2.0 * ct - 2.0) / (2.0 * ts * ts))
    c4 = torch.where(small, -1.0 / 120.0 + theta_sq / 5040.0,
                     (t - st - t * ts / 6.0) / (ts * ts * t))
    coef4 = 0.5 * (c3 + 3.0 * c4)
    V, W = hat(v), hat(w)
    WV, VW = W @ V, V @ W
    WVW = WV @ W
    return (0.5 * V
            + c2[..., None, None] * (WV + VW + W @ VW)
            + c3[..., None, None] * (W @ WV + VW @ W - 3.0 * WVW)
            + coef4[..., None, None] * (WVW @ W + W @ WVW))


def jl_inv_se3(xi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SE(3): (..., 6) -> (..., 6, 6), with
    log(exp(delta) exp(xi)) ~= xi + Jl(xi)^-1 delta."""
    v, w = xi[..., :3], xi[..., 3:]
    Jli = jl_inv_so3(w)
    top = torch.cat([Jli, -Jli @ _se3_Q(v, w) @ Jli], dim=-1)
    bot = torch.cat([torch.zeros_like(Jli), Jli], dim=-1)
    return torch.cat([top, bot], dim=-2)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation angle in radians."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
