"""Closed-form small solves and the Gauss-Newton configuration (port of
vslam_tpu/solve/gn.py; the generic autodiff engine is not ported — the
slice's solvers use analytic Jacobians, solve/aligners.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.ops import lie


class GNConfig(NamedTuple):
    """Mirrors reference AlignerParameters (src/types/parameters.h:66-95)."""

    max_iterations: int = 30
    kernel_max_error: float = 25.0
    damping: float = 1.0
    min_num_inliers: int = 10
    tolerance: float = 1e-4
    step_tolerance: float = 1e-3
    refine_iterations: int = 4
    max_step_norm: float = 1.0


class GNResult(NamedTuple):
    x: torch.Tensor  # final state
    chi2: torch.Tensor  # mean inlier chi2
    num_inliers: torch.Tensor  # int32
    num_iterations: torch.Tensor  # int32
    inlier_mask: torch.Tensor  # (N,) bool
    converged: torch.Tensor  # bool


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate (batched elementwise ops)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        co_a, c * h - b * i, b * f - c * e,
        co_b, a * i - c * g, c * d - a * f,
        co_c, b * g - a * h, a * e - b * d,
    ], dim=-1).reshape(A.shape)
    return adj * (1.0 / det)[..., None, None]


def inv6(M: torch.Tensor) -> torch.Tensor:
    """Closed-form SPD 6x6 inverse by the 2x2-block Schur complement."""
    A, B, C = M[..., :3, :3], M[..., :3, 3:], M[..., 3:, 3:]
    Ai = inv3(A)
    AiB = Ai @ B
    Si = inv3(C - B.transpose(-1, -2) @ AiB)
    AiB_Si = AiB @ Si
    TL = Ai + AiB_Si @ AiB.transpose(-1, -2)
    TR = -AiB_Si
    return torch.cat([
        torch.cat([TL, TR], dim=-1),
        torch.cat([TR.transpose(-1, -2), Si], dim=-1),
    ], dim=-2)


def solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD H of size 3 or 6 with the closed forms."""
    dim = H.shape[-1]
    if dim == 3:
        return (inv3(H) @ b[..., None])[..., 0]
    if dim != 6:
        raise ValueError(f"solve_spd: size {dim} (3 or 6 supported)")
    A, B, C = H[..., :3, :3], H[..., :3, 3:], H[..., 3:, 3:]
    b1, b2 = b[..., :3, None], b[..., 3:, None]
    Ai = inv3(A)
    AiB = Ai @ B
    Bt = B.transpose(-1, -2)
    Si = inv3(C - Bt @ AiB)
    Aib1 = Ai @ b1
    y = Si @ (b2 - Bt @ Aib1)
    x = Aib1 - AiB @ y
    return torch.cat([x, y], dim=-2)[..., 0]


def solve_normal_equations(H: torch.Tensor, b: torch.Tensor, damping) -> torch.Tensor:
    """Damped solve of (H + damping*I) dx = -b."""
    dim = H.shape[-1]
    Hd = H + damping * torch.eye(dim, dtype=H.dtype, device=H.device)
    return -solve_spd(Hd, b)


def se3_retract(T: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative SE(3) update with re-orthonormalization."""
    return lie.orthonormalize_transform(lie.exp_se3(dx) @ T)
