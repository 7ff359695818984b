"""The robust Gauss-Newton engine, its configuration and the closed-form
small solves (port of vslam_tpu/solve/gn.py).

`gauss_newton` is the JAX package's generic engine: per-measurement
residuals with forward-mode Jacobians (torch.func.jacfwd, mapped over the
measurements by torch.func.vmap), the reference's clamping robust kernel,
robust rounds to convergence, then inlier-only refinement rounds.  It is
the reference the closed-form solvers of solve/aligners.py are checked
against; those share its two-phase loop (`two_phase`).  Each
`lax.while_loop` of the JAX engine is an ops/control.py while_loop over
the batch of problems: a problem whose loop condition fails keeps its
state, and the loop ends when none goes on -- a WHILE node of the CUDA
graph under a capture, rounds to the cap with frozen state eagerly on
the card, an early exit on the CPU; the bits are the same on all three."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vslam_tpu_torch.ops import control, lie


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



def _robust_weights(chi2: torch.Tensor, kernel) -> torch.Tensor:
    """Reference clamping kernel: weight kernel / chi2 beyond the kernel
    (stereouv_aligner.cpp:127-134)."""
    return torch.where(chi2 > kernel, kernel / torch.clamp(chi2, min=1e-12), 1.0)


def keep_going(prev_chi2, chi2, step, it, first_rounds, config):
    rel = torch.abs(prev_chi2 - chi2) / torch.clamp(chi2, min=1e-12)
    return (it < first_rounds) | (rel > config.tolerance) | (
        step > config.step_tolerance
    )


def two_phase(linearize, x0: torch.Tensor, mask: torch.Tensor, config: GNConfig,
              retract: Callable = None, recount: bool = False) -> GNResult:
    """The JAX package's two-phase robust gauss_newton loop over B problems
    at once: robust GN to convergence, then inlier-only rounds that reject
    a collapse of the inlier set.  linearize(x, extra_mask) gives (H
    (B,D,D), b (B,D), total chi2 (B,), inliers (B,N)) with extra_mask ANDed
    into mask; retract(x, dx) updates the (B, ...) states (default: SE(3)
    left multiplication).  num_inliers counts the inlier set carried out
    of the refinement phase, or with recount the inliers of one last
    linearization at the solution (the stereo solve's rule)."""
    retract = retract or se3_retract
    B, dev = x0.shape[0], x0.device

    def per_problem(flag, like):
        return flag.reshape((B,) + (1,) * (like.dim() - 1))

    def one_round(x, extra_mask):
        H, b, total, inliers = linearize(x, extra_mask)
        dx = solve_normal_equations(H, b, config.damping)
        # Trust-region clamp; a non-finite step keeps the previous iterate.
        norm = torch.linalg.vector_norm(dx, dim=-1)
        dx = dx * torch.clamp(config.max_step_norm / torch.clamp(norm, min=1e-12),
                              max=1.0)[:, None]
        ok = torch.all(torch.isfinite(dx), dim=-1)
        x_new = torch.where(per_problem(ok, x), retract(x, dx), x)
        return x_new, total, inliers, torch.where(ok, norm, 0.0)

    inf = torch.full((B,), float("inf"), device=dev)
    all_true = torch.ones_like(mask)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)

    # Phase 1: robust GN over all measurements.
    def body1(s):
        x, _, chi2, it, _, _ = s
        x2, new_chi2, inl2, step2 = one_round(x, all_true)
        return x2, chi2, new_chi2, it + 1, inl2, step2

    x, _, chi2, iters, inl, _ = control.while_loop(
        lambda s: keep_going(s[1], s[2], s[5], s[3], 2, config), body1,
        (x0, inf, torch.full((B,), 1e30, device=dev), zero, mask, inf),
        config.max_iterations, name="gn phase 1")

    # Phase 2: inlier-only refinement with collapse rejection.
    def body2(s):
        x, _, chi2, it, inl, _ = s
        x2, new_chi2, inl2, step2 = one_round(x, inl)
        keep = torch.sum(inl2, dim=-1) >= config.min_num_inliers
        return (torch.where(per_problem(keep, x), x2, x), chi2,
                torch.where(keep, new_chi2, chi2), it + 1,
                torch.where(keep[:, None], inl2, inl), torch.where(keep, step2, 0.0))

    x, _, chi2, _, inl, _ = control.while_loop(
        lambda s: keep_going(s[1], s[2], s[5], s[3], 1, config), body2,
        (x, inf, chi2, zero, inl, inf), config.refine_iterations, name="gn phase 2")

    _, _, final_chi2, final_inl = linearize(x, inl)
    if recount:
        inl = final_inl
    num_inliers = torch.sum(inl, dim=-1).to(torch.int32)
    return GNResult(
        x=x,
        chi2=final_chi2 / torch.clamp(num_inliers.to(torch.float32), min=1.0),
        num_inliers=num_inliers,
        num_iterations=iters,
        inlier_mask=inl,
        converged=num_inliers >= config.min_num_inliers,
    )


def gauss_newton(residual_fn: Callable, x0: torch.Tensor, data, mask: torch.Tensor,
                 config: GNConfig, retract: Callable | None = None,
                 diag_fn: Callable | None = None, state_dim: int | None = None) -> GNResult:
    """Robust GN to convergence, then inlier-only refinement rounds.

    residual_fn: (x, datum) -> (r (R,), J (R, D)) for one measurement,
    mapped over the leading axis of `data` (a tuple of tensors, leading
    dim N); mask (N,) bool selects the valid measurements; retract(x, dx
    (D,)) -> x defaults to x + dx; diag_fn(x, datum, r) -> (R,) is the
    diagonal information of one measurement (ones by default).  state_dim
    is accepted for the JAX signature; D comes from the Jacobian."""
    del state_dim
    retract = retract or (lambda x, dx: x + dx)
    vmap = torch.func.vmap
    batched_res = vmap(residual_fn, in_dims=(None, 0))
    batched_diag = None if diag_fn is None else vmap(diag_fn, in_dims=(None, 0, 0))
    kernel = config.kernel_max_error

    def linearize(x, extra_mask):
        r, J = batched_res(x[0], data)  # (N, R), (N, R, D)
        omega = torch.ones_like(r) if batched_diag is None else batched_diag(x[0], data, r)
        chi2 = torch.sum(r * omega * r, dim=-1)
        use = mask & extra_mask[0]
        w_eff = _robust_weights(chi2, kernel) * use.to(r.dtype)
        ow = omega * w_eff[:, None]
        H = torch.einsum("nri,nr,nrj->ij", J, ow, J)
        b = torch.einsum("nri,nr->i", J, ow * r)
        inliers = (chi2 <= kernel) & use
        return H[None], b[None], torch.sum(chi2 * w_eff)[None], inliers[None]

    res = two_phase(linearize, x0[None], mask[None], config,
                    retract=lambda x, dx: retract(x[0], dx[0])[None])
    return GNResult(*(f[0] for f in res))
