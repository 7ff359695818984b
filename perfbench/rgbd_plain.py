"""The plain reference of the RGB-D route's two computations, in plain
torch and float64: the framepoints one keypoint at a time, the pose one
problem at a time over its own measurements (dense sums over them).
Nothing of the program, no kernel, no batching of problems, no capacity
padding.

framepoints: ProSLAM's DepthFramePointGenerator::compute after detection
and description, as the JAX package and the port document it
(vslam_tpu/frontend/depth.py, mapping/frame.py process_depth_frame): the
depth of the pixel nearest each keypoint (coordinates rounded half to
even), valid where it lies in [min, max], and the point z K^-1 [u, v, 1].

uvd_solve: ProSLAM's UVDAligner cost (uvd_aligner.cpp) as the JAX
package documents it (vslam_tpu/solve/aligners.py make_uvd_residual,
uvd_align; the port's uvd_align docstring): for each measurement the
residual [u, v, z](T p_prev) - [u, v, z]_measured, the information
diag(w, w, 10 w) where the measured depth is reliable and diag(w, w, 0)
where it is not, the clamping robust kernel (a measurement whose chi2
passes the kernel gets the weight kernel / chi2) and the inlier gate
chi2 <= kernel; robust rounds, then rounds over the inliers alone.
Departures, none of which moves the solution the rounds converge to:

  * float64 throughout (`dtype` may ask for another, to show what a
    lower precision does);
  * every phase runs to convergence (a step below 1e-12), where the
    published aligner and the program stop after a fixed number of
    rounds or at a tolerance;
  * plain Gauss-Newton: no damping and no cap on the step (the program
    adds 1 to the normal matrix's diagonal and caps the step's norm,
    neither of which moves a fixed point);
  * the inlier phase repeats until its inlier set no longer shrinks, with
    the program's guard against a collapse (a set below min_inliers is
    not taken);
  * measurements whose point lies behind the camera under the first
    guess are left out, as the JAX package leaves them out.

Imports only torch and the standard library, so that it runs on the
card's machine.  A float32 matrix product there may run in TF32, so the
module turns TF32 off; its own products are float64.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The information of a reliable depth against the image coordinates'.
DEPTH_INFORMATION = 10.0
# A phase has converged when its step's norm falls below this.
STEP_TOLERANCE = 1e-12
MAX_ROUNDS = 200


def framepoints(depth: torch.Tensor, uv: torch.Tensor, K: torch.Tensor, min_m: float,
                max_m: float, dtype=torch.float64):
    """(z (N,), valid (N,) bool, p (N, 3)) of the keypoints uv (N, 2) on
    the depth map (H, W) in meters, K the (3, 3) intrinsics, one keypoint
    at a time."""
    D = depth.detach().cpu()
    H, W = D.shape
    K_inv = torch.linalg.inv(K.detach().cpu().to(torch.float64)).to(dtype)
    pts = uv.detach().cpu().to(torch.float64)
    zs, valid, ps = [], [], []
    for u, v in pts.tolist():
        c, r = round(u), round(v)  # Python rounds half to even
        if not (0 <= c < W and 0 <= r < H):
            raise ValueError(f"keypoint ({u}, {v}) lies outside the {H}x{W} image")
        z = D[r, c].to(dtype)
        zs.append(z)
        valid.append(bool(min_m <= float(z) <= max_m))
        ps.append(z * (K_inv @ torch.tensor([u, v, 1.0], dtype=dtype)))
    if not zs:
        return (torch.zeros(0, dtype=dtype), torch.zeros(0, dtype=torch.bool),
                torch.zeros((0, 3), dtype=dtype))
    return torch.stack(zs), torch.tensor(valid), torch.stack(ps)


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=w.dtype)
    return torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """The SE(3) exponential of the twist [v, w] (4, 4)."""
    v, w = xi[:3], xi[3:]
    theta = torch.linalg.vector_norm(w)
    W = _hat(w)
    eye = torch.eye(3, dtype=xi.dtype)
    if float(theta) < 1e-10:
        R, V = eye + W, eye + 0.5 * W
    else:
        a = torch.sin(theta) / theta
        b = (1 - torch.cos(theta)) / theta ** 2
        c = (theta - torch.sin(theta)) / theta ** 3
        R = eye + a * W + b * (W @ W)
        V = eye + b * W + c * (W @ W)
    T = torch.eye(4, dtype=xi.dtype)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def _linearize(K, T, p, m, omega):
    """The residuals (N, 3), their Jacobians wrt the left tangent (N, 3, 6)
    and their chi2 (N,) of the measurements at T."""
    q = p @ T[:3, :3].T + T[:3, 3]
    x, y, z = q.unbind(1)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    r = torch.stack([fx * x / z + cx, fy * y / z + cy, z], dim=1) - m
    zero, one = torch.zeros_like(z), torch.ones_like(z)
    Jproj = torch.stack([torch.stack([fx / z, zero, -fx * x / z ** 2], dim=1),
                         torch.stack([zero, fy / z, -fy * y / z ** 2], dim=1),
                         torch.stack([zero, zero, one], dim=1)], dim=1)
    hat = torch.stack([torch.stack([zero, -q[:, 2], q[:, 1]], dim=1),
                       torch.stack([q[:, 2], zero, -q[:, 0]], dim=1),
                       torch.stack([-q[:, 1], q[:, 0], zero], dim=1)], dim=1)
    eye = torch.eye(3, dtype=p.dtype).expand(len(p), 3, 3)
    J = Jproj @ torch.cat([eye, -hat], dim=2)
    return r, J, (r * omega * r).sum(dim=1)


def _robust(chi2: torch.Tensor, kernel: float) -> torch.Tensor:
    return torch.where(chi2 > kernel, kernel / chi2, torch.ones_like(chi2))


def _solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if H.dtype in (torch.float32, torch.float64):
        return torch.linalg.solve(H, b)
    # torch has no 6x6 solve below float32: the step alone goes through it.
    return torch.linalg.solve(H.float(), b.float()).to(H.dtype)


def _solve_set(K, T, p_prev, meas, omega, use, kernel):
    """Gauss-Newton over the measurements in `use` (N,) bool to
    convergence; returns (T, the chi2 of every measurement at T)."""
    p, m, om = p_prev[use], meas[use], omega[use]
    for _ in range(MAX_ROUNDS):
        r, J, chi2 = _linearize(K, T, p, m, om)
        ow = _robust(chi2, kernel)[:, None] * om  # (n, 3)
        H = torch.einsum("nri,nr,nrj->ij", J, ow, J)
        b = torch.einsum("nri,nr->i", J, ow * r)
        dx = -_solve(H, b)
        T = exp_se3(dx) @ T
        if float(torch.linalg.vector_norm(dx.double())) < STEP_TOLERANCE:
            break
    return T, _linearize(K, T, p_prev, meas, omega)[2]


def uvd_solve(K: torch.Tensor, p_prev: torch.Tensor, meas: torch.Tensor,
              weight: torch.Tensor, reliable: torch.Tensor, mask: torch.Tensor,
              T0: torch.Tensor, kernel: float = 25.0, min_inliers: int = 10,
              dtype=torch.float64):
    """T_cur_prev (4, 4) from [u, v, depth] measurements meas (N, 3) of the
    points p_prev (N, 3) in the previous camera, each with its weight (N,),
    whether its depth is reliable (N,) and whether it takes part (mask,
    (N,)), from the guess T0 (4, 4); K the (3, 3) intrinsics.  Returns
    (T, inliers (N,) bool, converged)."""
    K, p_prev, meas, weight, T0 = (a.detach().cpu().to(dtype)
                                   for a in (K, p_prev, meas, weight, T0))
    reliable, mask = reliable.detach().cpu().bool(), mask.detach().cpu().bool()
    omega = torch.stack([weight, weight,
                         weight * DEPTH_INFORMATION * reliable.to(dtype)], dim=1)
    z0 = p_prev @ T0[2, :3] + T0[2, 3]
    use = mask & (z0 > 0.01)
    if not bool(use.any()):
        return T0, torch.zeros_like(use), False
    # Robust rounds over every measurement, to convergence.
    T, chi2 = _solve_set(K, T0, p_prev, meas, omega, use, kernel)
    # Rounds over the inliers alone, until the set stops shrinking.
    inl = use & (chi2 <= kernel)
    while int(inl.sum()) >= min_inliers:
        T_new, chi2 = _solve_set(K, T, p_prev, meas, omega, inl, kernel)
        kept = inl & (chi2 <= kernel)
        if int(kept.sum()) < min_inliers:
            break
        T = T_new
        if torch.equal(kept, inl):
            break
        inl = kept
    return T, inl, int(inl.sum()) >= min_inliers
