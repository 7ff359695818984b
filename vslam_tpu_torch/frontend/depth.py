"""RGB-D front-end programs (port of vslam_tpu/frontend/depth.py).

The reference's serial depth-map registration with z-buffering
(depth_framepoint_generator.cpp:410-484) becomes one scatter-min over the
depth pixels, and the per-feature depth assignment (:46-164) a gather at
the keypoints.  A minimum does not depend on the order of its operands,
so the registration is deterministic on CUDA too.
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops import camera as cam_ops


def gather_depth(depth_m: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Depth at keypoint pixels (nearest, half to even): (H, W), (K, 2) -> (K,)."""
    H, W = depth_m.shape
    c = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W - 1)
    r = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H - 1)
    return depth_m[r, c]


def bilateral_filter_depth(depth_m: torch.Tensor, radius: int = 2,
                           sigma_space: float = 2.0,
                           sigma_range_m: float = 0.1) -> torch.Tensor:
    """Edge-preserving depth smoothing (the reference's cv::bilateralFilter
    option, depth_framepoint_generator.cpp:415-421): a shifted-window mean
    whose weights fall off with pixel distance and depth difference.
    Invalid pixels (depth 0) carry no weight and stay 0."""
    H, W = depth_m.shape
    pad = torch.nn.functional.pad(depth_m, (radius,) * 4)
    num = torch.zeros_like(depth_m)
    den = torch.zeros_like(depth_m)
    inv_2ss = 0.5 / (sigma_space * sigma_space)
    inv_2sr = 0.5 / (sigma_range_m * sigma_range_m)
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            nb = pad[radius + dr:radius + dr + H, radius + dc:radius + dc + W]
            w = torch.exp(-(dr * dr + dc * dc) * inv_2ss - (nb - depth_m) ** 2 * inv_2sr)
            w = torch.where(nb > 0, w, 0.0)
            num = num + w * nb
            den = den + w
    out = torch.where(den > 0, num / torch.clamp(den, min=1e-12), 0.0)
    return torch.where(depth_m > 0, out, 0.0)


def register_depth(cam_rgb: cam_ops.CameraParams, depth_m: torch.Tensor,
                   K_depth_inv: torch.Tensor, T_rgb_depth: torch.Tensor) -> torch.Tensor:
    """Reproject a depth image taken by a misaligned depth camera into the
    RGB camera with z-buffering (reference _computeDepthMap).

    depth_m: (H, W) depth in the depth camera; K_depth_inv (3, 3) the
    inverse of its intrinsics (torch.linalg.inv, made once by the caller:
    its error check reads the device); T_rgb_depth (4, 4) depth camera ->
    RGB camera.
    Returns (rows, cols) depth registered to the RGB frame, 0 where unknown."""
    H, W = depth_m.shape
    dev, dt = depth_m.device, depth_m.dtype
    rows = torch.arange(H, dtype=dt, device=dev)[:, None].expand(H, W).reshape(-1)
    cols = torch.arange(W, dtype=dt, device=dev)[None, :].expand(H, W).reshape(-1)
    z = depth_m.reshape(-1)
    rays = torch.stack([cols, rows, torch.ones_like(z)], dim=1) @ K_depth_inv.T
    p_rgb = (rays * z[:, None]) @ T_rgb_depth[:3, :3].T + T_rgb_depth[:3, 3]
    uv, z_rgb = cam_ops.project(cam_rgb, p_rgb)
    c = torch.round(uv[:, 0]).to(torch.int64)
    r = torch.round(uv[:, 1]).to(torch.int64)
    inb = ((z > 0) & (z_rgb > 0) & (c >= 0) & (c < cam_rgb.cols)
           & (r >= 0) & (r < cam_rgb.rows))
    flat = torch.where(inb, r * cam_rgb.cols + c, 0)
    out = torch.full((cam_rgb.rows * cam_rgb.cols,), float("inf"), dtype=dt, device=dev)
    out.scatter_reduce_(0, flat, torch.where(inb, z_rgb, float("inf")), "amin")
    out = torch.where(torch.isinf(out), 0.0, out)
    return out.reshape(cam_rgb.rows, cam_rgb.cols)
