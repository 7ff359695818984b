"""Pinhole stereo camera model and triangulation (port of
vslam_tpu/ops/camera.py).  Functions are batched over a leading point
dimension; CameraParams holds tensors on the camera's device plus the
static image size."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class CameraParams(NamedTuple):
    """Per-run camera intrinsics + stereo geometry.

    K: (3, 3) intrinsics; baseline_m: 0-d stereo baseline in meters (the
    right-image column is u_r = u_l - fx * baseline / z); rows/cols: image
    size (static Python ints); T_cam_robot: (4, 4) robot -> camera;
    K_inv: torch.linalg.inv(K), made once with the camera (its error check
    reads the device, which a frame's program must not do).
    """

    K: torch.Tensor
    baseline_m: torch.Tensor
    rows: int
    cols: int
    T_cam_robot: torch.Tensor
    K_inv: torch.Tensor
    depth_scale: float = 1e-3

    @property
    def device(self) -> torch.device:
        return self.K.device

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]


def make_camera(
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    baseline_m: float,
    rows: int,
    cols: int,
    T_cam_robot=None,
    device=DEFAULT_DEVICE,
) -> CameraParams:
    device = resolve_device(device)
    K = torch.tensor(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float32,
        device=device,
    )
    if T_cam_robot is None:
        T_cam_robot = torch.eye(4, dtype=torch.float32)
    return CameraParams(
        K=K,
        baseline_m=torch.tensor(baseline_m, dtype=torch.float32, device=device),
        rows=int(rows),
        cols=int(cols),
        T_cam_robot=torch.as_tensor(T_cam_robot, dtype=torch.float32).to(device),
        K_inv=torch.linalg.inv(K),
    )


def to_device(cam: CameraParams, device) -> CameraParams:
    """The same camera with its tensors on `device`."""
    return cam._replace(K=cam.K.to(device), baseline_m=cam.baseline_m.to(device),
                        T_cam_robot=cam.T_cam_robot.to(device), K_inv=cam.K_inv.to(device))


def project(cam: CameraParams, p_cam: torch.Tensor, eps: float = 1e-6):
    """Camera-frame points (N, 3) -> pixel (u, v) (N, 2), plus depth z.
    Points behind the camera keep a tiny positive divisor; callers mask
    on the returned z."""
    z = p_cam[..., 2]
    z_safe = torch.clamp(z, min=eps)
    u = cam.fx * p_cam[..., 0] / z_safe + cam.cx
    v = cam.fy * p_cam[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(cam: CameraParams, p_cam: torch.Tensor, eps: float = 1e-6):
    """Project into both rectified cameras: (uv_left, uv_right, z)."""
    uv_l, z = project(cam, p_cam, eps)
    disp = cam.fx * cam.baseline_m / torch.clamp(z, min=eps)
    uv_r = torch.stack([uv_l[..., 0] + (-disp), uv_l[..., 1]], dim=-1)
    return uv_l, uv_r, z


def in_field_of_view(cam: CameraParams, uv: torch.Tensor, z: torch.Tensor,
                     border: float = 0.0):
    """Visibility mask (reference camera.cpp:29-42)."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (z > 0.0)
        & (u >= border)
        & (u < cam.cols - border)
        & (v >= border)
        & (v < cam.rows - border)
    )


def back_project(cam: CameraParams, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pixel + depth -> camera-frame 3D point (N, 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def triangulate_disparity(cam: CameraParams, uv_left: torch.Tensor,
                          uv_right: torch.Tensor, min_disparity: float = 1.0):
    """Rectified-stereo triangulation -> ((N, 3) points, valid mask);
    z = fx * b / disparity with the minimum-disparity gate."""
    disp = uv_left[..., 0] - uv_right[..., 0]
    valid = disp >= min_disparity
    z = cam.fx * cam.baseline_m / torch.clamp(disp, min=min_disparity)
    return back_project(cam, uv_left, z), valid


def triangulate_midpoint(cam: CameraParams, uv_a: torch.Tensor,
                         uv_b: torch.Tensor, T_a_b: torch.Tensor,
                         max_depth: float = 1e3):
    """Two-view midpoint triangulation from motion (closed-form 2x2 normal
    equations), returning the midpoint in camera A and a validity mask
    (parallax + positive depth)."""
    K_inv = cam.K_inv
    ones = torch.ones(uv_a.shape[:-1] + (1,), dtype=uv_a.dtype, device=uv_a.device)
    da = torch.cat([uv_a, ones], dim=-1) @ K_inv.T
    db_local = torch.cat([uv_b, ones], dim=-1) @ K_inv.T
    R = T_a_b[:3, :3]
    o_b = T_a_b[:3, 3]
    db = db_local @ R.T
    aa = torch.sum(da * da, dim=-1)
    bb = torch.sum(db * db, dim=-1)
    ab = torch.sum(da * db, dim=-1)
    at = torch.sum(da * o_b, dim=-1)
    bt = torch.sum(db * o_b, dim=-1)
    cross = torch.linalg.cross(da, db)
    det = torch.sum(cross * cross, dim=-1)
    parallax_ok = det > 1e-6 * aa * bb
    det_safe = torch.where(parallax_ok, det, torch.ones_like(det))
    u = (bb * at - ab * bt) / det_safe
    s = (ab * at - aa * bt) / det_safe
    mid = 0.5 * (u[..., None] * da + (o_b + s[..., None] * db))
    valid = (parallax_ok & (u > 0) & (s > 0) & (mid[..., 2] > 0)
             & (mid[..., 2] < max_depth))
    return mid, valid
