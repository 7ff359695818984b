"""Stereo undistortion + rectification for raw (EuRoC-style) cameras
(port of vslam_tpu/io/rectification.py; numpy, no cv2).

The reference rectifies live camera input with cv2's
initUndistortRectifyMap (node.cpp:225-244); EuRoC ships RAW radial-
tangential-distorted images plus per-camera sensor.yaml calibration, so
the loader rectifies before the (rectified-stereo) pipeline sees the
frames.  The JAX package builds its maps with cv2.stereoRectify (Bouguet's
method, alpha 0, CALIB_ZERO_DISPARITY) and warps with cv2.remap; this
module computes the same in numpy: `stereo_rectify` follows
cv2.stereoRectify step by step (OpenCV 5's: f32 corner points, an f64
border grid over the pixel centres), `_build_map_numpy` is initUndistortRectifyMap, and
`remap_linear` is OpenCV 5's cv2.remap INTER_LINEAR on f32 images with
a constant 0 border (f32 fractional offsets and FMA lerps).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import yaml

from vslam_tpu_torch.ops import camera as cam_ops


@dataclass
class RawCamera:
    """One camera's raw calibration (EuRoC sensor.yaml schema)."""

    K: np.ndarray  # (3, 3)
    dist: np.ndarray  # (4,) radtan [k1, k2, p1, p2]
    T_BS: np.ndarray  # (4, 4) body-from-sensor extrinsics
    resolution: tuple  # (cols, rows)


def load_sensor_yaml(path: str) -> RawCamera:
    with open(path) as f:
        doc = yaml.safe_load(f)
    fu, fv, cu, cv_ = doc["intrinsics"]
    K = np.array([[fu, 0, cu], [0, fv, cv_], [0, 0, 1]], np.float64)
    dist = np.asarray(doc.get("distortion_coefficients", [0, 0, 0, 0]), np.float64)
    T_BS = np.asarray(doc["T_BS"]["data"], np.float64).reshape(4, 4)
    cols, rows = doc["resolution"]
    return RawCamera(K=K, dist=dist, T_BS=T_BS, resolution=(cols, rows))


def _distort_radtan(x, y, d):
    """Apply radial-tangential distortion to normalized coords."""
    k1, k2, p1, p2 = d[:4]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _build_map_numpy(K, dist, R, P, size):
    """initUndistortRectifyMap: for each rectified pixel, the source
    coordinate in the raw image (f32 maps)."""
    cols, rows = size
    u, v = np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    ray = np.stack([x, y, np.ones_like(x)], axis=-1) @ R  # R^T applied row-wise
    xd, yd = _distort_radtan(ray[..., 0] / ray[..., 2], ray[..., 1] / ray[..., 2], dist)
    return ((K[0, 0] * xd + K[0, 2]).astype(np.float32),
            (K[1, 1] * yd + K[1, 2]).astype(np.float32))


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """f32 fused multiply-add: the product of two f32 values is exact in
    f64, and the sum is rounded to f64 before f32 (a second rounding,
    which matched OpenCV's FMA on every image the tests try)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def remap_linear(img: np.ndarray, map_u: np.ndarray, map_v: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_u, map_v, INTER_LINEAR) for an f32 image with a
    constant 0 border, as OpenCV 5 computes it: the fractional offsets
    alpha, beta of each map coordinate in f32 (no 1/32-pixel table), a
    tap outside the image read as 0, and two lerps along x and one along
    y, each a fused multiply-add."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    map_u = np.asarray(map_u, np.float32)
    map_v = np.asarray(map_v, np.float32)
    fx, fy = np.floor(map_u), np.floor(map_v)
    alpha, beta = map_u - fx, map_v - fy
    x0 = np.clip(fx, -2, W + 1).astype(np.int64)
    y0 = np.clip(fy, -2, H + 1).astype(np.int64)

    def tap(dy, dx):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        return np.where(inside, img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)],
                        np.float32(0.0))

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = _fma(alpha, p01 - p00, p00)
    bottom = _fma(alpha, p11 - p10, p10)
    return _fma(beta, bottom - top, top)


# ---------------------------------------------------------------------------
# cv2.stereoRectify (Bouguet), in numpy
# ---------------------------------------------------------------------------


def _rodrigues_to_vec(R: np.ndarray) -> np.ndarray:
    """cv::Rodrigues matrix -> vector (after projecting R onto SO(3))."""
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        t = (np.diag(R) + 1.0) * 0.5
        r = np.sqrt(np.maximum(t, 0.0))
        r[1] *= -1.0 if R[0, 1] < 0 else 1.0
        r[2] *= -1.0 if R[0, 2] < 0 else 1.0
        if abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2]) and (R[1, 2] > 0) != (r[1] * r[2] > 0):
            r[2] = -r[2]
        return r * (theta / np.linalg.norm(r))
    return r * (theta / (2.0 * s))


def _rodrigues_to_mat(r: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(r)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    c, s = np.cos(theta), np.sin(theta)
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * K


def undistort_points(pts: np.ndarray, K: np.ndarray, dist: np.ndarray,
                     R: np.ndarray | None = None, P: np.ndarray | None = None,
                     iterations: int = 5) -> np.ndarray:
    """cv::undistortPoints with its default 5 fixed-point iterations:
    (N, 2) raw pixels -> (N, 2) f64 points, normalized or, with R and P,
    rectified pixels."""
    k1, k2, p1, p2 = dist[:4]
    x = (pts[:, 0].astype(np.float64) - K[0, 2]) / K[0, 0]
    y = (pts[:, 1].astype(np.float64) - K[1, 2]) / K[1, 1]
    x0, y0 = x, y
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + (k2 * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3] @ RR
    xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
    yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
    ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return np.stack([xx * ww, yy * ww], axis=1)


def _rectangles(K, dist, R, P, size, n=9):
    """OpenCV's getUndistortRectangles: the inner and outer (x, y, w, h)
    rectangles of the undistorted-and-rectified n x n grid over the
    image's pixel centres."""
    cols, rows = size
    g = np.arange(n, dtype=np.float64) / (n - 1)
    pts = np.stack(np.meshgrid(g * (cols - 1), g * (rows - 1)), axis=-1).reshape(-1, 2)
    p = undistort_points(pts, K, dist, R, P).reshape(n, n, 2)
    ix0, ix1 = p[:, 0, 0].max(), p[:, n - 1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[n - 1, :, 1].min()
    ox0, ox1 = p[..., 0].min(), p[..., 0].max()
    oy0, oy1 = p[..., 1].min(), p[..., 1].max()
    return ((ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0))


def stereo_rectify(K0, d0, K1, d1, size, R, t, alpha: float = 0.0):
    """cv2.stereoRectify(..., flags=CALIB_ZERO_DISPARITY, alpha) in numpy:
    returns (R0, R1, P0, P1), f64."""
    cols, rows = size
    nx, ny = float(cols), float(rows)
    om = _rodrigues_to_vec(np.asarray(R, np.float64)) * -0.5  # average rotation
    r_r = _rodrigues_to_mat(om)
    T = np.asarray(t, np.float64).reshape(3)
    tt = r_r @ T
    idx = 0 if abs(tt[0]) > abs(tt[1]) else 1
    c = tt[idx]
    nt = np.linalg.norm(tt)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(tt, uu)  # global rotation that aligns t with the image axis
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww *= np.arccos(abs(c) / nt) / nw
    wR = _rodrigues_to_mat(ww)
    R0 = wR @ r_r.T
    R1 = wR @ r_r
    tt = R1 @ T
    ratio = 0.5  # (new size / size) / 2, the new size being the size
    fc_new = (K0[idx ^ 1, idx ^ 1] + K1[idx ^ 1, idx ^ 1]) * ratio
    cc_new = []
    # The image corners go through f32 points here, as in OpenCV.
    corners = np.array([[0.0, 0.0], [nx - 1, 0.0], [0.0, ny - 1], [nx - 1, ny - 1]])
    for K, d, Rk in ((K0, d0, R0), (K1, d1, R1)):
        p = undistort_points(corners, K, d).astype(np.float32).astype(np.float64)
        X = np.concatenate([p, np.ones((4, 1))], axis=1) @ Rk.T
        proj = (fc_new * X[:, :2] / X[:, 2:3]).astype(np.float32).astype(np.float64)
        avg = proj.mean(axis=0)
        cc_new.append(np.array([(nx - 1) / 2 - avg[0], (ny - 1) / 2 - avg[1]]))
    cc = (cc_new[0] + cc_new[1]) * 0.5  # CALIB_ZERO_DISPARITY
    cc_new = [cc.copy(), cc.copy()]
    P0 = np.zeros((3, 4))
    P0[0, 0] = P0[1, 1] = fc_new
    P0[:2, 2] = cc_new[0]
    P0[2, 2] = 1.0
    P1 = P0.copy()
    P1[:2, 2] = cc_new[1]
    P1[idx, 3] = tt[idx] * fc_new  # baseline * focal length
    alpha = min(alpha, 1.0)
    inner0, outer0 = _rectangles(K0, d0, R0, P0, size)
    inner1, outer1 = _rectangles(K1, d1, R1, P1, size)
    s = 1.0
    if alpha >= 0:
        s0 = s1 = None
        for (cx, cy), inner, outer in ((cc_new[0], inner0, outer0),
                                       (cc_new[1], inner1, outer1)):
            ins = [cx / (cx - inner[0]), cy / (cy - inner[1]),
                   (nx - 1 - cx) / (inner[0] + inner[2] - cx),
                   (ny - 1 - cy) / (inner[1] + inner[3] - cy)]
            outs = [cx / (cx - outer[0]), cy / (cy - outer[1]),
                    (nx - 1 - cx) / (outer[0] + outer[2] - cx),
                    (ny - 1 - cy) / (outer[1] + outer[3] - cy)]
            s0 = max(ins + ([s0] if s0 is not None else []))
            s1 = min(outs + ([s1] if s1 is not None else []))
        s = s0 * (1 - alpha) + s1 * alpha
    fc_new *= s
    for P in (P0, P1):
        P[0, 0] = P[1, 1] = fc_new
    P1[idx, 3] *= s
    return R0, R1, P0, P1


class StereoRectifier:
    """Precomputed undistort+rectify maps for a raw stereo pair.

    After construction, `cam` holds the rectified pinhole CameraParams
    (single K, horizontal baseline; host tensors, which the engine moves
    to its device) and `rectify(img, side)` warps a raw frame."""

    def __init__(self, cam0: RawCamera, cam1: RawCamera):
        cols, rows = cam0.resolution
        self.size = (cols, rows)
        T_c1_c0 = np.linalg.inv(cam1.T_BS) @ cam0.T_BS  # cam1 <- cam0
        self.R0, self.R1, self.P0, self.P1 = stereo_rectify(
            cam0.K, cam0.dist, cam1.K, cam1.dist, self.size, T_c1_c0[:3, :3], T_c1_c0[:3, 3])
        self.maps0 = _build_map_numpy(cam0.K, cam0.dist, self.R0, self.P0, self.size)
        self.maps1 = _build_map_numpy(cam1.K, cam1.dist, self.R1, self.P1, self.size)
        P0, P1 = self.P0, self.P1
        self.cam = cam_ops.make_camera(
            fx=float(P0[0, 0]), fy=float(P0[1, 1]), cx=float(P0[0, 2]), cy=float(P0[1, 2]),
            baseline_m=float(abs(P1[0, 3] / P1[0, 0])), rows=rows, cols=cols, device="cpu")

    @classmethod
    def identity_test_rig(cls, K, dist, size, baseline=0.11):
        """A rectifier for a single already-aligned camera pair with known
        distortion — used by tests to validate pure undistortion."""
        rig = cls.__new__(cls)
        cols, rows = size
        rig.size = size
        rig.maps0 = _build_map_numpy(K, dist, np.eye(3), np.asarray(K, np.float64), size)
        rig.maps1 = rig.maps0
        rig.cam = cam_ops.make_camera(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
            baseline_m=baseline, rows=rows, cols=cols, device="cpu")
        return rig

    def rectify(self, img: np.ndarray, side: int) -> np.ndarray:
        maps = self.maps0 if side == 0 else self.maps1
        return remap_linear(img, maps[0], maps[1])


def rectifier_from_euroc(mav_dir: str) -> StereoRectifier | None:
    """Build a rectifier from mav0/cam{0,1}/sensor.yaml; None if absent."""
    y0 = os.path.join(mav_dir, "cam0", "sensor.yaml")
    y1 = os.path.join(mav_dir, "cam1", "sensor.yaml")
    if not (os.path.exists(y0) and os.path.exists(y1)):
        return None
    return StereoRectifier(load_sensor_yaml(y0), load_sensor_yaml(y1))
