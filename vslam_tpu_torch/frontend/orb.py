"""Box blur, the BRIEF test pattern and the rotation-aware gather
descriptor ORB256 (port of vslam_tpu/frontend/orb.py).

`box_blur` blurs an (H, W) image or a (B, H, W) stack: a CPU tensor runs
the plain version (`box_blur_reference`), a CUDA tensor launches the
kernel box_blur_kernel (csrc/box_blur.cu) once over the whole stack
(there is no fallback between the two).

`describe` steers the 256-pair pattern by each keypoint's intensity-
centroid orientation over a radius-15 disk and compares bilinear samples
of the box-blurred image, every keypoint at once: (K, 31, 31) disk samples
and (K, 256, 2) pattern samples, gathered with indices clipped as JAX
clamps them.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_tpu_torch.ops import hamming
from vslam_tpu_torch.ops.cuda_build import CudaKernel

PATCH_RADIUS = 15  # orientation patch radius (ORB standard 31x31 patch)
PATTERN_RADIUS = 13  # BRIEF pattern extent
N_BITS = 256


def _make_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) [pair, point, (dr, dc)] Gaussian BRIEF pattern, clipped."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATTERN_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 2, 2))
    return np.clip(pts, -PATTERN_RADIUS, PATTERN_RADIUS).astype(np.float32)


PATTERN = _make_pattern()  # (256, 2, 2)

# Circular orientation patch: (31, 31) mask and its row / column offsets.
_yy, _xx = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1, -PATCH_RADIUS:PATCH_RADIUS + 1]
DISK = (_yy**2 + _xx**2 <= PATCH_RADIUS**2).astype(np.float32)
DISK_DR = _yy.astype(np.float32)
DISK_DC = _xx.astype(np.float32)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 fused multiply-add a * b + c (CUDA's
    __fmaf_rn), computed in f64; b is an f32 tensor or a Python float
    holding an f32 value.  The product of two f32 values is exact in f64,
    TwoSum gives the exact error of the f64 sum, and the one case where
    rounding that sum to f32 differs from rounding the exact value — the
    sum sits on an f32 midpoint while the error is nonzero — is resolved
    toward the error's side."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, float("inf"))
    o = torch.nextafter(r, torch.where(s > rd, inf, -inf))  # neighbour toward s
    od = o.double()
    tie = (s != rd) & (2.0 * s == rd + od)
    wrong = tie & (err != 0) & ((err > 0) == (od > rd))
    return torch.where(wrong, o, r)


def box_blur_reference(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Plain version: separable (2r+1)^2 box blur of an (H, W) f32 image
    or of each image of a (B, H, W) stack, edge-replicated, normalized.

    The JAX reference sums rows in ascending order and divides by k, then
    columns the same way; XLA on the CPU turns each division into a
    multiply by f32(1/k) and contracts the column pass into a fused
    multiply-add chain.  This is that chain:
    s = fma(R0, 1/k, R1 * 1/k), s = fma(Rj, 1/k, s) for j >= 2, s * 1/k.
    (Not K1's blur, which pads with zeros.)"""
    k = 2 * radius + 1
    inv = float(np.float32(1.0 / k))
    H, W = img.shape[-2:]
    stack = img if img.dim() == 3 else img[None]
    pad = torch.nn.functional.pad(stack, (radius,) * 4, mode="replicate")
    rows = pad[:, 0:H]
    for i in range(1, k):
        rows = rows + pad[:, i:i + H]
    s = _fma(rows[..., 0:W], inv, rows[..., 1:1 + W] * inv)
    for j in range(2, k):
        s = _fma(rows[..., j:j + W], inv, s)
    s = s * inv
    return s if img.dim() == 3 else s[0]


class BoxBlurKernel(CudaKernel):
    """The box blur, csrc/box_blur.cu."""

    # Radii the kernel takes, each compiled with the radius fixed: 2
    # (BRIEF, ORB, Harris / GFTT) and 7 (BRIEF256R's orientation map).
    radii = (2, 7)

    def __init__(self):
        super().__init__("box_blur", "box_blur.cu", "box_blur", "piiiip", "i")

    @staticmethod
    def sass_name(radius: int = 2) -> str:
        """A substring of the mangled name of the instantiation that takes
        `radius`."""
        return f"box_blur_kernelILi{radius}E"

    def _check_radius(self, radius: int) -> None:
        if radius not in self.radii:
            raise ValueError(f"box blur: radius {radius} on the card, which takes "
                             f"{self.radii}")

    def blocks_per_sm(self, device: torch.device, radius: int = 2) -> int:
        """Resident blocks of the kernel on one SM of `device` at `radius`."""
        self._check_radius(radius)
        return super().blocks_per_sm(device, radius)

    def launch(self, imgs: torch.Tensor, radius: int) -> torch.Tensor:
        """(B, H, W) contiguous f32 CUDA stack -> its (B, H, W) blurs."""
        if imgs.dtype != torch.float32 or imgs.dim() != 3 or not imgs.is_contiguous() \
                or imgs.device.type != "cuda":
            raise ValueError("box blur: imgs must be a contiguous (B, H, W) float32 CUDA "
                             "tensor")
        self._check_radius(radius)
        B, H, W = imgs.shape
        if B > 65535:
            raise ValueError(f"box blur: batch {B} over 65535 (the grid's z extent)")
        out = torch.empty_like(imgs)
        if out.numel() == 0:
            return out
        self._launch(imgs.device, B, imgs.data_ptr(), B, H, W, radius, out.data_ptr())
        return out


BOX_BLUR = BoxBlurKernel()


def box_blur(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Separable (2r+1)^2 box blur of an (H, W) f32 image or of each image
    of a (B, H, W) stack, edge-replicated, normalized (box_blur_reference's
    bits).  A CPU tensor runs the plain version; a contiguous f32 CUDA
    tensor launches the kernel once over the stack at radius 2 or 7, and
    any other CUDA tensor or radius raises ValueError."""
    if img.device.type == "cuda":
        out = BOX_BLUR.launch(img if img.dim() == 3 else img[None], radius)
        return out if img.dim() == 3 else out[0]
    if img.device.type != "cpu":
        raise ValueError(f"box blur: unsupported device {img.device}")
    return box_blur_reference(img, radius)


def _bilinear(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of an (H, W) image at float (r, c) of any shape,
    clamped to the image.  The weights multiply in the JAX package's
    order; a NaN coordinate reads pixel 0 and gives NaN, as there."""
    H, W = img.shape
    r = torch.clamp(r, 0.0, H - 1.001)
    c = torch.clamp(c, 0.0, W - 1.001)
    r0 = torch.floor(r)
    c0 = torch.floor(c)
    fr = r - r0
    fc = c - c0
    ri = torch.nan_to_num(r0).clamp(0, H - 2).to(torch.int64)
    ci = torch.nan_to_num(c0).clamp(0, W - 2).to(torch.int64)
    flat = img.reshape(-1)
    base = ri * W + ci
    i00 = flat[base]
    i01 = flat[base + 1]
    i10 = flat[base + W]
    i11 = flat[base + W + 1]
    return (i00 * (1 - fr) * (1 - fc) + i01 * (1 - fr) * fc
            + i10 * fr * (1 - fc) + i11 * fr * fc)


_CONSTS: dict = {}


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A module table on like's device, copied there on first use only
    (a copy from the host inside a frame would synchronize it)."""
    key = (id(a), like.device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.from_numpy(a).to(like.device)
    return _CONSTS[key]


def orientations(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation atan2(m01, m10) of each keypoint
    over the radius-15 disk.  uv: (K, 2) [col, row] f32; returns (K,)."""
    dr, dc, disk = (_const(a, img) for a in (DISK_DR, DISK_DC, DISK))
    c = uv[:, 0, None, None]
    r = uv[:, 1, None, None]
    vals = _bilinear(img, r + dr, c + dc) * disk  # (K, 31, 31)
    m10 = (vals * dc).sum(dim=(1, 2))
    m01 = (vals * dr).sum(dim=(1, 2))
    return torch.atan2(m01, m10)


def describe(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Packed 256-bit ORB256 descriptors: (H, W) f32 image, (K, 2)
    [col, row] keypoints -> (K, 8) int32.  Invalid keypoints give rows
    that the caller masks."""
    smooth = box_blur(img, radius=2)
    theta = orientations(smooth, uv)
    ct = torch.cos(theta)[:, None, None]
    st = torch.sin(theta)[:, None, None]
    pat = _const(PATTERN, img)
    dr = pat[None, :, :, 0]
    dc = pat[None, :, :, 1]
    dr_rot = st * dc + ct * dr  # (K, 256, 2)
    dc_rot = ct * dc - st * dr
    vals = _bilinear(smooth, uv[:, 1, None, None] + dr_rot, uv[:, 0, None, None] + dc_rot)
    return hamming.pack_bits((vals[..., 0] < vals[..., 1]).reshape(uv.shape[0], N_BITS))
