"""BRIEF test pattern and box blur (port of the subset of
vslam_tpu/frontend/orb.py that the dense BRIEF descriptors use).

The rotation-aware gather descriptor `describe` (descriptor_type ORB256)
is not ported yet (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import numpy as np
import torch

PATTERN_RADIUS = 13  # BRIEF pattern extent
N_BITS = 256


def _make_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) [pair, point, (dr, dc)] Gaussian BRIEF pattern, clipped."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATTERN_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 2, 2))
    return np.clip(pts, -PATTERN_RADIUS, PATTERN_RADIUS).astype(np.float32)


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


def box_blur(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Separable (2r+1)^2 box blur of an (H, W) f32 image, edge-replicated,
    normalized.

    The JAX reference sums rows in ascending order and divides by k, then
    columns the same way; XLA on the CPU turns each division into a
    multiply by f32(1/k) and contracts the column pass into a fused
    multiply-add chain.  This is that chain:
    s = fma(R0, 1/k, R1 * 1/k), s = fma(Rj, 1/k, s) for j >= 2, s * 1/k.
    (Not K1's blur, which pads with zeros.)"""
    k = 2 * radius + 1
    inv = float(np.float32(1.0 / k))
    H, W = img.shape
    pad = torch.nn.functional.pad(img[None], (radius,) * 4, mode="replicate")[0]
    rows = pad[0:H]
    for i in range(1, k):
        rows = rows + pad[i:i + H]
    s = _fma(rows[:, 0:W], inv, rows[:, 1:1 + W] * inv)
    for j in range(2, k):
        s = _fma(rows[:, j:j + W], inv, s)
    return s * inv
