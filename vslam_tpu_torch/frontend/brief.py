"""Dense BRIEF-256 descriptors (port of vslam_tpu/frontend/brief.py).

Every pixel's descriptor is computed at once as eight int32 bit planes
of the 5x5 box-blurred image (kernels K2/K3, frontend/dense_brief.py);
a keypoint's descriptor is then an 8-word lookup (gather_descriptors).

BRIEF256R ("rotated banks") quantizes a dense gradient orientation into
N_ROT_BANKS bins and describes each keypoint from the planes of the
pattern pre-rotated into its bin (kernel K4, one launch per bank and
image).  The pattern tables are the JAX package's: `_PAT` and `_ROT_PATS`
come from the same numpy code.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_tpu_torch.frontend import dense_brief
from vslam_tpu_torch.frontend.dense_brief import N_ROT_BANKS
from vslam_tpu_torch.frontend.fast_brief import PATTERN as _PAT  # noqa: F401
from vslam_tpu_torch.frontend.fast_brief import gather_descriptors
from vslam_tpu_torch.frontend.orb import box_blur

_ROT_PATS = dense_brief.ROT_PATS  # (16, 256, 2, 2) int32


def dense_planes(img: torch.Tensor) -> torch.Tensor:
    """(H, W) raw image -> (8, H, W) int32 planes of its blur (K3)."""
    return dense_brief.dense_bit_planes(box_blur(img, 2))


def dense_planes_batch(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) raw images -> (B, 8, H, W) int32 planes of their blurs,
    one K2 launch (a stereo pair, or a split chunk's 2k images).  Kept
    for landmark recovery, which re-describes arbitrary pixel positions.
    The stack is blurred in one call (one box-blur launch on the card)."""
    return dense_brief.dense_bit_planes_batch(box_blur(imgs, 2))


def dense_planes_pair(img_l: torch.Tensor, img_r: torch.Tensor) -> torch.Tensor:
    """Stereo pair -> (2, 8, H, W) int32 planes, one K2 launch."""
    return dense_planes_batch(torch.stack([img_l, img_r]))


def describe_dense(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(K, 8) int32 descriptors at (rounded) keypoint coordinates."""
    return gather_descriptors(dense_planes(img), img.shape, uv)


def _dense_bit_planes_bank(smooth: torch.Tensor, bank: int) -> torch.Tensor:
    """(H, W) SMOOTHED image -> (8, H, W) planes under bank's rotation (K4)."""
    return dense_brief.dense_bit_planes_pattern(smooth, bank)


def orientation_bin_map(smooth: torch.Tensor, n_banks: int = N_ROT_BANKS,
                        grad_radius: int = 7) -> torch.Tensor:
    """(H, W) int32 orientation bins from heavily smoothed gradients.  The
    central differences wrap at the image edges (jnp.roll); both gradients
    are blurred in one call (one box-blur launch on the card)."""
    gx = 0.5 * (torch.roll(smooth, -1, 1) - torch.roll(smooth, 1, 1))
    gy = 0.5 * (torch.roll(smooth, -1, 0) - torch.roll(smooth, 1, 0))
    sy, sx = box_blur(torch.stack([gy, gx]), grad_radius)
    theta = torch.atan2(sy, sx)
    b = torch.round(theta * (n_banks / (2.0 * np.pi))).to(torch.int32)
    return torch.remainder(b, n_banks)


def describe_dense_rotated(img: torch.Tensor, uv: torch.Tensor,
                           n_banks: int = N_ROT_BANKS) -> torch.Tensor:
    """Oriented (K, 8) int32 descriptors at keypoints via the rotated
    pattern banks; img is the RAW (H, W) image."""
    smooth = box_blur(img, 2)
    kp_bins = gather_descriptors(orientation_bin_map(smooth, n_banks)[None],
                                 img.shape, uv)[:, 0]
    desc = torch.zeros((uv.shape[0], 8), dtype=torch.int32, device=img.device)
    for b in range(n_banks):
        d_b = gather_descriptors(_dense_bit_planes_bank(smooth, b), img.shape, uv)
        desc = torch.where((kp_bins == b)[:, None], d_b, desc)
    return desc
