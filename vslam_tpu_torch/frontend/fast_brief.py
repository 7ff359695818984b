"""The fused FAST/BRIEF front-end: kernel K1 and its plain-torch version.

One pass over a stack of raw images (a stereo pair is B=2) computes
  * (B, 8, H, W) int32 packed BRIEF-256 bit planes of the 5x5 box-blurred
    image (descriptors of any pixel are then an 8-word lookup),
  * (B, H, W) f32 FAST-9/16 (or FAST-12) scores after 3x3 NMS,
  * (B, ceil(H/16), Wo) per-column (max, first row) of the NMS'd scores
    over each 16-row band, border- and bin-crop-masked, Wo = round_up(W,
    128) — the input of the keypoint binning tail
    (keypoints_from_band_reduction).

Port of vslam_tpu/frontend/pallas_frontend.py (TPU kernel
fast_brief_frontend_pair).  Semantics: the image is zero outside its
bounds (the TPU kernel's zero halo); interior pixels (>= 16 px from the
edge) agree bit for bit with the TPU kernel, and the CUDA kernel
(csrc/fast_brief_frontend.cu) agrees bit for bit with the plain version
over the whole image.

`fast_brief_frontend_pair` runs the plain version for a CPU tensor and
launches the CUDA kernel for a CUDA tensor; there is no fallback between
the two.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vslam_tpu_torch.frontend.orb import PATTERN_RADIUS, _fma, _make_pattern
from vslam_tpu_torch.ops.cuda_build import CudaKernel

BAND = 16  # output rows per band (= the band tail's bin size)
LANE = 128  # column tile; the band reduction is Wo = round_up(W, 128) wide

# Bresenham circle of radius 3, clockwise from 12 o'clock: (row, col).
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

# Integer BRIEF offsets (brief._PAT): (256, 2, 2) [bit, point, (dr, dc)].
PATTERN = np.round(_make_pattern()).astype(np.int32)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def pack_brief_words(padded: torch.Tensor, pattern: np.ndarray, H: int,
                     W: int) -> torch.Tensor:
    """(B, 8, H, W) int32 BRIEF words of a smoothed stack: bit j of word w
    is [S(x + o1) < S(x + o2)] for pair 32 w + j of `pattern` (256, 2, 2).
    `padded` (B, H + 26, W + 26) holds S with a 13-px margin on each side
    (padded[:, 13 + r, 13 + c] = S(r, c))."""
    R = PATTERN_RADIUS
    B = padded.shape[0]
    words = []
    for w in range(8):
        word = torch.zeros((B, H, W), dtype=torch.int64, device=padded.device)
        for j in range(32):
            (dr1, dc1), (dr2, dc2) = pattern[w * 32 + j]
            a = padded[:, R + dr1:R + dr1 + H, R + dc1:R + dc1 + W]
            c = padded[:, R + dr2:R + dr2 + H, R + dc2:R + dc2 + W]
            word = word | ((a < c).to(torch.int64) << j)
        words.append(torch.where(word >= 1 << 31, word - (1 << 32), word))
    return torch.stack(words, dim=1).to(torch.int32)


def _arc(m: torch.Tensor, arc_len: int) -> torch.Tensor:
    """A cyclic run of >= arc_len set bits in each 16-bit ring mask (int64)."""
    M = m | (m << 16)
    a = M & (M >> 1)
    a = a & (a >> 2)
    a = a & (a >> 4)  # runs >= 8
    if arc_len == 9:
        a = a & (M >> 8)
    else:  # FAST-12: bits i..i+7 and a run of 4 at i+8
        a4 = M & (M >> 1)
        a4 = a4 & (a4 >> 2)
        a = a & (a4 >> 8)
    return (a & 0xFFFF) != 0


def fast_brief_frontend_pair_reference(
    imgs: torch.Tensor,
    threshold: torch.Tensor,
    *,
    arc_len: int = 9,
    border: int = 20,
    bin_size: int = 16,
):
    """Plain-torch K1 on any device: same outputs, same zero-halo
    semantics and the same order of every float sum as the CUDA kernel."""
    B, H, W = imgs.shape
    dev = imgs.device
    f32 = torch.float32
    fifth = torch.full((), 0.2, dtype=f32, device=dev)  # np.float32(1/5)
    P = torch.nn.functional.pad(imgs.to(f32), (16, 16, 16, 16))  # P[r+16, c+16]

    # Box blur of the zero-extended image over rows -13..H+12, cols
    # -13..W+12 (BRIEF taps reach +-13).  Rows: A = sum of 5 rows,
    # ascending.  Columns: the reference's "sum of (A * 0.2f), ascending,
    # then * 0.2f", in the contracted form the JAX reference computes it
    # in: s = fma(A0, .2f, A1 * .2f), s = fma(Ad, .2f, s) for d = 2..4.
    Hs, Ws = H + 26, W + 26
    acc = P[:, 1:1 + Hs, 1:W + 31]
    for d in range(1, 5):
        acc = acc + P[:, 1 + d:1 + d + Hs, 1:W + 31]  # rows -13.., cols -15..
    s = _fma(acc[:, :, 0:Ws], fifth, acc[:, :, 1:1 + Ws] * fifth)
    for d in range(2, 5):
        s = _fma(acc[:, :, d:d + Ws], fifth, s)
    smooth = s * fifth  # (B, Hs, Ws): rows -13.., cols -13..

    planes = pack_brief_words(smooth, PATTERN, H, W)

    # FAST on the raw image over rows -1..H, cols -1..W (the NMS halo).
    def ring(dr, dc):
        return P[:, 15 + dr:15 + dr + H + 2, 15 + dc:15 + dc + W + 2]

    center = ring(0, 0)
    t = threshold.to(f32)
    hi = center + t
    lo = center - t
    mb = torch.zeros(center.shape, dtype=torch.int64, device=dev)
    md = torch.zeros_like(mb)
    bright = torch.zeros_like(center)
    dark = torch.zeros_like(center)
    for kk in range(16):
        v = ring(int(CIRCLE[kk, 0]), int(CIRCLE[kk, 1]))
        mb = mb | ((v > hi).to(torch.int64) << kk)
        md = md | ((v < lo).to(torch.int64) << kk)
        bright = bright + torch.clamp(v - hi, min=0.0)
        dark = dark + torch.clamp(lo - v, min=0.0)
    corner = _arc(mb, arc_len) | _arc(md, arc_len)
    fscore = torch.where(corner, torch.maximum(bright, dark), 0.0)

    # 3x3 NMS: keep the score where it is >= its neighbourhood max.
    colmax = torch.maximum(torch.maximum(fscore[:, :, 0:W], fscore[:, :, 1:W + 1]),
                           fscore[:, :, 2:W + 2])
    neigh = torch.maximum(torch.maximum(colmax[:, 0:H], colmax[:, 1:H + 1]),
                          colmax[:, 2:H + 2])
    mid = fscore[:, 1:H + 1, 1:W + 1]
    score = torch.where(mid >= neigh, mid, 0.0)

    # Band reduction over the border / bin-crop mask.
    Hb, Wo = _round_up(H, BAND), _round_up(W, LANE)
    Hc = (H // bin_size) * bin_size
    Wc = (W // bin_size) * bin_size
    rows = torch.arange(Hb, device=dev)[:, None]
    cols = torch.arange(Wo, device=dev)[None, :]
    inside = ((rows >= border) & (rows < min(H - border, Hc))
              & (cols >= border) & (cols < min(W - border, Wc)))
    full = torch.nn.functional.pad(score, (0, Wo - W, 0, Hb - H))
    masked = torch.where(inside, full, 0.0).reshape(B, Hb // BAND, BAND, Wo)
    rowmax = masked.amax(dim=2)
    local = torch.arange(BAND, dtype=torch.int32, device=dev)[:, None]
    rowarg = torch.where(masked >= rowmax[:, :, None], local, BAND).amin(dim=2)
    return planes, score, rowmax, rowarg


# ---------------------------------------------------------------------------
# CUDA kernel (ops/cuda_build.CudaKernel)
# ---------------------------------------------------------------------------

class FastBriefKernel(CudaKernel):
    """K1, csrc/fast_brief_frontend.cu."""

    # The kernel's SASS function name (a substring of the mangled name).
    sass_name = "fast_brief_tile_kernel"

    def __init__(self):
        super().__init__("K1", "fast_brief_frontend.cu", "fast_brief_frontend",
                         "ppiiiiiipppp")

    def launch(self, imgs: torch.Tensor, threshold: torch.Tensor, arc_len: int,
               border: int, bin_size: int):
        if imgs.dtype != torch.float32 or imgs.dim() != 3 or not imgs.is_contiguous():
            raise ValueError("K1: imgs must be a contiguous (B, H, W) float32 tensor")
        if threshold.dtype != torch.float32 or threshold.numel() != 1 \
                or threshold.device != imgs.device:
            raise ValueError("K1: threshold must be one float32 on the images' device")
        if arc_len not in (9, 12):
            raise ValueError(f"K1: arc_len {arc_len} (9 or 12)")
        B, H, W = imgs.shape
        dev = imgs.device
        Wo, n_bands = _round_up(W, LANE), -(-H // BAND)
        planes = torch.empty((B, 8, H, W), dtype=torch.int32, device=dev)
        score = torch.empty((B, H, W), dtype=torch.float32, device=dev)
        rowmax = torch.empty((B, n_bands, Wo), dtype=torch.float32, device=dev)
        rowarg = torch.empty((B, n_bands, Wo), dtype=torch.int32, device=dev)
        thr = threshold.reshape(1).contiguous()
        self._launch(dev, B, imgs.data_ptr(), thr.data_ptr(), B, H, W, arc_len, border,
                     bin_size, planes.data_ptr(), score.data_ptr(), rowmax.data_ptr(),
                     rowarg.data_ptr())
        return planes, score, rowmax, rowarg


K1 = FastBriefKernel()


def fast_brief_frontend_pair(
    imgs: torch.Tensor,
    threshold: torch.Tensor,
    *,
    arc_len: int = 9,
    border: int = 20,
    bin_size: int = 16,
):
    """Fused front-end for an image stack.

    imgs: (B, H, W) f32 raw images; threshold: f32 scalar tensor (FAST).
    Returns (planes (B, 8, H, W) int32, score (B, H, W) f32 NMS'd,
    rowmax (B, n_bands, Wo) f32, rowarg (B, n_bands, Wo) int32).
    A CPU tensor runs the plain version; a CUDA tensor launches K1.  B is
    at most 65535, the extent of the kernel's grid in z, on both."""
    if not 1 <= imgs.shape[0] <= 65535:
        raise ValueError(f"K1: batch {imgs.shape[0]} outside 1..65535 (the grid's z extent)")
    threshold = torch.as_tensor(threshold, dtype=torch.float32, device=imgs.device)
    if imgs.device.type == "cuda":
        return K1.launch(imgs.contiguous(), threshold, arc_len, border, bin_size)
    if imgs.device.type != "cpu":
        raise ValueError(f"K1: unsupported device {imgs.device}")
    return fast_brief_frontend_pair_reference(
        imgs, threshold, arc_len=arc_len, border=border, bin_size=bin_size
    )


# ---------------------------------------------------------------------------
# Binning tail and descriptor lookup (plain torch on every device)
# ---------------------------------------------------------------------------


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set of one image (SoA, masked)."""

    uv: torch.Tensor  # (K, 2) f32 [u=col, v=row], level-0 coordinates
    score: torch.Tensor  # (K,) f32 detector response
    valid: torch.Tensor  # (K,) bool
    octave: torch.Tensor = None  # (K,) int32 pyramid level (0 = full res)


def keypoints_from_band_reduction(rowmax: torch.Tensor, rowarg: torch.Tensor,
                                  H: int, W: int, bin_size: int, capacity: int):
    """Per-bin argmax + top-K over the band reduction of a batch of images.

    rowmax/rowarg: (B, n_bands, Wo).  Bins are 16x16 cells; inside a cell
    equal scores resolve to the smallest row, then the smallest column, and
    equal cell scores to the lower cell index (lax.top_k's order — a stable
    descending sort).  Returns (uv (B, K, 2) f32, score (B, K), valid
    (B, K) bool)."""
    if bin_size != BAND:
        raise NotImplementedError(f"band reduction needs bin_size {BAND}")
    B, n_bands, Wo = rowmax.shape
    groups = Wo // bin_size
    gm = rowmax.reshape(B, n_bands, groups, bin_size)
    cell_score = gm.amax(dim=3)
    col_iota = torch.arange(bin_size, dtype=torch.int32, device=rowmax.device)
    cell_col = torch.where(gm >= cell_score[..., None], col_iota, bin_size).amin(dim=3)
    flat_score = cell_score.reshape(B, -1)
    n_cells = flat_score.shape[1]
    k = min(capacity, n_cells)
    top_score, top_cell = torch.sort(flat_score, dim=1, descending=True, stable=True)
    top_score, top_cell = top_score[:, :k], top_cell[:, :k]
    cell_r = top_cell // groups
    cell_c = top_cell % groups
    u = cell_c * bin_size + torch.gather(cell_col.reshape(B, -1), 1, top_cell)
    v = cell_r * BAND + torch.gather(rowarg.reshape(B, -1), 1, cell_r * Wo + u)
    uv = torch.stack([u, v], dim=2).to(torch.float32)
    valid = top_score > 0.0
    if k < capacity:
        pad = capacity - k
        uv = torch.nn.functional.pad(uv, (0, 0, 0, pad))
        top_score = torch.nn.functional.pad(top_score, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return uv, top_score, valid


def gather_descriptors(planes: torch.Tensor, shape, uv: torch.Tensor) -> torch.Tensor:
    """Descriptors at (rounded, clipped) pixel coordinates: planes (8, H, W)
    int32, uv (K, 2) [col, row] -> (K, 8) int32."""
    H, W = shape
    c = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W - 1)
    r = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H - 1)
    return planes[:, r, c].T
