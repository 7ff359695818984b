"""Keypoint detection over an image pyramid (port of
vslam_tpu/frontend/detect.py).

Whole-image array program: a detector's score map -> 3x3 NMS -> border
mask -> per-cell argmax over a bin_size grid -> global top-K to a fixed
capacity, per pyramid octave, with coordinates mapped back to level 0.
The detectors: FAST-9/16 and FAST-12 (AGAST maps onto FAST-9), Harris,
Shi-Tomasi (GFTT), difference of Gaussians (DOG, also SIFT) and the
nonlinear-diffusion KAZE (also AKAZE).  `detect_keypoints` takes one
image or a (B, H, W) stack: each pyramid level is made once for the
stack, and the FAST family's score, NMS, border mask and per-cell argmax
are one launch of a level's whole stack on the card (`fast_cells`,
csrc/fast_cells.cu); the float detectors score image by image.

Exactness against the JAX package on the CPU: FAST is bit-exact.  The
float detectors are not: XLA-CPU contracts and orders the blurs' sums in
its own way, and no order written here reproduces its
`conv_general_dilated`, so their score maps agree to a tolerance and
their keypoints nearly always (tests/test_torch_detect.py).  Every blur
is written as shifted sums (no convolution call: cuDNN would choose its
own algorithm and, by default, TF32).
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_tpu_torch.frontend.fast_brief import CIRCLE, Keypoints, _arc
from vslam_tpu_torch.frontend.orb import box_blur
from vslam_tpu_torch.ops.cuda_build import CudaKernel

ARC_LEN = 9
# The FAST family and its arc lengths (AGAST scores as FAST-9).
FAST_ARCS = {"FAST": 9, "FAST9": 9, "AGAST": 9, "FAST12": 12}


def _ring_taps(img: torch.Tensor) -> list:
    """The 16 circle neighbours of every pixel of an (..., H, W) stack,
    zero outside the image: views of one zero-padded copy."""
    H, W = img.shape[-2:]
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    return [p[..., 3 + int(dr):3 + int(dr) + H, 3 + int(dc):3 + int(dc) + W]
            for dr, dc in CIRCLE]


def fast_score_map(img: torch.Tensor, threshold: torch.Tensor,
                   arc_len: int = ARC_LEN) -> torch.Tensor:
    """Per-pixel FAST-N/16 corner score of an (H, W) image or a (B, H, W)
    stack (summed threshold excess of the winning polarity, in ring
    order); 0 where not a corner."""
    hi = img + threshold
    lo = img - threshold
    mb = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    md = torch.zeros_like(mb)
    bright = torch.zeros_like(img)
    dark = torch.zeros_like(img)
    for kk, v in enumerate(_ring_taps(img)):
        mb = mb | ((v > hi).to(torch.int64) << kk)
        md = md | ((v < lo).to(torch.int64) << kk)
        bright = bright + torch.clamp(v - hi, min=0.0)
        dark = dark + torch.clamp(lo - v, min=0.0)
    corner = _arc(mb, arc_len) | _arc(md, arc_len)
    return torch.where(corner, torch.maximum(bright, dark), 0.0)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA's: through f64 (exact
    after the second rounding).  torch's own f32 sqrt on the CPU is not
    correctly rounded (its AVX-512 path)."""
    return torch.sqrt(x.double()).float()


def _structure_tensor(img: torch.Tensor, radius: int = 2):
    """Box-blurred gradient products (A = IxIx, B = IxIy, C = IyIy) of
    the image scaled to [0, 1]; central differences, the wrapped border
    rows and columns zeroed."""
    x = img * (1.0 / 255.0)
    Ix = 0.5 * (torch.roll(x, -1, 1) - torch.roll(x, 1, 1))
    Iy = 0.5 * (torch.roll(x, -1, 0) - torch.roll(x, 1, 0))
    Ix[:, 0].zero_()
    Ix[:, -1].zero_()
    Iy[0, :].zero_()
    Iy[-1, :].zero_()
    return (box_blur(Ix * Ix, radius), box_blur(Ix * Iy, radius),
            box_blur(Iy * Iy, radius))


# Scales putting typical strong-corner responses into the ~5-100 range of
# the FAST threshold controller.
_HARRIS_SCALE = 5.0e4
_GFTT_SCALE = 5.0e3


def harris_score_map(img: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Harris response det(M) - 0.04 trace(M)^2, 0 at or below the
    threshold."""
    A, B, C = _structure_tensor(img)
    det = A * C - B * B
    tr = A + C
    score = (det - 0.04 * tr * tr) * _HARRIS_SCALE
    return torch.where(score > threshold, score, 0.0)


def gftt_score_map(img: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Shi-Tomasi (good features to track) minimum-eigenvalue response."""
    A, B, C = _structure_tensor(img)
    half_tr = 0.5 * (A + C)
    d = A - C
    rad = _sqrt(torch.clamp(0.25 * (d * d) + B * B, min=0.0))
    score = (half_tr - rad) * _GFTT_SCALE
    return torch.where(score > threshold, score, 0.0)


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    radius = int(np.ceil(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _taps(x: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    """Zero-padded correlation of x with the 1-D kernel k along dim, as
    shifted sums in ascending tap order."""
    n = len(k)
    H, W = x.shape
    if dim == 1:
        p = torch.nn.functional.pad(x, (n // 2, n // 2))
        views = [p[:, t:t + W] for t in range(n)]
    else:
        p = torch.nn.functional.pad(x, (0, 0, n // 2, n // 2))
        views = [p[t:t + H] for t in range(n)]
    out = views[0] * float(k[0])
    for t in range(1, n):
        out = out + views[t] * float(k[t])
    return out


def gauss_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) f32 image (radius ceil(3
    sigma), zero outside the image): rows, then columns."""
    k = _gauss_kernel1d(sigma)
    return _taps(_taps(img, k, 1), k, 0)


def _window_max(x: torch.Tensor, size) -> torch.Tensor:
    """Max over a centred window of a (S, H, W) stack, -inf outside (the
    JAX package's reduce_window "SAME")."""
    pad = tuple(s // 2 for s in size)
    return torch.nn.functional.max_pool3d(x[None, None], size, stride=1, padding=pad)[0, 0]


# DoG contrast (8-bit units) -> the detector-threshold range, and the
# intra-octave scale ladder (k = 2^(1/2), 5 levels -> 4 DoG bands, extrema
# on the 2 interior bands).
_DOG_SCALE = 12.0
_DOG_SIGMAS = (1.0, 1.414, 2.0, 2.828, 4.0)


def dog_score_map(img: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Difference-of-Gaussians scale-space extremum response: a pixel
    scores |D| where it is a 3x3x3 extremum of the DoG stack on an
    interior band and passes SIFT's edge test (principal-curvature ratio
    r = 10)."""
    g = [gauss_blur(img, s) for s in _DOG_SIGMAS]
    D = torch.stack([g[i + 1] - g[i] for i in range(len(g) - 1)])  # (S, H, W)
    maxn = _window_max(D, (3, 3, 3))
    minn = -_window_max(-D, (3, 3, 3))
    is_ext = ((D >= maxn) & (D > 0)) | ((D <= minn) & (D < 0))
    Dxx = torch.roll(D, -1, 2) + torch.roll(D, 1, 2) - 2.0 * D
    Dyy = torch.roll(D, -1, 1) + torch.roll(D, 1, 1) - 2.0 * D
    Dxy = 0.25 * (
        torch.roll(torch.roll(D, -1, 1), -1, 2)
        + torch.roll(torch.roll(D, 1, 1), 1, 2)
        - torch.roll(torch.roll(D, -1, 1), 1, 2)
        - torch.roll(torch.roll(D, 1, 1), -1, 2)
    )
    tr = Dxx + Dyy
    det = Dxx * Dyy - Dxy * Dxy
    r = 10.0
    not_edge = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    score = torch.where(is_ext & not_edge, torch.abs(D) * _DOG_SCALE, 0.0)
    score = score[1:-1].amax(dim=0)
    return torch.where(score > threshold, score, 0.0)


# KAZE: the image evolves by Perona-Malik diffusion dL/dt = div(g grad L),
# integrated by Fast Explicit Diffusion cycles with the tau ladder
# tau_j = tau_max / (2 cos^2(pi (2j+1) / (4n+2))); keypoints are extrema
# of the scale-normalized Hessian determinant over the evolution ladder
# t = sigma^2 / 2.
_KAZE_SIGMAS = (1.6, 2.26, 3.2, 4.53, 6.4)
_KAZE_SCALE = 4.0e4


def _fed_tau_ladder(n: int, tau_max: float = 0.25) -> np.ndarray:
    j = np.arange(n, dtype=np.float64)
    return (tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
            ).astype(np.float32)


def _fed_steps_for_time(T: float, tau_max: float = 0.25) -> int:
    """Smallest n with cycle time tau_max * n(n+1)/3 >= T."""
    n = 1
    while tau_max * n * (n + 1) / 3.0 < T:
        n += 1
    return n


def _grad_xy(L: torch.Tensor):
    """Central differences, the wrapped border columns / rows zeroed."""
    gx = 0.5 * (torch.roll(L, -1, 1) - torch.roll(L, 1, 1))
    gy = 0.5 * (torch.roll(L, -1, 0) - torch.roll(L, 1, 0))
    gx[:, 0].zero_()
    gx[:, -1].zero_()
    gy[0, :].zero_()
    gy[-1, :].zero_()
    return gx, gy


def _diffusion_substep(L: torch.Tensor, g: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit step of div(g grad L): face conductivities the mean
    of the two cells', zero flux through the image border."""

    def flux(axis, direction):
        f = 0.5 * (g + torch.roll(g, -direction, axis)) * (torch.roll(L, -direction, axis) - L)
        edge = -1 if direction == 1 else 0
        if axis == 0:
            f[edge, :].zero_()
        else:
            f[:, edge].zero_()
        return f

    div = flux(1, 1) + flux(1, -1) + flux(0, 1) + flux(0, -1)
    return L + tau * div


def _kaze_contrast_k(L: torch.Tensor, percentile: float = 0.7) -> torch.Tensor:
    """KAZE's contrast factor: the percentile of the nonzero gradient
    magnitudes of the 1-sigma-blurred image, from a 64-bin histogram (an
    integer count, the same on every run)."""
    gx, gy = _grad_xy(gauss_blur(L, 1.0))
    mag = _sqrt(gx * gx + gy * gy)
    mmax = torch.clamp(mag.max(), min=1e-6)
    bins = torch.clamp((mag / mmax * 64.0).to(torch.int32), 0, 63)
    hist = torch.zeros(64, dtype=torch.int64, device=L.device).index_add_(
        0, bins.reshape(-1).to(torch.int64), (mag > 1e-6).reshape(-1).to(torch.int64))
    hist[0].zero_()
    total = torch.clamp(hist.sum(), min=1)
    c = torch.cumsum(hist, 0)
    kbin = (c < (percentile * total.to(torch.float32)).to(torch.int64)).sum()
    return torch.clamp((kbin.to(torch.float32) + 0.5) / 64.0 * mmax, min=1e-3)


def kaze_score_map(img: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Nonlinear-diffusion scale-space Hessian response: a pixel scores
    where the scale-normalized Hessian determinant of an interior
    evolution level is a positive 3x3 spatial maximum (derivative step d
    ~ sigma / 1.6), max over the interior levels."""
    x = img.to(torch.float32) * (1.0 / 255.0)
    L = gauss_blur(x, _KAZE_SIGMAS[0])
    k = _kaze_contrast_k(x)
    k2 = k * k
    levels = [L]
    t_prev = _KAZE_SIGMAS[0] ** 2 / 2.0
    for sigma in _KAZE_SIGMAS[1:]:
        t = sigma ** 2 / 2.0
        taus = _fed_tau_ladder(_fed_steps_for_time(t - t_prev))
        # Perona-Malik g2 conductivity, frozen for the cycle.
        gx, gy = _grad_xy(gauss_blur(L, 1.0))
        g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
        for tau in taus:
            L = _diffusion_substep(L, g, float(tau))
        levels.append(L)
        t_prev = t

    resp = []
    for sigma, Li in zip(_KAZE_SIGMAS, levels):
        d = max(1, int(round(sigma / 1.6)))

        def dstep(L, axis, dd=d):
            return (torch.roll(L, -dd, axis) - torch.roll(L, dd, axis)) * (0.5 / dd)

        Lx = dstep(Li, 1)
        Ly = dstep(Li, 0)
        Lxx = dstep(Lx, 1)
        Lxy = dstep(Lx, 0)
        Lyy = dstep(Ly, 0)
        resp.append((sigma ** 2) ** 2 * (Lxx * Lyy - Lxy * Lxy))
    D = torch.stack(resp)  # (S, H, W)
    is_ext = (D >= _window_max(D, (1, 3, 3))) & (D > 0)
    score = torch.where(is_ext, D * _KAZE_SCALE, 0.0)
    score = score[1:-1].amax(dim=0)
    return torch.where(score > threshold, score, 0.0)


def score_map(img: torch.Tensor, threshold: torch.Tensor, detector: str) -> torch.Tensor:
    """The detector registry (the reference's pluggable detector, chosen
    by detector_type): AGAST scores as FAST-9, SHI_TOMASI as GFTT, SIFT
    as DOG (io/config.py maps it) and AKAZE as KAZE."""
    d = detector.upper()
    if d in FAST_ARCS:
        return fast_score_map(img, threshold, arc_len=FAST_ARCS[d])
    if d == "HARRIS":
        return harris_score_map(img, threshold)
    if d in ("GFTT", "SHI_TOMASI"):
        return gftt_score_map(img, threshold)
    if d == "DOG":
        return dog_score_map(img, threshold)
    if d in ("KAZE", "AKAZE"):
        return kaze_score_map(img, threshold)
    raise ValueError(f"unknown detector '{detector}' "
                     "(FAST|FAST12|AGAST|HARRIS|GFTT|DOG|KAZE|AKAZE)")


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression of an (H, W) map or a (B, H, W) stack
    (the window is -inf outside the image)."""
    x = score.reshape((-1, 1) + score.shape[-2:])
    neigh = torch.nn.functional.max_pool2d(x, 3, stride=1, padding=1).reshape(score.shape)
    return torch.where(score >= neigh, score, 0.0)


def cells_from_score(score: torch.Tensor, bin_size: int, border: int):
    """Border mask and per-cell argmax over a (B, H, W) stack of NMS'd
    score maps: (cell_score (B, cells) f32, cell_best (B, cells) int32)
    over the (H // bin_size) x (W // bin_size) grid, row-major; a cell's
    best is the first index (lowest row, then column) holding its max."""
    B, H, W = score.shape
    dev = score.device
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    inside = ((rows >= border) & (rows < H - border)
              & (cols >= border) & (cols < W - border))
    score = torch.where(inside, score, 0.0)

    nr, nc = H // bin_size, W // bin_size
    sc = (score[:, :nr * bin_size, :nc * bin_size]
          .reshape(B, nr, bin_size, nc, bin_size).permute(0, 1, 3, 2, 4)
          .reshape(B, nr * nc, bin_size * bin_size))
    cell_score = sc.amax(dim=2)
    iota = torch.arange(bin_size * bin_size, dtype=torch.int32, device=dev)
    cell_best = torch.where(sc >= cell_score[..., None], iota, bin_size * bin_size).amin(dim=2)
    return cell_score, cell_best


def keypoints_from_cells(cell_score: torch.Tensor, cell_best: torch.Tensor, cells_w: int,
                         bin_size: int, capacity: int):
    """Top-K cells of each image of a batch (lower cell index first on
    ties, as lax.top_k: a stable descending sort) and their best pixels.
    Returns (uv (B, K, 2) f32 level-local [col, row], score (B, K),
    valid (B, K))."""
    k = min(capacity, cell_score.shape[1])
    top_score, top_cell = torch.sort(cell_score, dim=1, descending=True, stable=True)
    top_score, top_cell = top_score[:, :k], top_cell[:, :k]
    best = torch.gather(cell_best, 1, top_cell)
    v = (top_cell // cells_w) * bin_size + best // bin_size
    u = (top_cell % cells_w) * bin_size + best % bin_size
    uv = torch.stack([u, v], dim=2).to(torch.float32)
    valid = top_score > 0.0
    if k < capacity:
        pad = capacity - k
        uv = torch.nn.functional.pad(uv, (0, 0, 0, pad))
        top_score = torch.nn.functional.pad(top_score, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return uv, top_score, valid


def keypoints_from_score(score: torch.Tensor, bin_size: int, capacity: int,
                         border: int):
    """Binning tail over an NMS'd (H, W) score map: border mask -> per-cell
    argmax (first index on ties: lowest row, then column) -> top-K cells
    (lower cell index first on ties, as lax.top_k).  Returns (uv (K, 2)
    f32 level-local [col, row], score (K,), valid (K,))."""
    cell_score, cell_best = cells_from_score(score[None], bin_size, border)
    uv, top_score, valid = keypoints_from_cells(cell_score, cell_best,
                                                score.shape[1] // bin_size, bin_size, capacity)
    return uv[0], top_score[0], valid[0]


# ---------------------------------------------------------------------------
# The FAST family's cells of a whole level: CUDA kernel and plain version
# ---------------------------------------------------------------------------


def fast_cells_reference(imgs: torch.Tensor, threshold: torch.Tensor, arc_len: int = ARC_LEN,
                         border: int = 20, bin_size: int = 16):
    """Plain version of the kernel, on any device: FAST score, 3x3 NMS,
    border mask and per-cell argmax of every image of a (B, H, W) stack
    (cells_from_score's outputs)."""
    return cells_from_score(nms3(fast_score_map(imgs, threshold, arc_len)), bin_size, border)


class FastCellsKernel(CudaKernel):
    """The staged FAST detector, csrc/fast_cells.cu."""

    # The kernel's SASS function name (a substring of the mangled name).
    sass_name = "fast_cells_kernel"
    # Bin sizes the kernel takes (a block holds a strip of whole cells).
    max_bin = 128

    def __init__(self):
        super().__init__("fast_cells", "fast_cells.cu", "fast_cells", "ppiiiiiipp", "i")

    def blocks_per_sm(self, device: torch.device, bin_size: int = 16) -> int:
        """Resident blocks of the kernel on one SM of `device` at `bin_size`."""
        return super().blocks_per_sm(device, bin_size)

    def launch(self, imgs: torch.Tensor, threshold: torch.Tensor, arc_len: int, border: int,
               bin_size: int):
        if imgs.dtype != torch.float32 or imgs.dim() != 3 or not imgs.is_contiguous():
            raise ValueError("FAST cells: imgs must be a contiguous (B, H, W) float32 tensor")
        if threshold.dtype != torch.float32 or threshold.numel() != 1 \
                or threshold.device != imgs.device:
            raise ValueError("FAST cells: threshold must be one float32 on the images' device")
        if arc_len not in (9, 12):
            raise ValueError(f"FAST cells: arc_len {arc_len} (9 or 12)")
        if not 1 <= bin_size <= self.max_bin:
            raise ValueError(f"FAST cells: bin_size {bin_size} outside 1..{self.max_bin}")
        B, H, W = imgs.shape
        if B > 65535:
            raise ValueError(f"FAST cells: batch {B} over 65535 (the grid's z extent)")
        dev = imgs.device
        cells = (H // bin_size) * (W // bin_size)
        cell_score = torch.empty((B, cells), dtype=torch.float32, device=dev)
        cell_best = torch.empty((B, cells), dtype=torch.int32, device=dev)
        if B * cells == 0:
            return cell_score, cell_best
        self._launch(dev, B, imgs.data_ptr(), threshold.reshape(1).data_ptr(), B, H, W,
                     arc_len, border, bin_size, cell_score.data_ptr(), cell_best.data_ptr())
        return cell_score, cell_best


FAST_CELLS = FastCellsKernel()


def fast_cells(imgs: torch.Tensor, threshold: torch.Tensor, *, arc_len: int = ARC_LEN,
               border: int = 20, bin_size: int = 16):
    """FAST-N/16 score -> 3x3 NMS -> border mask -> per-cell argmax of
    every image of a (B, H, W) f32 stack at one pyramid level: (cell_score
    (B, cells) f32, cell_best (B, cells) int32), as cells_from_score.  A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (bin sizes 1..128, B <= 65535)."""
    threshold = torch.as_tensor(threshold, dtype=torch.float32, device=imgs.device)
    if imgs.device.type == "cuda":
        return FAST_CELLS.launch(imgs.to(torch.float32).contiguous(), threshold, arc_len,
                                 border, bin_size)
    if imgs.device.type != "cpu":
        raise ValueError(f"FAST cells: unsupported device {imgs.device}")
    return fast_cells_reference(imgs, threshold, arc_len, border, bin_size)


# ---------------------------------------------------------------------------
# The pyramid
# ---------------------------------------------------------------------------


def level_cells(level: torch.Tensor, threshold: torch.Tensor, bin_size: int, border: int,
                detector: str):
    """(cell_score, cell_best) of every image of a (B, h, w) level: the
    FAST family in one fast_cells call, the float detectors image by
    image into one NMS and binning pass."""
    arc = FAST_ARCS.get(detector.upper())
    if arc is not None:
        return fast_cells(level, threshold, arc_len=arc, border=border, bin_size=bin_size)
    score = torch.stack([score_map(im, threshold, detector) for im in level])
    return cells_from_score(nms3(score), bin_size, border)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling of an (..., H, W) image or stack (one pyramid
    octave down)."""
    H2 = (img.shape[-2] // 2) * 2
    W2 = (img.shape[-1] // 2) * 2
    c = img[..., :H2, :W2]
    return 0.25 * (c[..., 0::2, 0::2] + c[..., 0::2, 1::2] + c[..., 1::2, 0::2]
                   + c[..., 1::2, 1::2])


def pyramid(imgs: torch.Tensor, octaves: int) -> list:
    """The levels of a 2x pyramid of an image or a stack: imgs, then each
    level downsample2 of the one above."""
    levels = [imgs]
    for _ in range(1, octaves):
        levels.append(downsample2(levels[-1]))
    return levels


def octave_capacities(capacity: int, octaves: int) -> list[int]:
    """Static per-octave keypoint budget: halving shares, remainder to
    level 0."""
    if octaves == 1:
        return [capacity]
    shares = [capacity >> (o + 1) for o in range(1, octaves)]
    return [capacity - sum(shares)] + shares


def detect_pyramid(levels: list, threshold: torch.Tensor, bin_size: int = 16,
                   capacity: int = 1024, border: int = 20, detector: str = "FAST") -> Keypoints:
    """Detection over the (B, h, w) levels of a stack's pyramid (`pyramid`):
    each octave keeps its static share of the capacity; a level-o pixel
    (r, c) maps to the level-0 centre (r s + (s-1)/2, c s + (s-1)/2),
    s = 2^o.  Every field of the result has a leading B."""
    B = levels[0].shape[0]
    uvs, scores, valids, octs = [], [], [], []
    for o, cap_o in enumerate(octave_capacities(capacity, len(levels))):
        level = levels[o]
        cell_score, cell_best = level_cells(level, threshold, bin_size, border, detector)
        uv, sc, va = keypoints_from_cells(cell_score, cell_best, level.shape[2] // bin_size,
                                          bin_size, cap_o)
        s = float(1 << o)
        uvs.append(uv * s + (s - 1.0) / 2.0)
        scores.append(sc)
        valids.append(va)
        octs.append(torch.full((B, cap_o), o, dtype=torch.int32, device=level.device))
    return Keypoints(uv=torch.cat(uvs, dim=1), score=torch.cat(scores, dim=1),
                     valid=torch.cat(valids, dim=1), octave=torch.cat(octs, dim=1))


def detect_keypoints(img: torch.Tensor, threshold: torch.Tensor, bin_size: int = 16,
                     capacity: int = 1024, border: int = 20, detector: str = "FAST",
                     octaves: int = 1) -> Keypoints:
    """Multi-octave detection over a 2x pyramid of an (H, W) image, or of
    each image of a (B, H, W) stack (then every field has a leading B):
    detect_pyramid over pyramid(img, octaves)."""
    stack = img if img.dim() == 3 else img[None]
    kp = detect_pyramid(pyramid(stack, octaves), threshold, bin_size, capacity, border,
                        detector)
    return kp if img.dim() == 3 else Keypoints(*(f[0] for f in kp))


class ThresholdController:
    """Host-side delta-proportional detector threshold controller (the
    modular tracker's; base_framepoint_generator.cpp:355-459): one
    controller for the whole image, the per-step change clamped, the
    threshold clamped to [minimum, maximum].  Python floats, as the JAX
    package's."""

    def __init__(self, initial: float = 20.0, target_count: int = 700,
                 max_change: float = 10.0, minimum: float = 5.0, maximum: float = 100.0):
        self.threshold = float(initial)
        self.target = int(target_count)
        self.max_change = float(max_change)
        self.min = float(minimum)
        self.max = float(maximum)

    def update(self, detected_count: int) -> float:
        err = (detected_count - self.target) / max(self.target, 1)
        delta = float(np.clip(err * self.max_change, -self.max_change, self.max_change))
        self.threshold = float(np.clip(self.threshold + delta, self.min, self.max))
        return self.threshold
