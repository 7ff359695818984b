"""FAST-family corner detection over an image pyramid (port of the FAST
subset of vslam_tpu/frontend/detect.py).

Whole-image array program: FAST-9/16 (or FAST-12) score map -> 3x3 NMS
-> border mask -> per-cell argmax over a bin_size grid -> global top-K to
a fixed capacity, per pyramid octave, with coordinates mapped back to
level 0.  HARRIS, GFTT, DOG and KAZE are not ported yet (ROADMAP Queue 1
item 14).
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.frontend.fast_brief import CIRCLE, Keypoints, _arc

ARC_LEN = 9
_UNPORTED = ("HARRIS", "GFTT", "SHI_TOMASI", "DOG", "KAZE", "AKAZE")


def _shifted_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (16, H, W): circle neighbour values per pixel, zero
    outside the image."""
    H, W = img.shape
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    return torch.stack([p[3 + int(dr):3 + int(dr) + H, 3 + int(dc):3 + int(dc) + W]
                        for dr, dc in CIRCLE])


def fast_score_map(img: torch.Tensor, threshold: torch.Tensor,
                   arc_len: int = ARC_LEN) -> torch.Tensor:
    """Per-pixel FAST-N/16 corner score (summed threshold excess of the
    winning polarity, in ring order); 0 where not a corner."""
    circ = _shifted_stack(img)
    hi = img + threshold
    lo = img - threshold
    mb = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    md = torch.zeros_like(mb)
    bright = torch.zeros_like(img)
    dark = torch.zeros_like(img)
    for kk in range(16):
        mb = mb | ((circ[kk] > hi).to(torch.int64) << kk)
        md = md | ((circ[kk] < lo).to(torch.int64) << kk)
        bright = bright + torch.clamp(circ[kk] - hi, min=0.0)
        dark = dark + torch.clamp(lo - circ[kk], min=0.0)
    corner = _arc(mb, arc_len) | _arc(md, arc_len)
    return torch.where(corner, torch.maximum(bright, dark), 0.0)


def score_map(img: torch.Tensor, threshold: torch.Tensor, detector: str) -> torch.Tensor:
    d = detector.upper()
    if d in ("FAST", "FAST9", "AGAST"):
        return fast_score_map(img, threshold, arc_len=9)
    if d == "FAST12":
        return fast_score_map(img, threshold, arc_len=12)
    if d in _UNPORTED:
        raise NotImplementedError(
            f"detector {detector!r} is not ported yet (ROADMAP Queue 1 item 14)")
    raise ValueError(f"unknown detector '{detector}' "
                     "(FAST|FAST12|AGAST|HARRIS|GFTT|DOG|KAZE|AKAZE)")


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (the window is -inf outside the image)."""
    neigh = torch.nn.functional.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh, score, 0.0)


def keypoints_from_score(score: torch.Tensor, bin_size: int, capacity: int,
                         border: int):
    """Binning tail over an NMS'd score map: border mask -> per-cell
    argmax (first index on ties: lowest row, then column) -> top-K cells
    (lower cell index first on ties, as lax.top_k).  Returns (uv (K, 2)
    f32 level-local [col, row], score (K,), valid (K,))."""
    H, W = score.shape
    dev = score.device
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    inside = ((rows >= border) & (rows < H - border)
              & (cols >= border) & (cols < W - border))
    score = torch.where(inside, score, 0.0)

    nr, nc = H // bin_size, W // bin_size
    sc = (score[:nr * bin_size, :nc * bin_size]
          .reshape(nr, bin_size, nc, bin_size).permute(0, 2, 1, 3)
          .reshape(nr * nc, bin_size * bin_size))
    cell_score = sc.amax(dim=1)
    iota = torch.arange(bin_size * bin_size, device=dev)
    cell_best = torch.where(sc >= cell_score[:, None], iota, bin_size * bin_size).amin(dim=1)

    k = min(capacity, nr * nc)
    top_score, top_cell = torch.sort(cell_score, descending=True, stable=True)
    top_score, top_cell = top_score[:k], top_cell[:k]
    best = cell_best[top_cell]
    v = (top_cell // nc) * bin_size + best // bin_size
    u = (top_cell % nc) * bin_size + best % bin_size
    uv = torch.stack([u, v], dim=1).to(torch.float32)
    valid = top_score > 0.0
    if k < capacity:
        pad = capacity - k
        uv = torch.nn.functional.pad(uv, (0, 0, 0, pad))
        top_score = torch.nn.functional.pad(top_score, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return uv, top_score, valid


def _detect_level(img, threshold, bin_size, capacity, border, detector):
    """Single level: score -> NMS -> per-bin argmax -> top-K."""
    score = nms3(score_map(img, threshold, detector))
    return keypoints_from_score(score, bin_size, capacity, border)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling (one pyramid octave down)."""
    H2 = (img.shape[0] // 2) * 2
    W2 = (img.shape[1] // 2) * 2
    c = img[:H2, :W2]
    return 0.25 * (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2])


def octave_capacities(capacity: int, octaves: int) -> list[int]:
    """Static per-octave keypoint budget: halving shares, remainder to
    level 0."""
    if octaves == 1:
        return [capacity]
    shares = [capacity >> (o + 1) for o in range(1, octaves)]
    return [capacity - sum(shares)] + shares


def detect_keypoints(img: torch.Tensor, threshold: torch.Tensor, bin_size: int = 16,
                     capacity: int = 1024, border: int = 20, detector: str = "FAST",
                     octaves: int = 1) -> Keypoints:
    """Multi-octave detection over a 2x pyramid: each octave runs the
    single-level pipeline with its static share of the capacity; a
    level-o pixel (r, c) maps to the level-0 centre (r s + (s-1)/2,
    c s + (s-1)/2), s = 2^o."""
    uvs, scores, valids, octs = [], [], [], []
    level = img
    for o, cap_o in enumerate(octave_capacities(capacity, octaves)):
        if o > 0:
            level = downsample2(level)
        uv, sc, va = _detect_level(level, threshold, bin_size, cap_o, border, detector)
        s = float(1 << o)
        uvs.append(uv * s + (s - 1.0) / 2.0)
        scores.append(sc)
        valids.append(va)
        octs.append(torch.full((cap_o,), o, dtype=torch.int32, device=img.device))
    return Keypoints(uv=torch.cat(uvs), score=torch.cat(scores),
                     valid=torch.cat(valids), octave=torch.cat(octs))
