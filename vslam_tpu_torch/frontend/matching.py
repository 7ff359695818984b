"""Stereo epipolar and projective descriptor matching (port of
vslam_tpu/frontend/matching.py): a full Hamming distance matrix masked by
the geometric gates, resolved one-to-one by mutual-best cross-check.

On CUDA tensors each call is the matching kernel
(ops/hamming.HAMMING_MATCH, csrc/hamming_match.cu), which raises on an
input it does not take; CPU tensors run the plain versions
(`match_stereo_reference`, `match_projective_reference`), its bit-exact
twins (there is no fallback between the two)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.ops import hamming


class StereoMatches(NamedTuple):
    right_idx: torch.Tensor  # (L,) int32 index into right keypoints
    distance: torch.Tensor  # (L,) int32 Hamming distance
    valid: torch.Tensor  # (L,) bool


class ProjectiveMatches(NamedTuple):
    cur_idx: torch.Tensor  # (P,) int32 index into current keypoints
    distance: torch.Tensor  # (P,) int32
    valid: torch.Tensor  # (P,) bool


def _on_card(*tensors) -> bool:
    return any(t.device.type == "cuda" for t in tensors)


def match_stereo(uv_l, desc_l, mask_l, uv_r, desc_r, mask_r, max_hamming,
                 epipolar_tol, min_disparity, max_disparity) -> StereoMatches:
    """One-to-one stereo correspondence under epipolar + disparity gates."""
    if _on_card(uv_l, desc_l, mask_l, uv_r, desc_r, mask_r):
        idx, valid, best = hamming.HAMMING_MATCH.match(
            hamming.HAMMING_MATCH.STEREO, uv_l[None], desc_l, mask_l, uv_r, desc_r, mask_r,
            (epipolar_tol, min_disparity, max_disparity), max_hamming)
        return StereoMatches(right_idx=idx[0], distance=best[0], valid=valid[0])
    return match_stereo_reference(uv_l, desc_l, mask_l, uv_r, desc_r, mask_r, max_hamming,
                                  epipolar_tol, min_disparity, max_disparity)


def match_stereo_reference(uv_l, desc_l, mask_l, uv_r, desc_r, mask_r, max_hamming,
                           epipolar_tol, min_disparity, max_disparity) -> StereoMatches:
    """Plain version of match_stereo: the (L, R) distance matrix, the
    gate mask and mutual_best_match."""
    dist = hamming.hamming_matrix(desc_l, desc_r)
    dv = torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1])
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    mask = (
        mask_l[:, None]
        & mask_r[None, :]
        & (dv <= epipolar_tol)
        & (disp >= min_disparity)
        & (disp <= max_disparity)
    )
    idx, valid, best = hamming.mutual_best_match(dist, mask, max_hamming)
    return StereoMatches(right_idx=idx, distance=best, valid=valid)


def match_projective(proj_uv, desc_prev, mask_prev, uv_cur, desc_cur, mask_cur,
                     radius_px, max_hamming) -> ProjectiveMatches:
    """Track prior points into the current frame by windowed Hamming match.

    proj_uv (..., P, 2) and mask_prev (..., P) may carry leading dims of
    independent predictions of the same points, with radius_px and
    max_hamming scalars or tensors of those leading dims; the descriptor
    distances are computed once for all of them."""
    if _on_card(proj_uv, desc_prev, mask_prev, uv_cur, desc_cur, mask_cur):
        idx, valid, best = hamming.HAMMING_MATCH.match(
            hamming.HAMMING_MATCH.PROJECTIVE, proj_uv, desc_prev, mask_prev, uv_cur, desc_cur,
            mask_cur, (radius_px, 0.0, 0.0), max_hamming)
        return ProjectiveMatches(cur_idx=idx, distance=best, valid=valid)
    return match_projective_reference(proj_uv, desc_prev, mask_prev, uv_cur, desc_cur,
                                      mask_cur, radius_px, max_hamming)


def match_projective_reference(proj_uv, desc_prev, mask_prev, uv_cur, desc_cur, mask_cur,
                               radius_px, max_hamming) -> ProjectiveMatches:
    """Plain version of match_projective: the (P, D) distance matrix once,
    each problem's window mask and mutual_best_match."""
    lead = proj_uv.shape[:-2]

    def per_problem(x, trailing):
        return x.reshape(lead + (1,) * trailing) if isinstance(x, torch.Tensor) else x

    radius_px = per_problem(radius_px, 2)
    dist = hamming.hamming_matrix(desc_prev, desc_cur)
    du = torch.abs(proj_uv[..., :, None, 0] - uv_cur[None, :, 0])
    dv = torch.abs(proj_uv[..., :, None, 1] - uv_cur[None, :, 1])
    mask = (
        mask_prev[..., :, None]
        & mask_cur[None, :]
        & (du <= radius_px)
        & (dv <= radius_px)
    )
    idx, valid, best = hamming.mutual_best_match(dist, mask, per_problem(max_hamming, 1))
    return ProjectiveMatches(cur_idx=idx, distance=best, valid=valid)
