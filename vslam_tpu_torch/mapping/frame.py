"""Per-frame state and the stereo and RGB-D front-end / tracking programs
(port of vslam_tpu/mapping/frame.py).

FrameState is a fixed-capacity SoA record with a valid mask; the temporal
track is carried by the integer columns `track_len` and `landmark_slot`.
All functions are free of host syncs: masks select with torch.where, and
scatters that the JAX package writes as predicated "add-delta" scatters
(unused rows alias row 0 and add zero) keep that form with index_add, so
colliding rows add exact zeros.  Row "sets" whose value cannot be a delta
(descriptor words, flags) go through `_put_rows`, which parks the unused
rows in a spare row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.frontend import brief, depth, detect, fast_brief, matching, orb
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.ops import hamming, lie
from vslam_tpu_torch.solve import aligners, gn
from vslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_FAST_DETECTORS = ("FAST", "FAST9", "AGAST", "FAST12")


class FrameState(NamedTuple):
    """Framepoints of one frame (capacity K, masked, compacted)."""

    uv4: torch.Tensor  # (K, 4) stereo [uL, vL, uR, vR]; RGB-D [u, v, z, 0]
    desc: torch.Tensor  # (K, 8) int32 left descriptors
    p_cam: torch.Tensor  # (K, 3) points in this camera's frame
    valid: torch.Tensor  # (K,) bool
    track_len: torch.Tensor  # (K,) int32, 1 for fresh stereo points
    landmark_slot: torch.Tensor  # (K,) int32 into the landmark table, -1 none
    # False = temporary point: disparity below the stereo minimum, p_cam is
    # a capped-depth guess until midpoint triangulation promotes it.
    reliable: torch.Tensor  # (K,) bool

    @property
    def capacity(self):
        return self.uv4.shape[0]


def empty_frame(capacity: int, device=DEFAULT_DEVICE) -> FrameState:
    device = resolve_device(device)
    return FrameState(
        uv4=torch.zeros((capacity, 4), dtype=torch.float32, device=device),
        desc=torch.zeros((capacity, 8), dtype=torch.int32, device=device),
        p_cam=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        track_len=torch.zeros(capacity, dtype=torch.int32, device=device),
        landmark_slot=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        reliable=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def stable_partition_perm(valid: torch.Tensor) -> torch.Tensor:
    """Permutation (int64) putting valid rows first, stably: valid row i
    goes to its rank among valid rows, invalid rows follow in order."""
    k = valid.shape[0]
    vi = valid.to(torch.int64)
    rank_v = torch.cumsum(vi, 0) - 1
    rank_i = torch.cumsum(1 - vi, 0) - 1
    dest = torch.where(valid, rank_v, vi.sum() + rank_i)
    perm = torch.empty(k, dtype=torch.int64, device=valid.device)
    return perm.index_put_((dest,), torch.arange(k, device=valid.device))


def _compact(order_key: torch.Tensor, *arrays):
    """Reorder arrays so rows with order_key True come first (stable)."""
    perm = stable_partition_perm(order_key)
    return tuple(a[perm] for a in arrays)


def _put_rows(arr: torch.Tensor, idx: torch.Tensor, use: torch.Tensor, val):
    """arr with rows idx[use] set to val[use] (no host sync): unused rows
    write a spare row that is dropped.  idx[use] must be distinct."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    val = (val.to(arr.dtype) if isinstance(val, torch.Tensor)
           else torch.full((), val, dtype=arr.dtype, device=arr.device))
    ext.index_put_((torch.where(use, idx.to(torch.int64), n),),
                   val.expand((idx.shape[0],) + arr.shape[1:]))
    return ext[:n]


def _add_delta(arr: torch.Tensor, tgt: torch.Tensor, use: torch.Tensor, val):
    """arr.at[tgt].add(where(use, val - arr[tgt], 0)) — the JAX package's
    predicated add-delta scatter, kept so float rows round identically."""
    u = use.reshape((-1,) + (1,) * (arr.dim() - 1))
    delta = torch.where(u, val - arr[tgt], torch.zeros((), dtype=arr.dtype,
                                                          device=arr.device))
    return arr.index_add(0, tgt, delta)


def _pyramid_descriptors(levels, kp, planes0, capacity):
    """Per-octave dense-BRIEF description of one image: each octave's
    static slice of the keypoints gathers from the planes of its own
    pyramid level (`levels`, the image's levels from detect.pyramid: the
    given level-0 planes, then K3 at each level >= 1); at one octave this
    is the plain level-0 lookup.  Returns (K, 8)."""
    parts, start = [], 0
    for o, cap_o in enumerate(detect.octave_capacities(capacity, len(levels))):
        lvl = levels[o]
        pl = planes0 if o == 0 else brief.dense_planes(lvl)
        s = float(1 << o)
        sl = slice(start, start + cap_o)
        parts.append(brief.gather_descriptors(pl, lvl.shape,
                                              (kp.uv[sl] - (s - 1.0) / 2.0) / s))
        start += cap_o
    return torch.cat(parts)


def _uses_k1(descriptor, detector, octaves, border) -> bool:
    """BRIEF256 at one octave with a FAST-family detector and border >= 16
    runs the fused kernel K1 (exact only >= 16 px from the edge)."""
    return (descriptor == "BRIEF256" and octaves == 1 and border >= 16
            and detector.upper() in _FAST_DETECTORS)


def _stereo_detect_describe(imgs, threshold, capacity, bin_size, border, descriptor,
                            detector, want_planes, octaves):
    """Detection and description of a stack of stereo pairs.

    imgs: (2k, H, W) f32, frame i's left image at 2i and right at 2i+1.
    Batched where a kernel takes a stack: K1 runs once over all 2k images
    and its band tail once over B = 2k; on the staged path each pyramid
    level is made once for the 2k images, the FAST family's detection is
    one kernel launch a level over them and its binning tail one pass
    (detect.detect_pyramid), and the level-0 planes are one K2 launch
    over the 2k blurred images.  Per image, in a loop: the float
    detectors' score maps, pyramid levels >= 1's planes (K3),
    BRIEF256R's rotated banks (K4) and the ORB256 gather.
    Returns (keypoints [2k], descriptors [2k], level-0 planes (k, 2, 8, H,
    W) or None for ORB256, and for BRIEF256R without want_planes)."""
    n, H, W = imgs.shape
    if _uses_k1(descriptor, detector, octaves, border):
        planes, score, rowmax, rowarg = fast_brief.fast_brief_frontend_pair(
            imgs, threshold, arc_len=12 if detector.upper() == "FAST12" else 9,
            border=border, bin_size=bin_size,
        )
        if bin_size == fast_brief.BAND:
            uv, sc, va = fast_brief.keypoints_from_band_reduction(
                rowmax, rowarg, H, W, bin_size, capacity)
            kps = [fast_brief.Keypoints(uv[b], sc[b], va[b]) for b in range(n)]
        else:
            kps = [fast_brief.Keypoints(*detect.keypoints_from_score(
                score[b], bin_size, capacity, border)) for b in range(n)]
        descs = [brief.gather_descriptors(planes[b], (H, W), kps[b].uv) for b in range(n)]
        return kps, descs, planes.view(n // 2, 2, 8, H, W)
    levels = detect.pyramid(imgs, octaves)
    kp = detect.detect_pyramid(levels, threshold, bin_size, capacity, border, detector)
    kps = [fast_brief.Keypoints(*(f[b] for f in kp)) for b in range(n)]
    planes = None
    if descriptor == "BRIEF256" or (descriptor == "BRIEF256R" and want_planes):
        planes = brief.dense_planes_batch(imgs)
    if descriptor == "ORB256":
        descs = [orb.describe(imgs[b], kps[b].uv) for b in range(n)]
    elif descriptor == "BRIEF256R":
        # Rotated-bank descriptors; landmark recovery re-describes from
        # the upright level-0 planes, as the JAX package does.
        descs = [brief.describe_dense_rotated(imgs[b], kps[b].uv) for b in range(n)]
    else:
        descs = [_pyramid_descriptors([lvl[b] for lvl in levels], kps[b], planes[b], capacity)
                 for b in range(n)]
    return kps, descs, None if planes is None else planes.view(n // 2, 2, 8, H, W)


def stereo_frontend_core(
    cam: cam_ops.CameraParams,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    threshold: torch.Tensor,
    max_hamming_stereo,
    epipolar_tol,
    min_disparity,
    max_disparity,
    capacity: int = 1024,
    bin_size: int = 16,
    border: int = 20,
    descriptor: str = "BRIEF256",
    detector: str = "FAST",
    want_planes: bool = False,
    octaves: int = 1,
):
    """Stereo front-end: detection and description of both images,
    epipolar match, triangulation, compaction.

    A FAST-family detector with BRIEF256 at one octave and border >= 16
    runs the fused kernel K1 (exact only >= 16 px from the edge);
    everything else runs the staged front-end: the detector over the
    pyramid, then dense BRIEF planes (K2, K3), rotated-bank planes (K4)
    or the ORB256 gather.  With want_planes the level-0 planes of both
    images (2, 8, H, W) are returned too, for landmark recovery (None
    for ORB256, whose recovery re-describes from the images).
    Returns (FrameState, n_keypoints_left, n_framepoints[, planes])."""
    kps, descs, planes = _stereo_detect_describe(
        torch.stack([img_l, img_r]).to(torch.float32), threshold, capacity, bin_size,
        border, descriptor, detector, want_planes, octaves)
    return _stereo_frontend_tail(
        cam, kps[0], kps[1], descs[0], descs[1],
        planes[0] if want_planes and planes is not None else None,
        max_hamming_stereo, epipolar_tol, min_disparity, max_disparity,
        capacity, want_planes,
    )


def process_stereo_pair(
    cam: cam_ops.CameraParams,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    threshold: torch.Tensor,
    max_hamming_stereo,
    epipolar_tol,
    min_disparity,
    max_disparity,
    capacity: int = 1024,
    bin_size: int = 16,
    border: int = 20,
    descriptor: str = "BRIEF256",
    detector: str = "FAST",
    octaves: int = 1,
):
    """The modular tracker's stereo front-end for one pair: the front-end
    of stereo_frontend_core without the planes.
    Returns (FrameState, n_keypoints_left, n_framepoints)."""
    return stereo_frontend_core(
        cam, img_l, img_r, threshold, max_hamming_stereo, epipolar_tol,
        min_disparity, max_disparity, capacity=capacity, bin_size=bin_size,
        border=border, descriptor=descriptor, detector=detector,
        want_planes=False, octaves=octaves,
    )


def frontend_chunk(
    cam: cam_ops.CameraParams,
    chunk: torch.Tensor,
    threshold: torch.Tensor,
    *,
    mode: str = "stereo",
    max_hamming_stereo=60,
    epipolar_tol=1.5,
    min_disparity=1.0,
    max_disparity=200.0,
    min_depth=0.3,
    max_depth=10.0,
    capacity: int = 1024,
    bin_size: int = 16,
    border: int = 20,
    descriptor: str = "BRIEF256",
    detector: str = "FAST",
    want_planes: bool = False,
    octaves: int = 1,
):
    """The front-end of a whole chunk at one detector threshold (the
    split pipeline's batched half, the JAX package's vmap of
    `_frontend_one`).

    chunk: (k, 2, H, W) f32 -- stereo pairs, or in depth mode the
    intensity image and the registered depth in meters.  Returns the k
    per-frame results of stereo_frontend_core / process_depth_frame at
    `threshold`, stacked on a leading axis: (FrameState with (k, ...)
    fields, n_kp (k,), n_fp (k,), planes (k, 2, 8, H, W) stereo, (k, 8,
    H, W) RGB-D, or None).  The stereo detection and description are
    batched as _stereo_detect_describe says; the match and compaction
    tail, and every step of an RGB-D frame (FAST, K3 at each level, the
    depth gather), loop over the frames."""
    k = chunk.shape[0]
    if mode == "stereo":
        H, W = chunk.shape[2:]
        kps, descs, planes = _stereo_detect_describe(
            chunk.reshape(2 * k, H, W), threshold, capacity, bin_size, border,
            descriptor, detector, want_planes, octaves)
        outs = [_stereo_frontend_tail(
            cam, kps[2 * i], kps[2 * i + 1], descs[2 * i], descs[2 * i + 1], None,
            max_hamming_stereo, epipolar_tol, min_disparity, max_disparity,
            capacity, False) for i in range(k)]
    else:
        outs = [process_depth_frame(
            cam, chunk[i, 0], chunk[i, 1], threshold, min_depth, max_depth,
            capacity=capacity, bin_size=bin_size, border=border, descriptor=descriptor,
            detector=detector, want_planes=want_planes, octaves=octaves)
            for i in range(k)]
        planes = torch.stack([o[3] for o in outs]) if want_planes and outs[0][3] is not None \
            else None
    frames = FrameState(*(torch.stack(f) for f in zip(*(o[0] for o in outs))))
    n_kp = torch.stack([o[1] for o in outs])
    n_fp = torch.stack([o[2] for o in outs])
    return frames, n_kp, n_fp, planes if want_planes else None


def _stereo_frontend_tail(cam, kl, kr, dl, dr, planes, max_hamming_stereo,
                          epipolar_tol, min_disparity, max_disparity,
                          capacity, want_planes):
    """Epipolar match -> triangulation -> compaction -> FrameState.
    Matches below min_disparity are kept as temporary points."""
    m = matching.match_stereo(
        kl.uv, dl, kl.valid, kr.uv, dr, kr.valid,
        max_hamming_stereo, epipolar_tol, 0.0, max_disparity,
    )
    uv_l = kl.uv
    uv_r = kr.uv[m.right_idx.to(torch.int64)]
    disp = uv_l[:, 0] - uv_r[:, 0]
    reliable = disp >= min_disparity
    p_cam, _ = cam_ops.triangulate_disparity(cam, uv_l, uv_r, 1.0)
    # A gate given as a tensor (the modular front-end program's buffer)
    # stays on the device; a number divides as the fused step's always has.
    z_den = (torch.clamp(min_disparity, min=0.25) if isinstance(min_disparity, torch.Tensor)
             else max(float(min_disparity), 0.25))
    z_cap = (cam.fx * cam.baseline_m).expand_as(disp) / z_den
    p_cam = torch.where(reliable[:, None], p_cam,
                        cam_ops.back_project(cam, uv_l, z_cap))
    valid = m.valid & kl.valid & (p_cam[:, 2] > 0)

    uv4 = torch.cat([uv_l, uv_r], dim=1)
    uv4, desc, p_cam, valid, reliable = _compact(
        valid, uv4, dl, p_cam, valid, reliable
    )
    frame = FrameState(
        uv4=uv4,
        desc=desc,
        p_cam=p_cam,
        valid=valid,
        track_len=valid.to(torch.int32),
        landmark_slot=torch.full((capacity,), -1, dtype=torch.int32,
                                 device=uv4.device),
        reliable=reliable & valid,
    )
    n_kp = kl.valid.sum(dtype=torch.int32)
    n_fp = (valid & reliable).sum(dtype=torch.int32)
    if want_planes:
        return frame, n_kp, n_fp, planes
    return frame, n_kp, n_fp


def process_depth_frame(
    cam: cam_ops.CameraParams,
    img: torch.Tensor,
    depth_m: torch.Tensor,  # registered to the intensity camera
    threshold: torch.Tensor,
    min_depth,
    max_depth,
    capacity: int = 1024,
    bin_size: int = 16,
    border: int = 20,
    descriptor: str = "BRIEF256",
    detector: str = "FAST",
    want_planes: bool = False,
    octaves: int = 1,
):
    """RGB-D front-end: detect -> describe -> depth gather -> back-project
    (reference DepthFramePointGenerator::compute).  uv4 carries
    [u, v, depth_m, 0].  BRIEF256 describes from the dense planes of the
    intensity image (one K3 launch; one per level with octaves), ORB256
    by its gather; with want_planes the (8, H, W) level-0 planes are
    returned too, for landmark recovery (None for ORB256).
    Returns (FrameState, n_keypoints, n_framepoints[, planes])."""
    levels = detect.pyramid(img[None], octaves)
    kp = fast_brief.Keypoints(*(f[0] for f in detect.detect_pyramid(
        levels, threshold, bin_size, capacity, border, detector)))
    planes = None
    if descriptor == "ORB256":
        desc = orb.describe(img, kp.uv)
    elif descriptor == "BRIEF256R":
        desc = brief.describe_dense_rotated(img, kp.uv)
        if want_planes:
            planes = brief.dense_planes(img)
    else:
        planes = brief.dense_planes(img)
        desc = _pyramid_descriptors([lvl[0] for lvl in levels], kp, planes, capacity)
    z = depth.gather_depth(depth_m, kp.uv)
    valid = kp.valid & (z >= min_depth) & (z <= max_depth)
    p_cam = cam_ops.back_project(cam, kp.uv, z)
    uv4 = torch.cat([kp.uv, z[:, None], torch.zeros_like(z[:, None])], dim=1)
    uv4, desc, p_cam, valid = _compact(valid, uv4, desc, p_cam, valid)
    frame = FrameState(
        uv4=uv4,
        desc=desc,
        p_cam=p_cam,
        valid=valid,
        track_len=valid.to(torch.int32),
        landmark_slot=torch.full((capacity,), -1, dtype=torch.int32, device=uv4.device),
        reliable=valid,  # depth-sensor points carry a measured range
    )
    n_kp = kp.valid.sum(dtype=torch.int32)
    n_fp = valid.sum(dtype=torch.int32)
    if want_planes:
        return frame, n_kp, n_fp, planes
    return frame, n_kp, n_fp


class TrackResult(NamedTuple):
    T_cur_prev: torch.Tensor  # (4, 4) estimated camera motion
    prev_to_cur: torch.Tensor  # (Kprev,) int32 index into cur, -1 unmatched
    n_matches: torch.Tensor  # int32
    n_inliers: torch.Tensor  # int32
    mean_chi2: torch.Tensor  # f32
    converged: torch.Tensor  # bool


def track_and_align_batch(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    T_guess: torch.Tensor,  # (A, 4, 4) prev-camera -> cur-camera
    radius_px: torch.Tensor,  # (A,)
    max_hamming: torch.Tensor,  # (A,)
    point_weights: torch.Tensor,  # (Kprev,)
    gn_config: gn.GNConfig = gn.GNConfig(),
    depth: bool = False,
) -> TrackResult:
    """A attempts at tracking prev framepoints into cur and solving for
    the camera motion, each from its own guess, window and descriptor
    gate, as one batch: every field of the result has the leading dim A.
    depth: [u, v, depth] residuals through the UVD aligner (reference
    UVDAligner), else the stereo reprojections."""
    p_pred = lie.transform_points(T_guess[:, None], prev.p_cam)
    proj_uv, z_pred = cam_ops.project(cam, p_pred)
    predictable = prev.valid & (z_pred > 0.05)
    m = matching.match_projective(
        proj_uv, prev.desc, predictable,
        cur.uv4[:, :2], cur.desc, cur.valid,
        radius_px, max_hamming,
    )
    matched = m.valid & predictable
    meas = cur.uv4[m.cur_idx.to(torch.int64)]  # (A, Kprev, 4)
    if depth:
        data = aligners.UVDData(p_prev=prev.p_cam, meas=meas[..., :3], weight=point_weights,
                                depth_reliable=meas[..., 2] > 0.01)
        res = aligners.uvd_align(cam, data, matched, T_guess, gn_config)
    else:
        # Temporary points inform rotation but get a small weight so their
        # capped depth cannot bias translation.
        weights = torch.where(prev.reliable, point_weights, 0.2 * point_weights)
        data = aligners.StereoUVData(p_prev=prev.p_cam, meas=meas, weight=weights)
        res = aligners.stereo_uv_align_fast(cam, data, matched, T_guess, gn_config)
    return TrackResult(
        T_cur_prev=res.x,
        prev_to_cur=torch.where(matched, m.cur_idx, -1).to(torch.int32),
        n_matches=matched.sum(dim=-1, dtype=torch.int32),
        n_inliers=res.num_inliers,
        mean_chi2=res.chi2,
        converged=res.converged,
    )


def _one_attempt(cam, prev, cur, T_guess, radius_px, max_hamming, point_weights,
                 gn_config, depth):
    def as_batch(x):
        return torch.as_tensor(x, device=T_guess.device).reshape(1)

    res = track_and_align_batch(cam, prev, cur, T_guess[None], as_batch(radius_px),
                                as_batch(max_hamming), point_weights, gn_config, depth)
    return TrackResult(*(f[0] for f in res))


def track_and_align(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    T_guess: torch.Tensor,  # (4, 4) prev-camera -> cur-camera
    radius_px,
    max_hamming,
    point_weights: torch.Tensor,  # (Kprev,)
    gn_config: gn.GNConfig = gn.GNConfig(),
) -> TrackResult:
    """Track prev framepoints into cur and solve for the camera motion
    (track_and_align_batch's attempt 0 of one)."""
    return _one_attempt(cam, prev, cur, T_guess, radius_px, max_hamming, point_weights,
                        gn_config, depth=False)


def track_and_align_uvd(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    T_guess: torch.Tensor,
    radius_px,
    max_hamming,
    point_weights: torch.Tensor,
    gn_config: gn.GNConfig = gn.GNConfig(),
) -> TrackResult:
    """RGB-D track_and_align: [u, v, depth] residuals through the UVD
    aligner (reference UVDAligner)."""
    return _one_attempt(cam, prev, cur, T_guess, radius_px, max_hamming, point_weights,
                        gn_config, depth=True)


def recover_lost_landmarks(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    motion: torch.Tensor,  # (4, 4) T_cur_prev from the pose solve
    prev_to_cur: torch.Tensor,  # (K,) match indices, -1 = lost
    planes,  # (2, 8, H, W) dense BRIEF planes, or None for ORB256
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    desc_gate,
    min_disparity,
    max_disparity,
    border: int = 20,
    descriptor: str = "BRIEF256",
    enabled=True,
):
    """Landmark recovery (reference recoverPoints): landmark-backed points
    of the previous frame that found no match are re-acquired at their
    solved-pose projections by a descriptor lookup in both images (in the
    dense planes; ORB256 describes the images there), gated on descriptor
    distance, field of view and disparity, re-triangulated and appended
    after the valid block of cur.  Returns (cur', n)."""
    lost = prev.valid & (prev.landmark_slot >= 0) & (prev_to_cur < 0)
    p_pred = lie.transform_point_cloud(motion, prev.p_cam)
    uv_l, uv_r, z = cam_ops.project_stereo(cam, p_pred)
    vis = (cam_ops.in_field_of_view(cam, uv_l, z, border)
           & cam_ops.in_field_of_view(cam, uv_r, z, border))
    if descriptor == "ORB256":
        dl = orb.describe(img_l, uv_l)
        dr = orb.describe(img_r, uv_r)
    else:
        dl = brief.gather_descriptors(planes[0], img_l.shape, uv_l)
        dr = brief.gather_descriptors(planes[1], img_r.shape, uv_r)
    gate = torch.as_tensor(desc_gate).to(torch.int32)
    p_cam_rec, tri_ok = cam_ops.triangulate_disparity(cam, uv_l, uv_r, 1.0)
    disp = uv_l[:, 0] - uv_r[:, 0]
    ok = (
        lost & vis
        & (hamming.hamming_pairwise(dl, prev.desc) <= gate)
        & (hamming.hamming_pairwise(dr, prev.desc) <= gate)
        & tri_ok
        & (disp >= min_disparity)
        & (disp <= max_disparity)
        & enabled
    )
    dest = cur.valid.sum(dtype=torch.int64) + torch.cumsum(ok.to(torch.int64), 0) - 1
    use = ok & (dest < cur.capacity)
    tgt = torch.where(use, dest, 0)
    cur = cur._replace(
        uv4=_add_delta(cur.uv4, tgt, use, torch.cat([uv_l, uv_r], dim=1)),
        desc=_put_rows(cur.desc, tgt, use, dl),
        p_cam=_add_delta(cur.p_cam, tgt, use, p_cam_rec),
        valid=_put_rows(cur.valid, tgt, use, True),
        track_len=_add_delta(cur.track_len, tgt, use, prev.track_len + 1),
        landmark_slot=_add_delta(cur.landmark_slot, tgt, use, prev.landmark_slot),
        reliable=_put_rows(cur.reliable, tgt, use, True),
    )
    return cur, use.sum(dtype=torch.int32)


def recover_lost_landmarks_depth(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    motion: torch.Tensor,  # (4, 4) T_cur_prev from the pose solve
    prev_to_cur: torch.Tensor,  # (K,) match indices, -1 = lost
    planes,  # (8, H, W) dense BRIEF planes of the intensity image, or None
    img: torch.Tensor,  # the intensity image
    depth_m: torch.Tensor,  # registered depth (meters)
    desc_gate,
    min_depth,
    max_depth,
    border: int = 20,
    descriptor: str = "BRIEF256",
    enabled=True,
    max_depth_error_ratio: float = 0.2,
):
    """RGB-D landmark recovery (reference DepthFramePointGenerator::
    recoverPoints): lost landmark-backed points are re-acquired at their
    solved-pose projections, the descriptor looked up in the dense planes
    (ORB256: described from the image) and the depth in the registered
    map, gated on descriptor distance, the depth range and predicted-vs-
    measured depth.  Returns (cur', n)."""
    lost = prev.valid & (prev.landmark_slot >= 0) & (prev_to_cur < 0)
    p_pred = lie.transform_point_cloud(motion, prev.p_cam)
    uv, z_pred = cam_ops.project(cam, p_pred)
    vis = cam_ops.in_field_of_view(cam, uv, z_pred, border)
    if descriptor == "ORB256":
        d = orb.describe(img, uv)
    else:
        d = brief.gather_descriptors(planes, img.shape, uv)
    z_meas = depth.gather_depth(depth_m, uv)
    depth_ok = ((z_meas >= min_depth) & (z_meas <= max_depth)
                & (torch.abs(z_meas - z_pred)
                   <= max_depth_error_ratio * torch.clamp(z_meas, min=0.5)))
    gate = torch.as_tensor(desc_gate).to(torch.int32)
    ok = lost & vis & (hamming.hamming_pairwise(d, prev.desc) <= gate) & depth_ok & enabled
    p_cam_rec = cam_ops.back_project(cam, uv, z_meas)
    dest = cur.valid.sum(dtype=torch.int64) + torch.cumsum(ok.to(torch.int64), 0) - 1
    use = ok & (dest < cur.capacity)
    tgt = torch.where(use, dest, 0)
    uv4_rec = torch.cat([uv, z_meas[:, None], torch.zeros_like(z_meas[:, None])], dim=1)
    cur = cur._replace(
        uv4=_add_delta(cur.uv4, tgt, use, uv4_rec),
        desc=_put_rows(cur.desc, tgt, use, d),
        p_cam=_add_delta(cur.p_cam, tgt, use, p_cam_rec),
        valid=_put_rows(cur.valid, tgt, use, True),
        track_len=_add_delta(cur.track_len, tgt, use, prev.track_len + 1),
        landmark_slot=_add_delta(cur.landmark_slot, tgt, use, prev.landmark_slot),
        reliable=_put_rows(cur.reliable, tgt, use, True),
    )
    return cur, use.sum(dtype=torch.int32)


def promote_temporary_points(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    motion: torch.Tensor,
    prev_to_cur: torch.Tensor,
    enabled=True,
    max_depth: float = 500.0,
):
    """Deferred midpoint triangulation of temporary points: a tracked
    temporary point whose two views now have parallax gets a 3D position
    from the solved motion and becomes reliable.  Returns (cur', n)."""
    tracked = prev_to_cur >= 0
    matched = tracked & prev.valid & ~prev.reliable & enabled
    j = torch.where(tracked, prev_to_cur, 0).to(torch.int64)
    mid, ok3 = cam_ops.triangulate_midpoint(
        cam, cur.uv4[j, :2], prev.uv4[:, :2], motion, max_depth=max_depth
    )
    promote = matched & ~cur.reliable[j] & ok3
    tgt = torch.where(promote, j, 0)
    cur = cur._replace(
        p_cam=_add_delta(cur.p_cam, tgt, promote, mid),
        reliable=_put_rows(cur.reliable, tgt, promote, True),
    )
    return cur, promote.sum(dtype=torch.int32)


def propagate_tracks(prev: FrameState, cur: FrameState,
                     prev_to_cur: torch.Tensor) -> FrameState:
    """Carry track length and landmark links from prev into matched cur
    rows (the reference's FramePoint::setPrevious chain, as a scatter)."""
    matched = prev_to_cur >= 0
    tgt = torch.where(matched, prev_to_cur, 0).to(torch.int64)
    new_len = cur.track_len.index_add(0, tgt, torch.where(matched, prev.track_len, 0))
    new_lm = cur.landmark_slot.scatter_reduce(
        0, tgt, torch.where(matched, prev.landmark_slot, -1), "amax"
    )
    return cur._replace(track_len=new_len, landmark_slot=new_lm)
