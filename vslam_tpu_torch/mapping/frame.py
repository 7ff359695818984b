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

from vslam_tpu_torch.frontend import brief, depth, detect, fast_brief, matching
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
    ext.index_put_((torch.where(use, idx.to(torch.int64), n),),
                   torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
                   .expand((idx.shape[0],) + arr.shape[1:]))
    return ext[:n]


def _add_delta(arr: torch.Tensor, tgt: torch.Tensor, use: torch.Tensor, val):
    """arr.at[tgt].add(where(use, val - arr[tgt], 0)) — the JAX package's
    predicated add-delta scatter, kept so float rows round identically."""
    u = use.reshape((-1,) + (1,) * (arr.dim() - 1))
    delta = torch.where(u, val - arr[tgt], torch.zeros((), dtype=arr.dtype,
                                                          device=arr.device))
    return arr.index_add(0, tgt, delta)


def _pyramid_descriptors(img_l, img_r, kl, kr, capacity, octaves):
    """Per-octave dense-BRIEF description: each octave's static slice of
    the keypoints gathers from the planes of its own pyramid level (K2
    for level 0 of both images, K3 for each image at each level >= 1); at
    one octave this is the plain level-0 lookup.
    Returns (dl (K, 8), dr (K, 8), level-0 planes (2, 8, H, W))."""
    planes0 = brief.dense_planes_pair(img_l, img_r)
    dl_parts, dr_parts = [], []
    lvl_l, lvl_r = img_l, img_r
    start = 0
    for o, cap_o in enumerate(detect.octave_capacities(capacity, octaves)):
        if o == 0:
            pl_l, pl_r = planes0[0], planes0[1]
        else:
            lvl_l = detect.downsample2(lvl_l)
            lvl_r = detect.downsample2(lvl_r)
            pl_l = brief.dense_planes(lvl_l)
            pl_r = brief.dense_planes(lvl_r)
        s = float(1 << o)
        sl = slice(start, start + cap_o)
        dl_parts.append(brief.gather_descriptors(
            pl_l, lvl_l.shape, (kl.uv[sl] - (s - 1.0) / 2.0) / s))
        dr_parts.append(brief.gather_descriptors(
            pl_r, lvl_r.shape, (kr.uv[sl] - (s - 1.0) / 2.0) / s))
        start += cap_o
    return torch.cat(dl_parts), torch.cat(dr_parts), planes0


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

    BRIEF256 at one octave with border >= 16 runs the fused kernel K1
    (exact only >= 16 px from the edge); everything else runs the staged
    front-end: FAST over the pyramid, then dense BRIEF planes (K2, K3) or
    rotated-bank planes (K4).  With want_planes the level-0 planes of both
    images (2, 8, H, W) are returned too, for landmark recovery.
    Returns (FrameState, n_keypoints_left, n_framepoints[, planes])."""
    d_up = detector.upper()
    if d_up not in _FAST_DETECTORS:
        raise NotImplementedError(
            f"detector {detector!r} is not ported yet (ROADMAP Queue 1 item 14)")
    if descriptor == "ORB256":
        raise NotImplementedError(
            "descriptor 'ORB256' (rotation-aware gather BRIEF) is not ported yet "
            "(ROADMAP Queue 1 item 14)")
    H, W = img_l.shape
    if descriptor == "BRIEF256" and octaves == 1 and border >= 16:
        planes, score, rowmax, rowarg = fast_brief.fast_brief_frontend_pair(
            torch.stack([img_l, img_r]).to(torch.float32), threshold,
            arc_len=12 if d_up == "FAST12" else 9, border=border, bin_size=bin_size,
        )
        if bin_size == fast_brief.BAND:
            uv, sc, va = fast_brief.keypoints_from_band_reduction(
                rowmax, rowarg, H, W, bin_size, capacity)
            kl = fast_brief.Keypoints(uv[0], sc[0], va[0])
            kr = fast_brief.Keypoints(uv[1], sc[1], va[1])
        else:
            kl = fast_brief.Keypoints(*detect.keypoints_from_score(
                score[0], bin_size, capacity, border))
            kr = fast_brief.Keypoints(*detect.keypoints_from_score(
                score[1], bin_size, capacity, border))
        dl = brief.gather_descriptors(planes[0], (H, W), kl.uv)
        dr = brief.gather_descriptors(planes[1], (H, W), kr.uv)
    else:
        kl = detect.detect_keypoints(img_l, threshold, bin_size, capacity, border,
                                     detector, octaves=octaves)
        kr = detect.detect_keypoints(img_r, threshold, bin_size, capacity, border,
                                     detector, octaves=octaves)
        planes = None
        if descriptor == "BRIEF256R":
            # Rotated-bank descriptors; landmark recovery re-describes from
            # the upright level-0 planes, as the JAX package does.
            dl = brief.describe_dense_rotated(img_l, kl.uv)
            dr = brief.describe_dense_rotated(img_r, kr.uv)
            if want_planes:
                planes = brief.dense_planes_pair(img_l, img_r)
        else:
            dl, dr, planes = _pyramid_descriptors(img_l, img_r, kl, kr, capacity,
                                                  octaves)
    return _stereo_frontend_tail(
        cam, kl, kr, dl, dr, planes if want_planes else None,
        max_hamming_stereo, epipolar_tol, min_disparity, max_disparity,
        capacity, want_planes,
    )


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
    z_cap = (cam.fx * cam.baseline_m).expand_as(disp) / max(float(min_disparity), 0.25)
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
    intensity image (one K3 launch; one per level with octaves); with
    want_planes the (8, H, W) level-0 planes are returned too, for
    landmark recovery.
    Returns (FrameState, n_keypoints, n_framepoints[, planes])."""
    if descriptor == "ORB256":
        raise NotImplementedError(
            "descriptor 'ORB256' (rotation-aware gather BRIEF) is not ported yet "
            "(ROADMAP Queue 1 item 14)")
    kp = detect.detect_keypoints(img, threshold, bin_size, capacity, border, detector,
                                 octaves=octaves)
    planes = None
    if descriptor == "BRIEF256R":
        desc = brief.describe_dense_rotated(img, kp.uv)
        if want_planes:
            planes = brief.dense_planes(img)
    else:
        parts, lvl, start = [], img, 0
        for o, cap_o in enumerate(detect.octave_capacities(capacity, octaves)):
            if o > 0:
                lvl = detect.downsample2(lvl)
            pl = brief.dense_planes(lvl)
            if o == 0:
                planes = pl
            s = float(1 << o)
            sl = slice(start, start + cap_o)
            parts.append(brief.gather_descriptors(pl, lvl.shape,
                                                  (kp.uv[sl] - (s - 1.0) / 2.0) / s))
            start += cap_o
        desc = torch.cat(parts)
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
    """Track prev framepoints into cur and solve for the camera motion."""
    p_pred = lie.transform_point_cloud(T_guess, prev.p_cam)
    proj_uv, z_pred = cam_ops.project(cam, p_pred)
    predictable = prev.valid & (z_pred > 0.05)
    m = matching.match_projective(
        proj_uv, prev.desc, predictable,
        cur.uv4[:, :2], cur.desc, cur.valid,
        radius_px, max_hamming,
    )
    matched = m.valid & predictable
    # Temporary points inform rotation but get a small weight so their
    # capped depth cannot bias translation.
    weights = torch.where(prev.reliable, point_weights, 0.2 * point_weights)
    data = aligners.StereoUVData(
        p_prev=prev.p_cam, meas=cur.uv4[m.cur_idx.to(torch.int64)], weight=weights,
    )
    res = aligners.stereo_uv_align_fast(cam, data, matched, T_guess, gn_config)
    return TrackResult(
        T_cur_prev=res.x,
        prev_to_cur=torch.where(matched, m.cur_idx, -1).to(torch.int32),
        n_matches=matched.sum(dtype=torch.int32),
        n_inliers=res.num_inliers,
        mean_chi2=res.chi2,
        converged=res.converged,
    )


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
    p_pred = lie.transform_point_cloud(T_guess, prev.p_cam)
    proj_uv, z_pred = cam_ops.project(cam, p_pred)
    predictable = prev.valid & (z_pred > 0.05)
    m = matching.match_projective(
        proj_uv, prev.desc, predictable,
        cur.uv4[:, :2], cur.desc, cur.valid,
        radius_px, max_hamming,
    )
    matched = m.valid & predictable
    meas = cur.uv4[m.cur_idx.to(torch.int64)][:, :3]
    data = aligners.UVDData(p_prev=prev.p_cam, meas=meas, weight=point_weights,
                            depth_reliable=meas[:, 2] > 0.01)
    res = aligners.uvd_align(cam, data, matched, T_guess, gn_config)
    return TrackResult(
        T_cur_prev=res.x,
        prev_to_cur=torch.where(matched, m.cur_idx, -1).to(torch.int32),
        n_matches=matched.sum(dtype=torch.int32),
        n_inliers=res.num_inliers,
        mean_chi2=res.chi2,
        converged=res.converged,
    )


def recover_lost_landmarks(
    cam: cam_ops.CameraParams,
    prev: FrameState,
    cur: FrameState,
    motion: torch.Tensor,  # (4, 4) T_cur_prev from the pose solve
    prev_to_cur: torch.Tensor,  # (K,) match indices, -1 = lost
    planes: torch.Tensor,  # (2, 8, H, W) dense BRIEF planes
    img_shape,
    desc_gate,
    min_disparity,
    max_disparity,
    border: int = 20,
    enabled=True,
):
    """Landmark recovery (reference recoverPoints): landmark-backed points
    of the previous frame that found no match are re-acquired at their
    solved-pose projections by a descriptor lookup in both images, gated
    on descriptor distance, field of view and disparity, re-triangulated
    and appended after the valid block of cur.  Returns (cur', n)."""
    lost = prev.valid & (prev.landmark_slot >= 0) & (prev_to_cur < 0)
    p_pred = lie.transform_point_cloud(motion, prev.p_cam)
    uv_l, uv_r, z = cam_ops.project_stereo(cam, p_pred)
    vis = (cam_ops.in_field_of_view(cam, uv_l, z, border)
           & cam_ops.in_field_of_view(cam, uv_r, z, border))
    dl = brief.gather_descriptors(planes[0], img_shape, uv_l)
    dr = brief.gather_descriptors(planes[1], img_shape, uv_r)
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
    planes: torch.Tensor,  # (8, H, W) dense BRIEF planes of the intensity image
    depth_m: torch.Tensor,  # registered depth (meters)
    desc_gate,
    min_depth,
    max_depth,
    border: int = 20,
    enabled=True,
    max_depth_error_ratio: float = 0.2,
):
    """RGB-D landmark recovery (reference DepthFramePointGenerator::
    recoverPoints): lost landmark-backed points are re-acquired at their
    solved-pose projections, the descriptor looked up in the dense planes
    and the depth in the registered map, gated on descriptor distance, the
    depth range and predicted-vs-measured depth.  Returns (cur', n)."""
    lost = prev.valid & (prev.landmark_slot >= 0) & (prev_to_cur < 0)
    p_pred = lie.transform_point_cloud(motion, prev.p_cam)
    uv, z_pred = cam_ops.project(cam, p_pred)
    vis = cam_ops.in_field_of_view(cam, uv, z_pred, border)
    d = brief.gather_descriptors(planes, depth_m.shape, uv)
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
