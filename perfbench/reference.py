"""The plain reference that decides `correct`: the poses the frames were
rendered from (synthetic_np, the benchmark's own generator, made from
the seed), and plain numpy comparisons of the program's answers with
them.  Nothing here imports the program.

SLAM's answer to a stereo sequence is the trajectory of the camera that
took it, and on rendered frames that trajectory is known exactly.  The
numbers, over every frame whose pose reached the host in the window
(every episode, the one cut off up to its last completed handle):

  frames_missing  frames handed to the engine without a finite pose
  track_m         the largest gap between the program's frame-to-frame
                  motion and the true one, translation (m) ...
  track_deg       ... and rotation (degrees), over the pairs of frames
                  that belong to one keyframe's segment: front end, pose
                  solve, landmark table and recovery.  The engine moves
                  each segment (the frames up to and including a
                  keyframe) by that keyframe's pose-graph or BA
                  correction, rigidly, so inside a segment the tracker's
                  motion stands as it was computed
  loop_m          the corrected keyframe poses at every closure: the
                  largest gap (m) between the program's relative pose of a
                  closure's two keyframes, as the final trajectory holds
                  them after the pose graph's corrections, and the true
                  one.  Without the pose graph this is the drift between
                  the two visits of a place
  closure_m       the relocalizer's closures: the largest gap (m) between
                  a closure's relative pose (T_ref_query, its ICP) and the
                  true one between its keyframes' frames
  loop_m.p50, .p90, closure_m.p50, .p90
                  the median and 90th percentile of the same gaps
  closures        closures whose keyframes' poses reached the host
  ate_m           the largest ATE RMSE of an episode (rigid alignment)

The numbers a cell compares, and their limits, are in
perfbench/limits/<cell>.json; PERF.md section 2 gives the readings each
limit was set from.
"""

from __future__ import annotations

import numpy as np


def _inv(T: np.ndarray) -> np.ndarray:
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = np.zeros_like(T)
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def _angle_deg(R: np.ndarray) -> np.ndarray:
    """The rotation angle of R, from its cosine and sine together (the
    arccos of the trace alone loses ~0.02 deg to rounding near 0)."""
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) * 0.5
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    return np.degrees(np.arctan2(0.5 * np.linalg.norm(w, axis=-1), c))


def relative_gap(A: np.ndarray, B: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(translation m, rotation deg) between relative poses A and B."""
    E = _inv(B) @ A
    return np.linalg.norm(A[..., :3, 3] - B[..., :3, 3], axis=-1), _angle_deg(E[..., :3, :3])


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE RMSE of positions after the rigid alignment (no scale) of the
    estimate onto the truth (Horn / Umeyama)."""
    p, q = est[:, :3, 3], gt[:, :3, 3]
    mp, mq = p.mean(0), q.mean(0)
    U, _, Vt = np.linalg.svd((p - mp).T @ (q - mq))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    err = q - (p @ R.T + (mq - R @ mp))
    return float(np.sqrt((err ** 2).sum(1).mean()))


def segments(kf_frames, n: int) -> np.ndarray:
    """The keyframe that owns each of n frames, as the engine assigns its
    corrections: the first keyframe at or after the frame (the last one
    for frames after it)."""
    if len(kf_frames) == 0:
        return np.zeros(n, np.int64)
    return np.clip(np.searchsorted(np.asarray(kf_frames), np.arange(n), side="left"),
                   0, len(kf_frames) - 1)


def _pairs(ep) -> list:
    """(reference frame, query frame, T_ref_query) of each closure of an
    episode whose two keyframes' poses reached the host."""
    out = []
    for q, ref, T in ep.closures:
        if max(q, ref) < len(ep.kf_frames):
            fq, fr = ep.kf_frames[q], ep.kf_frames[ref]
            if max(fq, fr) < ep.frames:
                out.append((fr, fq, T))
    return out


def compare(episodes, gt: np.ndarray) -> dict:
    """The numbers of the module docstring over the window's episodes."""
    missing = 0
    track_t, track_r, ate, loop_t, clo_t = [0.0], [0.0], [0.0], [], []
    n_closures = 0
    for ep in episodes:
        traj = ep.trajectory[:ep.frames]
        finite = np.isfinite(traj).all(axis=(1, 2))
        missing += ep.frames - int(finite.sum())
        n = len(traj)
        if n >= 2 and finite.all():
            t, r = relative_gap(_inv(traj[:-1]) @ traj[1:], _inv(gt[:n - 1]) @ gt[1:n])
            owner = segments(ep.kf_frames, n)
            same = owner[:-1] == owner[1:]
            if same.any():
                track_t.append(float(t[same].max()))
                track_r.append(float(r[same].max()))
        if n >= 3 and finite.all():
            ate.append(ate_rmse(traj, gt[:n]))
        pairs = _pairs(ep)
        n_closures += len(pairs)
        if pairs and finite.all():
            fr = np.array([p[0] for p in pairs])
            fq = np.array([p[1] for p in pairs])
            truth = _inv(gt[fr]) @ gt[fq]
            loop_t.extend(relative_gap(_inv(traj[fr]) @ traj[fq], truth)[0].tolist())
            clo_t.extend(relative_gap(np.stack([p[2] for p in pairs]), truth)[0].tolist())
    numbers = {"frames_missing": float(missing), "track_m": max(track_t),
               "track_deg": max(track_r), "ate_m": max(ate), "closures": float(n_closures)}
    for name, vals in (("loop_m", loop_t), ("closure_m", clo_t)):
        if vals:
            numbers[name] = float(np.max(vals))
            numbers[name + ".p50"] = float(np.median(vals))
            numbers[name + ".p90"] = float(np.percentile(vals, 90))
    return numbers


def decide(numbers: dict, limits: dict) -> tuple[bool, list]:
    """correct, and [name, number, limit] for every number the cell
    compares (its limits file).  A number the cell compares but the run
    did not produce is not correct."""
    rows, ok = [], True
    for name, lim in limits.items():
        lim = float(lim)
        val = numbers.get(name)
        if val is None or not np.isfinite(val) or val > lim:
            ok = False
        rows.append([name, val, lim])
    return ok, rows
