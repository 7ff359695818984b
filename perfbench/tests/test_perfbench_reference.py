"""The plain reference, its control and the dense kernel's roofline bound."""

import numpy as np
import pytest

from perfbench import control, generator, reference, spec, synthetic_np, window
from perfbench.roofline import dense_brief

BENCH = spec.load()


def _episode(traj, kf_frames=(), closures=()):
    return window.Episode(frames=len(traj), trajectory=traj, kf_frames=list(kf_frames),
                          closures=list(closures), breaks=0)


def test_truth_against_itself_reads_nothing():
    gt = synthetic_np.circle_trajectory(64, 13.0).astype(np.float64)
    numbers = reference.compare([_episode(gt, range(0, 64, 3))], gt)
    assert numbers["frames_missing"] == 0 and numbers["ate_m"] < 1e-9
    assert numbers["track_m"] < 1e-9 and numbers["track_deg"] < 1e-3


def test_rigid_motion_of_the_whole_trajectory_costs_nothing():
    gt = synthetic_np.circle_trajectory(64, 13.0).astype(np.float64)
    C = np.eye(4)
    c, s = np.cos(0.3), np.sin(0.3)
    C[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    C[:3, 3] = [4.0, -2.0, 1.0]
    numbers = reference.compare([_episode(C @ gt, range(0, 64, 3))], gt)
    assert numbers["ate_m"] < 1e-9 and numbers["track_m"] < 1e-9


def test_a_jump_between_segments_is_the_pose_graph_s_and_not_tracking():
    gt = synthetic_np.circle_trajectory(12, 13.0).astype(np.float64)
    est = gt.copy()
    est[6:, 0, 3] += 0.2  # a correction of the segments from frame 6 on
    numbers = reference.compare([_episode(est, [5, 11])], gt)
    assert numbers["track_m"] < 1e-9 and numbers["ate_m"] > 0.05
    numbers = reference.compare([_episode(est, [8, 11])], gt)
    assert abs(numbers["track_m"] - 0.2) < 1e-6


def test_missing_and_non_finite_poses_count():
    gt = synthetic_np.circle_trajectory(10, 13.0).astype(np.float64)
    est = gt.copy()
    est[4] = np.nan
    ep = _episode(est[:8])
    ep.frames = 10
    numbers = reference.compare([ep], gt)
    assert numbers["frames_missing"] == 3
    ok, rows = reference.decide(numbers, {"frames_missing": 0})
    assert not ok and rows == [["frames_missing", 3.0, 0.0]]


def _loop(n=96):
    """A 1.5-lap circle with keyframes every 4 frames and a closure from
    each keyframe of the second lap to the keyframe of the first at the
    same place, T_ref_query the truth's."""
    gt = synthetic_np.circle_trajectory(n, 13.0, n / 64).astype(np.float64)
    kf = list(range(3, n, 4))
    clo = [(q, q - 16, np.linalg.inv(gt[kf[q - 16]]) @ gt[kf[q]]) for q in range(16, len(kf))]
    return gt, kf, clo


def test_closures_of_the_truth_read_nothing():
    gt, kf, clo = _loop()
    numbers = reference.compare([_episode(gt, kf, clo)], gt)
    assert numbers["closures"] == len(clo) > 0
    assert numbers["loop_m"] < 1e-9 and numbers["closure_m"] < 1e-9


def test_drift_left_uncorrected_at_the_revisit_is_loop_m():
    """The second lap's poses off by 0.3 m, as a drift the pose graph did
    not correct, read 0.3 m at the closures; the closures themselves are
    sound."""
    gt, kf, clo = _loop()
    est = gt.copy()
    est[64:, 1, 3] += 0.3
    numbers = reference.compare([_episode(est, kf, clo)], gt)
    assert abs(numbers["loop_m"] - 0.3) < 1e-9 and numbers["closure_m"] < 1e-9


def test_a_wrong_closure_is_closure_m():
    gt, kf, clo = _loop()
    q, r, T = clo[3]
    T = T.copy()
    T[0, 3] += 0.5
    clo[3] = (q, r, T)
    numbers = reference.compare([_episode(gt, kf, clo)], gt)
    assert abs(numbers["closure_m"] - 0.5) < 1e-9 and numbers["loop_m"] < 1e-9
    assert numbers["closure_m.p50"] < 1e-9


def test_closures_past_the_completed_frames_are_not_read():
    gt, kf, clo = _loop()
    ep = _episode(gt, kf, clo)
    ep.frames = 60  # the episode was cut before the second lap's keyframes
    assert reference.compare([ep], gt)["closures"] == 0


def test_dense_bound_at_kitti_size():
    assert round(1e3 * dense_brief.least_seconds(2, 376, 1241), 4) == 0.0100
    assert round(1e3 * dense_brief.least_seconds(1, 188, 620), 5) == 0.00125
    assert dense_brief.work(2, 376, 1241) == (36 * 2 * 376 * 1241, 256 * 2 * 376 * 1241)
    assert dense_brief.frame_launches(376, 1241, 2) == [(2, 376, 1241), (1, 188, 620),
                                                       (1, 188, 620)]


def test_dense_roofline_reads_only_the_launches_it_counts():
    from perfbench import profile, spec as spec_mod

    read = spec_mod.reader("dense_brief_roofline")
    w = window.Window(cell="x", shape=(376, 1241), octaves=2)
    k2, k3 = dense_brief.least_seconds(2, 376, 1241), dense_brief.least_seconds(1, 188, 620)
    name = "void dense_brief_kernel<8, float, 0>(float const*, int, int, int, int, int, int*)"
    ks = []
    for f in range(4):  # each launch at twice its bound
        ks += [(name, 0, int(2e9 * k2)), (name, 0, int(2e9 * k3)), (name, 0, int(2e9 * k3))]
    w.trace = profile.Slice(frames=4, window_s=1.0, busy_s=0.5, kernels=ks, device_ops=ks,
                            cpu=[])
    assert abs(read(w) - 50.0) < 0.01
    w.trace.kernels = ks[:-1]
    assert read(w) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(cell):
    """The control (the true poses held in bfloat16, at the cell's own
    size) fails the cell's limits on three seeds."""
    w = spec.cell(BENCH, cell)
    config = window.load_config(spec.config_path(BENCH, w["config"]))
    traffic = generator.load_traffic(spec.traffic_path(w["traffic"]))
    for seed in (1, 2**31 + 5, 3_000_000_019):
        out = control.control_run(config, traffic, seed, spec.limits(cell))
        assert not out["correct"], out
