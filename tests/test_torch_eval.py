"""The port's quaternions, trajectory files, RPE and g2o files against the
JAX package on the CPU.

Tolerances: quat_to_rot within 1e-6 of JAX (measured: equal bits);
trajectory and g2o files byte-identical to JAX's for the same poses;
RPE within 1e-12; the readers return JAX's arrays exactly; each g2o
reader round-trips its writer (translations 1e-6, rotations 1e-4, the
file's digits).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.eval import trajectory as jtraj
from vslam_tpu.io import g2o_io as jg2o
from vslam_tpu.ops import lie as jlie
from vslam_tpu_torch.eval import trajectory as ttraj
from vslam_tpu_torch.io import g2o_io as tg2o
from vslam_tpu_torch.ops import lie as tlie

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _poses(n, seed, dtype=np.float64):
    """A random walk of n poses (f32 rotations from JAX's exp, as an
    engine's poses are)."""
    rng = np.random.default_rng(seed)
    T = np.eye(4)
    out = []
    for _ in range(n):
        xi = np.concatenate([rng.normal(0, 0.5, 3), rng.normal(0, 0.3, 3)]).astype(np.float32)
        T = T @ np.asarray(jlie.exp_se3(jnp.asarray(xi)), dtype=np.float64)
        out.append(T)
    return np.stack(out).astype(dtype)


def test_quat_to_rot_matches_jax_and_round_trips():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(512, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got = tlie.quat_to_rot(torch.from_numpy(q)).numpy()
    ref = np.asarray(jlie.quat_to_rot(jnp.asarray(q)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # rot_to_quat takes it back (up to the sign that makes w >= 0).
    back = tlie.rot_to_quat(torch.from_numpy(got)).numpy()
    q_pos = q * np.where(q[:, :1] < 0, -1.0, 1.0)
    np.testing.assert_allclose(back, q_pos, atol=2e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_trajectory_files_are_byte_identical_to_jax(tmp_path, dtype):
    poses = _poses(40, 1, dtype)
    ts = np.arange(40) * 0.1 + 1305031102.175304
    for name, write_t, write_j, args in (
        ("kitti", ttraj.write_kitti, jtraj.write_kitti, ()),
        ("tum", ttraj.write_tum, jtraj.write_tum, (ts,)),
        ("tum_no_ts", ttraj.write_tum, jtraj.write_tum, ()),
    ):
        write_t(str(tmp_path / f"{name}_port.txt"), poses, *args)
        write_j(str(tmp_path / f"{name}_jax.txt"), poses, *args)
        assert ((tmp_path / f"{name}_port.txt").read_bytes()
                == (tmp_path / f"{name}_jax.txt").read_bytes()), name


def test_trajectory_readers_match_jax(tmp_path):
    poses = _poses(30, 2)
    ts = np.arange(30) * 0.05
    jtraj.write_kitti(str(tmp_path / "k.txt"), poses)
    jtraj.write_tum(str(tmp_path / "t.txt"), poses, ts)
    np.testing.assert_array_equal(ttraj.read_kitti(str(tmp_path / "k.txt")),
                                  jtraj.read_kitti(str(tmp_path / "k.txt")))
    ts_t, p_t = ttraj.read_tum(str(tmp_path / "t.txt"))
    ts_j, p_j = jtraj.read_tum(str(tmp_path / "t.txt"))
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_allclose(p_t[:, :3, 3], poses[:, :3, 3], atol=1e-6)


def test_rpe_and_association_match_jax():
    gt = _poses(50, 3)
    rng = np.random.default_rng(4)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.02, (50, 3))
    for delta in (1, 5):
        got = ttraj.rpe(est, gt, delta)
        ref = jtraj.rpe(est, gt, delta)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    ts_a = np.sort(rng.uniform(0, 10, 80))
    ts_b = np.sort(rng.uniform(0, 10, 60))
    for max_dt in (0.02, 0.1):
        for a, b in zip(ttraj.associate_timestamps(ts_a, ts_b, max_dt),
                        jtraj.associate_timestamps(ts_a, ts_b, max_dt)):
            np.testing.assert_array_equal(a, b)


def _graph(seed):
    poses = _poses(6, seed)
    edges = [(k, k + 1, np.linalg.inv(poses[k]) @ poses[k + 1], 1.0) for k in range(5)]
    edges.append((5, 0, np.linalg.inv(poses[5]) @ poses[0], 10.0))
    return poses, edges


def test_pose_graph_file_is_byte_identical_and_round_trips(tmp_path):
    poses, edges = _graph(5)
    tg2o.write_pose_graph(str(tmp_path / "port.g2o"), poses, edges)
    jg2o.write_pose_graph(str(tmp_path / "jax.g2o"), poses, edges)
    assert (tmp_path / "port.g2o").read_bytes() == (tmp_path / "jax.g2o").read_bytes()
    p2, e2 = tg2o.read_pose_graph(str(tmp_path / "port.g2o"))
    pj, ej = jg2o.read_pose_graph(str(tmp_path / "port.g2o"))
    np.testing.assert_array_equal(p2, pj)
    np.testing.assert_allclose(p2[:, :3, 3], poses[:, :3, 3], atol=1e-6)
    np.testing.assert_allclose(p2[:, :3, :3], poses[:, :3, :3], atol=1e-4)
    assert len(e2) == len(ej) == 6
    for (i, j, T, w), (ij, jj, Tj, wj) in zip(e2, ej):
        assert (i, j, w) == (ij, jj, wj)
        np.testing.assert_array_equal(T, Tj)
    assert e2[-1][3] == pytest.approx(10.0)


def test_factor_graph_file_is_byte_identical_and_round_trips(tmp_path):
    poses, edges = _graph(6)
    lms = {7: np.array([1.0, 2.0, 3.0]), 42: np.array([-1.0, 0.5, 9.0]),
           3: np.array([0.25, -4.0, 12.5])}
    obs = [(0, 7, np.array([0.5, 0.5, 4.0]), 0.25), (1, 42, np.array([-0.5, 0.2, 8.0]), 0.125),
           (3, 3, np.array([0.1, -0.2, 6.0]), 1.0 / 6.0)]
    for kw in ({}, {"identifier_space": 1000, "free_translation_for_poses": False}):
        tg2o.write_factor_graph(str(tmp_path / "port.g2o"), poses, edges[:5], lms, obs, **kw)
        jg2o.write_factor_graph(str(tmp_path / "jax.g2o"), poses, edges[:5], lms, obs, **kw)
        assert (tmp_path / "port.g2o").read_bytes() == (tmp_path / "jax.g2o").read_bytes()
    p2, e2, l2, o2 = tg2o.read_factor_graph(str(tmp_path / "port.g2o"))
    np.testing.assert_allclose(p2[:, :3, 3], poses[:, :3, 3], atol=1e-6)
    assert set(l2) == {1003, 1007, 1042} and len(e2) == 5
    np.testing.assert_allclose(l2[1042], lms[42], atol=1e-6)
    assert [(kf, gid) for kf, gid, _, _ in o2] == [(0, 1007), (1, 1042), (3, 1003)]
    np.testing.assert_allclose(o2[1][2], obs[1][2], atol=1e-6)
    assert abs(o2[2][3] - 1.0 / 6.0) < 1e-6
