"""FAST-ICP (solve/anderson.py) against the JAX package's fast_icp_align.

  * tests/test_anderson.py's four problems, and a batch of 8 problems
    with mixed numbers of valid correspondences (the batched path): the
    port's transforms within 1e-5 of JAX's (a rotation fit a round, f32:
    JAX's SVD, the port's Horn quaternion), num_inliers and converged
    equal.
  * JAX's four properties for the port alone: exact recovery, robustness
    to outliers, agreement with GN ICP (aligners.icp_align, translations
    within 5e-3 m) and a fast descent in 6 rounds.
  * The closed-loop engine with aligner_type FAST-ICP on
    tests/test_torch_closed_loop.py's 48-frame circle, border 12 (both
    packages take the staged front-end): JAX's closure events.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.ops import lie as jlie
from vslam_tpu.solve import anderson as janderson
from vslam_tpu.solve import aligners as jaligners
from vslam_tpu.solve import gn as jgn
from vslam_tpu_torch.solve import aligners as taligners
from vslam_tpu_torch.solve import anderson as tanderson
from vslam_tpu_torch.solve import gn as tgn

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

T_ATOL = 1e-5


def make_problem(rng, n=120, noise=0.0, outliers=0):
    """tests/test_anderson.py's problem: n points, a fixed twist, noise and
    outliers added to the fixed set."""
    xi = np.array([0.4, -0.2, 0.3, 0.05, -0.08, 0.12], np.float32)
    T_true = np.asarray(jlie.exp_se3(jnp.asarray(xi)))
    p_mov = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    p_fix = p_mov @ T_true[:3, :3].T + T_true[:3, 3]
    p_fix += rng.normal(0, noise, p_fix.shape).astype(np.float32)
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        p_fix[idx] += rng.uniform(3, 8, (outliers, 3)).astype(np.float32)
    return p_mov, p_fix.astype(np.float32), T_true


# (noise, outliers, kernel) of tests/test_anderson.py's four cases.
CASES = {"exact": (0.0, 0, 1.0), "outliers": (0.01, 25, 0.5), "gn-match": (0.005, 0, 0.5),
         "descent": (0.02, 30, 0.3)}


def _jax(p_mov, p_fix, mask, kernel, max_rounds=30):
    data = jaligners.ICPData(p_moving=jnp.asarray(p_mov), p_fixed=jnp.asarray(p_fix),
                             weight=jnp.ones(len(p_mov), jnp.float32))
    return janderson.fast_icp_align(
        data, jnp.asarray(mask), jnp.eye(4),
        jgn.GNConfig(kernel_max_error=kernel, min_num_inliers=20), max_rounds=max_rounds)


def _port(p_mov, p_fix, mask, kernel, max_rounds=30, T0=None):
    """Batched: p_mov, p_fix (B, N, 3), mask (B, N)."""
    B = p_mov.shape[0]
    data = taligners.ICPData(p_moving=torch.from_numpy(p_mov), p_fixed=torch.from_numpy(p_fix),
                             weight=torch.ones(p_mov.shape[:2]))
    T0 = torch.eye(4).expand(B, 4, 4) if T0 is None else T0
    return tanderson.fast_icp_align(
        data, torch.from_numpy(mask), T0,
        tgn.GNConfig(kernel_max_error=kernel, min_num_inliers=20), max_rounds=max_rounds)


@pytest.mark.parametrize("case", list(CASES))
def test_fast_icp_matches_jax(case):
    noise, outliers, kernel = CASES[case]
    p_mov, p_fix, _ = make_problem(np.random.default_rng(11), noise=noise, outliers=outliers)
    mask = np.ones(len(p_mov), bool)
    want = _jax(p_mov, p_fix, mask, kernel)
    got = _port(p_mov[None], p_fix[None], mask[None], kernel)
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x), atol=T_ATOL)
    assert int(got.num_inliers[0]) == int(want.num_inliers)
    assert bool(got.converged[0]) == bool(want.converged)
    np.testing.assert_array_equal(got.inlier_mask[0].numpy(), np.asarray(want.inlier_mask))


def test_batched_fast_icp_matches_jax_per_problem():
    """8 problems of 120 rows, each with its own number of valid rows (the
    rest masked and filled with junk), solved in one batched call."""
    rng = np.random.default_rng(5)
    n_valid = [120, 97, 64, 120, 33, 80, 110, 50]
    movs, fixs, masks = [], [], []
    for i, n in enumerate(n_valid):
        p_mov, p_fix, _ = make_problem(rng, noise=0.01 * (i % 3), outliers=(i % 4) * 5)
        mask = np.arange(120) < n
        p_fix[~mask] = rng.uniform(-50, 50, (120 - n, 3))
        movs.append(p_mov)
        fixs.append(p_fix)
        masks.append(mask)
    got = _port(np.stack(movs), np.stack(fixs), np.stack(masks), 0.5)
    for i in range(len(n_valid)):
        want = _jax(movs[i], fixs[i], masks[i], 0.5)
        np.testing.assert_allclose(got.x[i].numpy(), np.asarray(want.x), atol=T_ATOL,
                                   err_msg=f"problem {i}")
        assert int(got.num_inliers[i]) == int(want.num_inliers), i
        assert bool(got.converged[i]) == bool(want.converged), i


# JAX's own four properties (tests/test_anderson.py), for the port alone.

def test_port_fast_icp_exact():
    p_mov, p_fix, T_true = make_problem(np.random.default_rng(1))
    res = _port(p_mov[None], p_fix[None], np.ones((1, 120), bool), 1.0)
    assert bool(res.converged[0])
    np.testing.assert_allclose(res.x[0].numpy(), T_true, atol=1e-4)


def test_port_fast_icp_robust_to_outliers():
    p_mov, p_fix, T_true = make_problem(np.random.default_rng(2), noise=0.01, outliers=25)
    res = _port(p_mov[None], p_fix[None], np.ones((1, 120), bool), 0.5)
    assert bool(res.converged[0])
    assert np.linalg.norm(res.x[0, :3, 3].numpy() - T_true[:3, 3]) < 0.02
    assert int(res.num_inliers[0]) >= 90


def test_port_fast_icp_matches_gn_icp():
    p_mov, p_fix, _ = make_problem(np.random.default_rng(3), noise=0.005)
    cfg = tgn.GNConfig(kernel_max_error=0.5, min_num_inliers=20)
    data = taligners.ICPData(p_moving=torch.from_numpy(p_mov)[None],
                             p_fixed=torch.from_numpy(p_fix)[None], weight=torch.ones(1, 120))
    mask = torch.ones(1, 120, dtype=torch.bool)
    r_aa = tanderson.fast_icp_align(data, mask, torch.eye(4)[None], cfg)
    r_gn = taligners.icp_align(data, mask, torch.eye(4)[None], cfg)
    assert np.linalg.norm((r_aa.x[0, :3, 3] - r_gn.x[0, :3, 3]).numpy()) < 5e-3


def test_port_anderson_accelerates_descent():
    p_mov, p_fix, T_true = make_problem(np.random.default_rng(4), noise=0.02, outliers=30)
    res = _port(p_mov[None], p_fix[None], np.ones((1, 120), bool), 0.3, max_rounds=6)
    assert np.linalg.norm(res.x[0, :3, 3].numpy() - T_true[:3, 3]) < 0.05


def test_closed_loop_engine_with_fast_icp_matches_jax():
    from vslam_tpu.io.config import ParameterCollection as JConfig
    from vslam_tpu.ops import camera as jcam
    from vslam_tpu.system.engine import SlamEngine as JEngine
    from vslam_tpu_torch.eval import trajectory as ttraj
    from vslam_tpu_torch.io import synthetic as tsyn
    from vslam_tpu_torch.io.config import ParameterCollection as TConfig
    from vslam_tpu_torch.ops import camera as tcam
    from vslam_tpu_torch.system.engine import SlamEngine as TEngine

    cam_args = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4, rows=192,
                    cols=512)

    def config(cls):
        cfg = cls()
        cfg.framepoint_generation.capacity = 256
        cfg.framepoint_generation.bin_size_pixels = 16
        cfg.framepoint_generation.border_pixels = 12  # both: the staged front-end
        cfg.world_map.minimum_distance_traveled_for_local_map = 0.8
        cfg.world_map.minimum_number_of_frames_for_local_map = 2
        cfg.relocalization.preliminary_minimum_interspace_queries = 6
        cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
        cfg.relocalization.icp_minimum_number_of_inliers = 8
        cfg.relocalization.icp_minimum_inlier_ratio = 0.3
        cfg.relocalization.aligner_type = "FAST-ICP"
        cfg.parallelism.shard_descriptor_db = False  # one device, as the port
        cfg.parallelism.shard_landmarks = False
        return cfg

    world = tsyn.make_world(tcam.make_camera(**cam_args, device="cpu"), n_points=1500,
                            seed=21, poses=tsyn.circle_trajectory(48, radius=7.0))
    frames = [tsyn.render_frame(world, t)[:2] for t in range(48)]
    jeng = JEngine(jcam.make_camera(**cam_args), config(JConfig), landmark_capacity=8192)
    teng = TEngine(tcam.make_camera(**cam_args, device="cpu"), config(TConfig),
                   landmark_capacity=8192, device="cpu")
    for f in frames:
        jeng.process(*f)
        teng.process(*f)
    jrep, trep = jeng.report(), teng.report()
    for k in ("n_local_maps", "n_closures", "n_optimizations", "n_track_breaks"):
        assert trep[k] == jrep[k], k
    assert trep["n_closures"] >= 1
    jcl = [(c.query_id, c.reference_id) for c in jeng.world_map.closures]
    tcl = [(c.query_id, c.reference_id) for c in teng.world_map.closures]
    assert tcl == jcl
    for a, b in zip(teng.world_map.closures, jeng.world_map.closures):
        np.testing.assert_allclose(a.T_ref_query, np.asarray(b.T_ref_query), atol=1e-3)
    ate = ttraj.ate_rmse(teng.trajectory, world.poses)[0]
    assert ate <= 0.10, ate
