"""The sharded paths (vslam_tpu_torch/parallel/) on gloo ranks on the CPU.

Each run starts 2 or 4 processes (tests/torch_parallel_worker.py) on a
free localhost port and joins them under a 120 s deadline: a hung
collective fails the test (run_ranks kills every rank), it never waits.

  * search_sharded and search_sharded_top2 give a brute-force search's
    indices and distances exactly (first-index arg-min; a masked row
    counts 511), including a database with one rank's whole block masked,
    an all-masked one and per-query eligibility masks (the relocalizer's),
    and JAX's search_sharded / search_sharded_top2 on 8 virtual devices;
  * bundle_adjust_sharded matches the port's one-device bundle_adjust
    (poses 1e-5, points 1e-4 m, chi2 1e-4 relative: the ranks' partial
    systems are summed in another order) and converges;
  * a closed-loop engine with BA on 2 ranks (database and landmarks
    sharded) gives the 1-rank engine's events, trajectory within 1e-2 m
    and ATE within 1e-3 m (JAX's tests/test_parallel.py mesh bound).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.ops import hamming as jhamming
from vslam_tpu.parallel import mesh as jmesh
from vslam_tpu.parallel import sharded_search as jsearch
from vslam_tpu_torch.backend import ba as tba
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.ops import lie as tlie
from vslam_tpu_torch.parallel import launch
from vslam_tpu_torch.parallel import mesh as tmesh

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
TIMEOUT_S = 120
BA_ITERATIONS = 8
SENTINEL = 511
PX_NOISE = 0.5


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32).view(np.int32)


def _inputs():
    rng = np.random.default_rng(13)
    out = {}
    D, Q = 1024, 64  # tests/test_parallel.py's search case
    db = _words(rng, (D, 8))
    q = db[rng.choice(D, Q, replace=False)].copy()
    q[:Q // 2, 0] ^= 0b1011
    valid = np.ones(D, bool)
    valid[100:120] = False
    out.update(search_q=q, search_db=db, search_valid=valid)
    for case, masked in (("top2", slice(0, 512 // 8)), ("top2_shard_masked", slice(0, 128))):
        D, Q = 512, 32
        db = _words(rng, (D, 8))
        q = db[rng.choice(D, Q, replace=False)].copy()
        q[:Q // 2, 1] ^= 0b111
        valid = np.ones(D, bool)
        valid[masked] = False  # 128: rank 0's whole block at 4 ranks
        out.update({f"{case}_q": q, f"{case}_db": db, f"{case}_valid": valid})
    db = _words(rng, (256, 8))
    out.update(all_masked_q=db[:8].copy(), all_masked_db=db,
               all_masked_valid=np.zeros(256, bool))
    db = _words(rng, (512, 8))
    q = db[rng.choice(512, 16, replace=False)].copy()
    q[::2, 3] ^= 0b110001
    out.update(per_query_q=q, per_query_db=db,
               per_query_valid=rng.random((16, 512)) < 0.6)
    for k, v in _ba_problem().items():
        out["ba_" + k] = v
    out["ba_iterations"] = np.asarray(BA_ITERATIONS)
    return out


def _ba_problem(P=5, L=128, O=5):
    """tests/test_backend.py's make_ba_problem in numpy: cameras along a
    line, a point cloud 8-25 m ahead seen by every camera, perturbed
    initial poses (camera 0 the gauge) and points; L divides by 4.  The
    measurements carry PX_NOISE pixels of noise, so that the converged
    chi2 is the noise's (noise-free it falls to f32 round-off, where a
    relative tolerance means nothing)."""
    rng = np.random.default_rng(11)
    T_gt = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    T_gt[:, :3, 3] = np.stack([0.3 * np.arange(P), np.zeros(P), 0.5 * np.arange(P)], 1)
    xyz_gt = np.stack([rng.uniform(-8, 8, L), rng.uniform(-3, 3, L), rng.uniform(8, 25, L)],
                      1).astype(np.float32)
    obs_cam = np.stack([rng.permutation(P)[:O] for _ in range(L)]).astype(np.int64)
    pc = xyz_gt[:, None] - T_gt[obs_cam][..., :3, 3]  # identity rotations
    fx, cx, cy, b = 500.0, 320.0, 160.0, 0.4
    u = fx * pc[..., 0] / pc[..., 2] + cx
    v = fx * pc[..., 1] / pc[..., 2] + cy
    uv4 = np.stack([u, v, u - fx * b / pc[..., 2], v], -1)
    uv4 = (uv4 + rng.normal(0, PX_NOISE, uv4.shape)).astype(np.float32)
    T_init = T_gt.copy()
    for k in range(1, P):
        xi = np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.05 / 3, 3)].astype(np.float32)
        T_init[k] = T_gt[k] @ tlie.exp_se3(torch.from_numpy(xi)).numpy()
    return dict(T_wc=T_init, xyz=(xyz_gt + rng.normal(0, 0.3, (L, 3))).astype(np.float32),
                obs_cam=obs_cam, obs_uv4=uv4, obs_weight=np.ones((L, O), np.float32),
                obs_mask=np.ones((L, O), bool), lm_valid=np.ones(L, bool),
                cam_fixed=np.arange(P) == 0, T_gt=T_gt)


def _run(mode, world, src, tmp):
    port = launch.free_port()
    out = str(tmp / f"{mode}_w{world}_rank")
    argv = lambda r: [sys.executable, WORKER, mode, str(r), str(world), str(port), src, out]
    launch.run_ranks(argv, world, TIMEOUT_S)
    return [dict(np.load(f"{out}{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def ranks(request, inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"parallel{request.param}")
    src = str(tmp / "inputs.npz")
    np.savez(src, **{k: v for k, v in inputs.items() if k != "ba_T_gt"})
    return request.param, _run("kernels", request.param, src, tmp)


def _brute(q, db, valid):
    d = jhamming.hamming_matrix(jnp.asarray(q.view(np.uint32)),
                                jnp.asarray(db.view(np.uint32)))
    d = np.where(np.broadcast_to(valid, np.shape(d)), np.asarray(d), SENTINEL)
    order = np.argsort(d, axis=1, kind="stable")
    rows = np.arange(len(q))
    return order[:, 0], d[rows, order[:, 0]], d[rows, order[:, 1]]


@pytest.mark.parametrize("case", ["search", "top2", "top2_shard_masked", "all_masked",
                                  "per_query"])
def test_sharded_search_is_exact(ranks, inputs, case):
    world, outs = ranks
    idx, d1, d2 = _brute(inputs[case + "_q"], inputs[case + "_db"], inputs[case + "_valid"])
    for r, out in enumerate(outs):  # every rank holds the global answer
        got = out[case]
        np.testing.assert_array_equal(got[0], idx, err_msg=f"rank {r} of {world}")
        np.testing.assert_array_equal(got[1], d1, err_msg=f"rank {r} of {world}")
        if case != "search":
            np.testing.assert_array_equal(got[2], d2, err_msg=f"rank {r} of {world}")
    if case == "all_masked":
        assert (outs[0][case][1] == SENTINEL).all() and (outs[0][case][2] == SENTINEL).all()


@pytest.mark.parametrize("case", ["search", "top2", "top2_shard_masked", "all_masked"])
def test_sharded_search_matches_jax_on_8_devices(ranks, inputs, case):
    _, outs = ranks
    q, db, valid = (jnp.asarray(inputs[case + k]) for k in ("_q", "_db", "_valid"))
    q, db = q.view(jnp.uint32), db.view(jnp.uint32)
    mesh = jmesh.make_mesh()
    if case == "search":
        want = jsearch.search_sharded(q, db, valid, mesh)
    else:
        want = jsearch.search_sharded_top2(q, db, valid, mesh)
    for a, b in zip(outs[0][case], want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_sharded_ba_matches_one_device(ranks, inputs):
    world, outs = ranks
    cam = tcam.make_camera(fx=500.0, fy=500.0, cx=320.0, cy=160.0, baseline_m=0.4, rows=320,
                           cols=640, device="cpu")
    prob = tba.BAProblem(**{k: torch.from_numpy(inputs["ba_" + k]) for k in
                            ("T_wc", "xyz", "obs_cam", "obs_uv4", "obs_weight", "obs_mask",
                             "lm_valid", "cam_fixed")})
    T, xyz, chi2 = tba.bundle_adjust(cam, prob, tba.BAConfig(iterations=BA_ITERATIONS))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["ba_T"], T.numpy(), atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["ba_xyz"], xyz.numpy(), atol=1e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["ba_chi2"], chi2.numpy(), rtol=1e-4)
        np.testing.assert_array_equal(out["ba_T"], outs[0]["ba_T"])  # replicated solve


def test_sharded_ba_converges(ranks, inputs):
    """Poses within 2 cm and chi2 down to the measurement noise's:
    n_obs * 4 * PX_NOISE^2 in expectation (less, as BA fits part of the
    noise)."""
    _, outs = ranks
    err = np.linalg.norm(outs[0]["ba_T"][:, :3, 3] - inputs["ba_T_gt"][:, :3, 3], axis=1)
    assert err.max() < 0.02, err
    noise_chi2 = inputs["ba_obs_mask"].sum() * 4 * PX_NOISE**2
    chi2 = outs[0]["ba_chi2"]
    assert chi2[0] > 10 * noise_chi2 and chi2[-1] < noise_chi2, chi2


def test_mesh_helpers_without_a_process_group():
    assert tmesh.make_mesh() is None  # no group: one device, unsharded paths
    x = torch.arange(10)
    padded, n = tmesh.pad_to_multiple(x, 4, fill=-1)
    assert n == 10 and padded.tolist() == list(range(10)) + [-1, -1]
    a, n = tmesh.pad_to_multiple(torch.ones((3, 2)), 3)
    assert n == 3 and a.shape == (3, 2)
    assert tmesh.shard_rows(x, None) is x
    mesh = tmesh.Mesh(rank=1, size=3, group=None)
    assert tmesh.shard_rows(padded, mesh).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_rows(x, mesh)


def test_hung_rank_fails_inside_the_deadline(tmp_path):
    """A rank that never joins its peer: the run fails at the deadline and
    every rank is killed (no test can hang the suite)."""
    script = tmp_path / "hang.py"
    script.write_text("import time, sys\nif sys.argv[1] == '1':\n    time.sleep(600)\n")
    with pytest.raises(RuntimeError, match="still running"):
        launch.run_ranks(lambda r: [sys.executable, str(script), str(r)], 2, 5)


ENGINE = dict(
    cam=dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4, rows=192, cols=512),
    n_points=1500, seed=21, frames=48, radius=7.0, landmark_capacity=8192,
    config=dict(
        framepoint_generation=dict(capacity=256, bin_size_pixels=16),
        world_map=dict(minimum_distance_traveled_for_local_map=0.8,
                       minimum_number_of_frames_for_local_map=2),
        relocalization=dict(preliminary_minimum_interspace_queries=6,
                            preliminary_minimum_matching_ratio=0.08,
                            icp_minimum_number_of_inliers=8, icp_minimum_inlier_ratio=0.3),
        graph_optimization=dict(enable_full_bundle_adjustment=True,
                                number_of_frames_per_bundle_adjustment=16),
    ),
)


def test_two_rank_engine_gives_the_one_rank_events(tmp_path):
    """The 2-rank run and the 1-rank run (no mesh: the unsharded engine)
    go at once, three processes."""
    from concurrent.futures import ThreadPoolExecutor

    from vslam_tpu_torch.eval import trajectory as ttraj
    from vslam_tpu_torch.io import synthetic

    src = tmp_path / "engine.json"
    src.write_text(json.dumps(ENGINE))
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(_run, "engine", world, str(src), tmp_path) for world in (1, 2)]
        one, sharded = (r.result() for r in runs)
    one = one[0]
    rep_one = json.loads(str(one["report"]))
    assert rep_one["n_closures"] >= 1 and rep_one["n_ba_runs"] >= 1
    assert rep_one["n_optimizations"] >= 1
    cam = tcam.make_camera(**ENGINE["cam"], device="cpu")
    poses = synthetic.make_world(cam, n_points=ENGINE["n_points"], seed=ENGINE["seed"],
                                 poses=synthetic.circle_trajectory(
                                     ENGINE["frames"], radius=ENGINE["radius"])).poses
    ate_one = ttraj.ate_rmse(one["traj"], poses)[0]
    for r, out in enumerate(sharded):
        rep = json.loads(str(out["report"]))
        for k in ("n_local_maps", "n_closures", "n_optimizations", "n_track_breaks",
                  "n_ba_runs"):
            assert rep[k] == rep_one[k], (r, k)
        np.testing.assert_array_equal(out["closures"], one["closures"])
        assert np.linalg.norm(out["traj"][:, :3, 3] - one["traj"][:, :3, 3], axis=1).max() < 1e-2
        ate = ttraj.ate_rmse(out["traj"], poses)[0]
        assert abs(ate - ate_one) < 1e-3, (ate, ate_one)
    np.testing.assert_array_equal(sharded[0]["traj"], sharded[1]["traj"])  # ranks in step
