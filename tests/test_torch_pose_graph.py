"""Port parity for the pose-graph back-end: the SE(3) Jacobian closed
forms (ops/lie.py), the edge linearization, the dense GN / LM solver, the
closure compaction and the hierarchical junction solver, each against the
JAX package on the same seeded numpy inputs.

Tolerances: lie closed forms rtol 1e-5 (atol 1e-6 for entries near 0);
edge residuals atol 1e-5 and Jacobians 1e-4 relative to their largest
entry (f32, different op order); solved poses atol 1e-4 and chi2 rtol
1e-3 (an f32 Cholesky of a system with a 1e6 anchor); compact_closures
exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.backend import pose_graph as jpg
from vslam_tpu.ops import lie as jlie
from vslam_tpu_torch.backend import pose_graph as tpg
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.ops import lie as tlie

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

POSE_ATOL = 1e-4
CHI2_RTOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _twists(rng, n, rot=0.8):
    xi = rng.standard_normal((n, 6)).astype(np.float32)
    xi[:, 3:] *= rot
    xi[:4, 3:] *= 1e-3  # a few inside the small-angle Taylor branch
    return xi


@pytest.mark.parametrize("name", ["vee", "adjoint_se3", "jl_inv_so3", "jl_inv_se3", "_se3_Q"])
def test_lie_closed_forms_match_jax(name):
    rng = np.random.default_rng(3)
    xi = _twists(rng, 64)
    T = np.asarray(jlie.exp_se3(jnp.asarray(xi)))
    if name == "vee":
        W = np.asarray(jlie.hat(jnp.asarray(xi[:, 3:])))
        args_j, args_t = (jnp.asarray(W),), (_t(W),)
    elif name == "adjoint_se3":
        args_j, args_t = (jnp.asarray(T),), (_t(T),)
    elif name == "jl_inv_so3":
        args_j, args_t = (jnp.asarray(xi[:, 3:]),), (_t(xi[:, 3:]),)
    elif name == "jl_inv_se3":
        args_j, args_t = (jnp.asarray(xi),), (_t(xi),)
    else:
        args_j = (jnp.asarray(xi[:, :3]), jnp.asarray(xi[:, 3:]))
        args_t = (_t(xi[:, :3]), _t(xi[:, 3:]))
    want = np.asarray(getattr(jlie, name)(*args_j))
    got = getattr(tlie, name)(*args_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _random_poses(rng, n):
    xi = (rng.standard_normal((n, 6)) * np.array([5, 5, 5, 0.3, 0.3, 0.3])).astype(np.float32)
    return np.asarray(jlie.exp_se3(jnp.asarray(xi)))


def test_edge_residual_jac_matches_jax_and_autodiff():
    rng = np.random.default_rng(11)
    poses = _random_poses(rng, 6)
    ii = np.array([0, 2, 4, 5, 1], np.int32)
    jj = np.array([1, 5, 3, 0, 1], np.int32)
    T_ij = np.asarray(jlie.exp_se3(jnp.asarray(
        (rng.standard_normal((5, 6)) * 0.4).astype(np.float32))))
    r, Ji, Jj = tpg._edge_residual_jac(_t(poses), torch.from_numpy(ii).long(),
                                       torch.from_numpy(jj).long(), _t(T_ij))
    P = jnp.asarray(poses)
    for ref in (jpg._edge_residual_jac, jpg._edge_residual_jac_ad):
        rj, Jij, Jjj = jax.vmap(lambda i, j, T: ref(P, i, j, T))(
            jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(T_ij))
        scale = max(float(np.abs(np.asarray(Jjj)).max()), 1.0)
        np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-5)
        np.testing.assert_allclose(Ji.numpy() / scale, np.asarray(Jij) / scale, atol=1e-4)
        np.testing.assert_allclose(Jj.numpy() / scale, np.asarray(Jjj) / scale, atol=1e-4)


def _drifted_loop(n=24, radius=10.0, seed=11):
    """A circle of n keyframes with noisy odometry and one ground-truth
    closure last -> first: (noisy poses, edge list)."""
    rng = np.random.default_rng(seed)
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / n
        c, s = np.cos(a), np.sin(a)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T[:3, 3] = [radius * s, 0.0, radius * (1 - c)]
        gt.append(T)
    noisy = [gt[0]]
    edges = []
    for k in range(1, n):
        xi = np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)]).astype(np.float32)
        rel = np.linalg.inv(gt[k - 1]) @ gt[k] @ np.asarray(jlie.exp_se3(jnp.asarray(xi)))
        noisy.append(noisy[-1] @ rel)
        edges.append((k - 1, k, np.linalg.inv(noisy[k - 1]) @ noisy[k], 1.0))
    edges.append((n - 1, 0, np.linalg.inv(gt[n - 1]) @ gt[0], 10.0))
    return np.stack(noisy).astype(np.float32), edges


def _graph_numpy(poses, edges, P_pad=None, E_pad=None):
    P, E = len(poses), len(edges)
    P_pad, E_pad = P_pad or P, E_pad or E
    p = np.tile(np.eye(4, dtype=np.float32), (P_pad, 1, 1))
    p[:P] = poses
    eT = np.tile(np.eye(4, dtype=np.float32), (E_pad, 1, 1))
    eT[:E] = np.stack([e[2] for e in edges])
    ei = np.zeros(E_pad, np.int32)
    ej = np.zeros(E_pad, np.int32)
    ew = np.zeros(E_pad, np.float32)
    ei[:E] = [e[0] for e in edges]
    ej[:E] = [e[1] for e in edges]
    ew[:E] = [e[3] for e in edges]
    return dict(poses=p, edge_i=ei, edge_j=ej, edge_T_ij=eT, edge_weight=ew,
                edge_valid=np.arange(E_pad) < E, pose_valid=np.arange(P_pad) < P)


@pytest.mark.parametrize("levenberg", [False, True])
def test_optimize_pose_graph_matches_jax(levenberg):
    poses, edges = _drifted_loop()
    g = _graph_numpy(poses, edges)
    want, want_chi2 = jpg.optimize_pose_graph(
        jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}),
        iterations=10, levenberg=levenberg)
    got, got_chi2 = tpg.optimize_pose_graph(from_jax.pose_graph_from_numpy(g),
                                            iterations=10, levenberg=levenberg)
    assert np.abs(np.asarray(want)[:, :3, 3] - poses[:, :3, 3]).max() > 0.05  # it moved
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POSE_ATOL)
    np.testing.assert_allclose(float(got_chi2), float(want_chi2), rtol=CHI2_RTOL)


def test_padded_graph_gives_the_true_size_answer():
    """The JAX package pads to compile buckets; padded vertices are
    decoupled, so the port's true-size solve is the padded solve."""
    poses, edges = _drifted_loop()
    true_size, chi2 = tpg.optimize_pose_graph(
        from_jax.pose_graph_from_numpy(_graph_numpy(poses, edges)))
    padded, chi2_p = tpg.optimize_pose_graph(
        from_jax.pose_graph_from_numpy(_graph_numpy(poses, edges, P_pad=64, E_pad=128)))
    np.testing.assert_allclose(padded[:len(poses)].numpy(), true_size.numpy(), atol=POSE_ATOL)
    np.testing.assert_allclose(float(chi2_p), float(chi2), rtol=CHI2_RTOL)


def test_failed_cholesky_keeps_the_poses():
    """An indefinite system (a negative weight) fails the factorization:
    the step is treated as non-finite and the poses stay."""
    poses, edges = _drifted_loop(n=8)
    g = _graph_numpy(poses, [(i, j, T, -1e3) for i, j, T, _ in edges])
    got, _ = tpg.optimize_pose_graph(from_jax.pose_graph_from_numpy(g), iterations=3,
                                     robust_kernel_chi2=1e12)
    np.testing.assert_array_equal(got.numpy(), poses)


def test_compact_closures_matches_jax():
    rng = np.random.default_rng(4)
    clo = [(int(i), int(j), np.eye(4) * k)
           for k, (i, j) in enumerate(rng.integers(0, 60, (40, 2)))]
    want = jpg.compact_closures(clo, bucket=4)
    got = tpg.compact_closures(clo, bucket=4)
    assert [(i, j) for i, j, _ in got] == [(i, j) for i, j, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _drifted_circle(P=40, radius=12.0, n_clo=3, seed=5):
    """A 1.2-lap circle of P keyframes with systematic odometric drift and
    n_clo ground-truth closures from the second lap onto the first."""
    rng = np.random.default_rng(seed)
    laps = 1.2
    angles = np.linspace(0, 2 * np.pi * laps, P)
    gt = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    for k, a in enumerate(angles):
        c, s = np.cos(a), np.sin(a)
        gt[k, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        gt[k, :3, 3] = [radius * np.cos(a), 0.0, radius * np.sin(a)]
    odo = np.zeros((P - 1, 4, 4), np.float32)
    est = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    est[0] = gt[0]
    for k in range(P - 1):
        xi = np.zeros(6, np.float32)
        xi[:3] = 1e-2 * (1 + 0.1 * rng.standard_normal(3))
        xi[4] = 5e-3 * (1 + 0.1 * rng.standard_normal())
        odo[k] = np.linalg.inv(gt[k]) @ gt[k + 1] @ np.asarray(jlie.exp_se3(jnp.asarray(xi)))
        est[k + 1] = est[k] @ odo[k]
    per_lap = int(P / laps)
    clo = [(j - per_lap, j, np.linalg.inv(gt[j - per_lap]) @ gt[j])
           for j in (per_lap + 1, per_lap + 3, P - 1)][:n_clo]
    return gt, est, odo, clo


@pytest.mark.parametrize("levenberg", [False, True])
def test_hierarchical_matches_jax(levenberg):
    gt, est, odo, clo = _drifted_circle()
    w = np.ones(len(est) - 1, np.float32)
    w[7] = 1e-3  # one break-weighted odometry edge
    want, want_chi2 = jpg.optimize_pose_graph_hierarchical(est, odo, w, clo,
                                                           levenberg=levenberg)
    got, got_chi2 = tpg.optimize_pose_graph_hierarchical(
        est, odo, w, from_jax.pose_graph_edges_from_numpy(clo), levenberg=levenberg,
        device="cpu")
    before = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    after = np.linalg.norm(got[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    assert after < 0.5 * before  # the closures pulled the drift in
    np.testing.assert_allclose(got, want, atol=POSE_ATOL)
    np.testing.assert_allclose(got_chi2, want_chi2, rtol=CHI2_RTOL, atol=1e-7)


def test_hierarchical_noop_without_closures():
    _, est, odo, _ = _drifted_circle()
    got, chi2 = tpg.optimize_pose_graph_hierarchical(
        est, odo, np.ones(len(est) - 1, np.float32), [], device="cpu")
    np.testing.assert_array_equal(got, est)
    assert chi2 == 0.0


# The chain solver (optimize_pose_graph_chain) on tests/test_backend.py's
# chain graphs: the drifted 24-keyframe loop, one x10 closure last ->
# first, tight (P = 24, C = 8 closure rows) and padded (P = 64, C = 16).

def _chain_numpy(poses, edges, P_pad=None, C_pad=8):
    n = len(poses)
    P = P_pad or n
    odo = [e for e in edges if e[1] == e[0] + 1]
    clo = [e for e in edges if e[1] != e[0] + 1]
    p = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    p[:n] = poses
    odo_T = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    odo_T[:n - 1] = np.stack([e[2] for e in odo]).astype(np.float32)
    odo_w = np.zeros(P, np.float32)
    odo_w[:n - 1] = [e[3] for e in odo]
    clo_T = np.tile(np.eye(4, dtype=np.float32), (C_pad, 1, 1))
    clo_i = np.zeros(C_pad, np.int32)
    clo_j = np.zeros(C_pad, np.int32)
    clo_w = np.zeros(C_pad, np.float32)
    for c, (i, j, T, w) in enumerate(clo):
        clo_T[c], clo_i[c], clo_j[c], clo_w[c] = T, i, j, w
    return dict(poses=p, odo_T=odo_T, odo_weight=odo_w, odo_valid=np.arange(P) < n - 1,
                clo_i=clo_i, clo_j=clo_j, clo_T=clo_T, clo_weight=clo_w,
                clo_valid=np.arange(C_pad) < len(clo), pose_valid=np.arange(P) < n)


def _chain_port(g):
    ints = ("clo_i", "clo_j")
    return tpg.ChainPoseGraph(**{k: torch.from_numpy(np.asarray(v)).long() if k in ints
                                 else torch.from_numpy(np.asarray(v)) for k, v in g.items()})


# Levenberg on this graph: near the optimum the accept test (chi2 <
# best) compares f32 chi2 values equal to 5 digits.  JAX accepts no step
# after its 4th round, the port two more (each 1e-9 lower), so the
# returned iterates differ by 3.5e-4 m although both are at the optimum:
# the port's is 2.3e-5 m from the same solve in f64, JAX's 3.7e-4 m
# (measured on this graph).  So with levenberg the port is held to the
# f64 solve within POSE_ATOL and to JAX's within LM_TIE_ATOL, chi2 to
# CHI2_RTOL.
LM_TIE_ATOL = 5e-4


@pytest.mark.parametrize("levenberg", [False, True])
@pytest.mark.parametrize("bucket", ["tight", "padded"])
def test_chain_solver_matches_jax(bucket, levenberg):
    poses, edges = _drifted_loop(seed=7)
    g = _chain_numpy(poses, edges, **({} if bucket == "tight" else dict(P_pad=64, C_pad=16)))
    want, want_chi2 = jpg.optimize_pose_graph_chain(
        jpg.ChainPoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}),
        iterations=10, levenberg=levenberg)
    got, got_chi2 = tpg.optimize_pose_graph_chain(_chain_port(g), iterations=10,
                                                  levenberg=levenberg)
    n = len(poses)
    assert np.abs(np.asarray(want)[:n, :3, 3] - poses[:, :3, 3]).max() > 0.05  # it moved
    np.testing.assert_allclose(float(got_chi2), float(want_chi2), rtol=CHI2_RTOL)
    if not levenberg:
        # Padded rows included: they move rigidly with the last pose (dx is
        # the prefix sum of the increments, theirs 0), in both packages.
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POSE_ATOL)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LM_TIE_ATOL)
    g64 = _chain_port(g)
    g64 = g64._replace(**{k: getattr(g64, k).double()
                          for k in ("poses", "odo_T", "odo_weight", "clo_T", "clo_weight")})
    exact, _ = tpg.optimize_pose_graph_chain(g64, iterations=10, levenberg=True)
    np.testing.assert_allclose(got.numpy(), exact.float().numpy(), atol=POSE_ATOL)


def test_chain_solver_reaches_the_dense_optimum():
    """JAX's test_chain_solver_matches_dense for the port alone."""
    poses, edges = _drifted_loop(seed=7)
    dense, _ = tpg.optimize_pose_graph(from_jax.pose_graph_from_numpy(
        _graph_numpy(poses, edges)), iterations=15)
    chain, _ = tpg.optimize_pose_graph_chain(_chain_port(_chain_numpy(poses, edges)),
                                             iterations=15)
    assert float((chain[:, :3, 3] - dense[:, :3, 3]).abs().max()) < 0.02
    assert float((chain[:, :3, :3] - dense[:, :3, :3]).abs().max()) < 0.01


def test_pcg_spd_matches_jax_when_the_tolerance_stops_it():
    """A well-conditioned SPD system: the residual falls below tol * |b|
    well before the 200-round cap, so the frozen-flag loop and JAX's
    while_loop stop at the same iterate."""
    rng = np.random.default_rng(9)
    G = rng.standard_normal((48, 48)).astype(np.float32)
    A = (np.eye(48, dtype=np.float32) * 48 + G @ G.T * 0.1).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    want = np.asarray(jpg._pcg_spd(jnp.asarray(A), jnp.asarray(b), iterations=200, tol=1e-5))
    got = tpg._pcg_spd(torch.from_numpy(A), torch.from_numpy(b), iterations=200, tol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    r = b - A @ got.numpy()
    assert np.linalg.norm(r) <= 1e-5 * np.linalg.norm(b) * 1.5
    # And it stopped early: more rounds leave the answer where it is.
    more = tpg._pcg_spd(torch.from_numpy(A), torch.from_numpy(b), iterations=400, tol=1e-5)
    np.testing.assert_array_equal(more.numpy(), got.numpy())


def test_chain_solver_pcg_branch_matches_cholesky():
    """Past 6C = 1536 the capacitance system goes to _pcg_spd: 257
    closure rows (256 of them padding) give the Cholesky branch's poses."""
    poses, edges = _drifted_loop(seed=7)
    chol, _ = tpg.optimize_pose_graph_chain(_chain_port(_chain_numpy(poses, edges)),
                                            iterations=5)
    pcg, _ = tpg.optimize_pose_graph_chain(
        _chain_port(_chain_numpy(poses, edges, C_pad=257)), iterations=5)
    np.testing.assert_allclose(pcg.numpy(), chol.numpy(), atol=1e-3)


@pytest.mark.parametrize("fault", ["indefinite", "nan-measurement"])
def test_chain_solver_non_finite_step_keeps_the_poses(fault):
    """Negative odometry weights make the capacitance matrix indefinite
    (the factorization fails); a NaN odometry measurement makes the step
    non-finite.  Either way the poses stay, as JAX's non-finite step."""
    poses, edges = _drifted_loop(n=8)
    g = _chain_numpy(poses, edges)
    if fault == "indefinite":
        g["odo_weight"][:7] = -1e3
    else:
        g["odo_T"][3, 0, 3] = np.nan
    got, _ = tpg.optimize_pose_graph_chain(_chain_port(g), iterations=3,
                                           robust_kernel_chi2=1e12)
    np.testing.assert_array_equal(got.numpy(), poses)
