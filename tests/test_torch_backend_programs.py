"""The back end's device programs on the CPU, where every program runs
eagerly through the code its capture records on the card: the pose-graph
junction solve and its distribution at the JAX package's padded buckets,
the windowed BA solve at the runner's padded size, and FAST-ICP with its
capturable rotation fit; the deterministic normal-equation assembly and
landmark merge.

Tolerances:
  * the hierarchical pose graph against the JAX package's (both at the
    same padded buckets): poses within 1e-5 + 1e-5 relative (the
    translations reach 12 m, where an f32 step is 9.5e-7; one-hot sums
    against JAX's scatter order, measured 1.5e-5 after Levenberg's 10
    rounds), chi2 within 1e-4 relative;
  * BA at the padded size against JAX's bundle_adjust at that size: poses
    within 2e-6, points within 2e-5 m, every round's chi2 within 2e-5
    relative;
  * rotation_fit against torch.linalg.svd's Kabsch rotation within 1e-5;
    FAST-ICP through its program against JAX within 1e-5, inliers equal;
  * the one-hot normal equations against the scatter-add assembly within
    1e-6 relative to the largest entry; the merge bit-equal to the
    scatter-add it replaces and within the merging tests' 1e-5 of JAX's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vslam_tpu.backend import ba as jba
from vslam_tpu.backend import pose_graph as jpg
from vslam_tpu.mapping import merging as jmerging
from vslam_tpu.ops import camera as jcam
from vslam_tpu_torch.backend import ba as tba
from vslam_tpu_torch.backend import pose_graph as tpg
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.loop import relocalizer as trl
from vslam_tpu_torch.mapping import merging as tmerging
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.solve import anderson as tanderson
from vslam_tpu_torch.solve import gn as tgn

import test_torch_anderson as anderson_cases
import test_torch_ba as ba_cases
import test_torch_merging as merging_cases
import test_torch_pose_graph as pg_cases

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


class NoHostData(TorchDispatchMode):
    """Raises on a host read of a tensor's value or a tensor made from
    host data (the calls a captured program cannot hold)."""

    FORBIDDEN = ("aten::_local_scalar_dense", "aten::lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.FORBIDDEN:
            raise AssertionError(f"{func._schema.name} inside the program")
        return func(*args, **(kwargs or {}))


class ReversedScatters(TorchDispatchMode):
    """Runs every float scatter-add (index_add, index_put with
    accumulate) one update at a time in reverse order: another order a
    CUDA scatter's atomics may take.  A sum that does not depend on the
    order gives the same bits under it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name == "aten::index_add" and args[0].is_floating_point():
            out, dim, index, source = args[:4]
            assert dim == 0 and kwargs.get("alpha", 1) == 1
            out = out.clone()
            for k in reversed(range(len(index))):
                out[index[k]] += source[k]
            return out
        if name in ("aten::index_put", "aten::index_put_") and args[0].is_floating_point() \
                and (args[3] if len(args) > 3 else kwargs.get("accumulate", False)):
            out, indices, values = args[:3]
            if name == "aten::index_put":
                out = out.clone()
            values = values.expand(indices[0].shape + out.shape[len(indices):])
            for k in reversed(range(len(indices[0]))):
                out[tuple(i[k] for i in indices)] += values[k]
            return out
        return func(*args, **kwargs)


def _hierarchical(levenberg):
    gt, est, odo, clo = pg_cases._drifted_circle()
    w = np.ones(len(est) - 1, np.float32)
    w[7] = 1e-3
    return gt, est, odo, w, clo


# ---------------------------------------------------------------------------
# The pose graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levenberg", [False, True])
def test_pose_graph_programs_match_jax_at_its_buckets(levenberg):
    gt, est, odo, w, clo = _hierarchical(levenberg)
    tpg.clear_programs()
    want, want_chi2 = jpg.optimize_pose_graph_hierarchical(est, odo, w, clo, levenberg=levenberg)
    got, got_chi2 = tpg.optimize_pose_graph_hierarchical(
        est, odo, w, from_jax.pose_graph_edges_from_numpy(clo), levenberg=levenberg,
        device="cpu")
    cpu = torch.device("cpu")
    assert set(tpg._PROGRAMS) == {("junction", 64, 128, 10, levenberg, cpu),
                                  ("distribute", 512, 64, cpu)}
    assert np.abs(got - gt).max() < np.abs(est - gt).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_chi2, want_chi2, rtol=1e-4, atol=1e-9)


def test_junction_graph_is_the_jax_padded_graph():
    """The assembly pads as the JAX package does: Jp = pow2(J, 64), Ep =
    max(pow2(E, 128), 2 Jp); padded poses identity and invalid, padded
    edges 0 -> 0, identity, weight 0, invalid."""
    _, est, odo, w, clo = _hierarchical(False)
    g, junc, J, E = tpg.junction_graph(est, odo, w, from_jax.pose_graph_edges_from_numpy(clo))
    assert (len(g.poses), len(g.edge_i)) == (64, 128) and J == len(junc) and E == J - 1 + 3
    tight, _, _, _ = tpg.junction_graph(est, odo, w, clo, pad=False)
    for name, a, b in zip(g._fields, g, tight):
        np.testing.assert_array_equal(a[:len(b)], b, err_msg=name)
    assert not g.pose_valid[J:].any() and not g.edge_valid[E:].any()
    assert not g.edge_weight[E:].any() and not g.edge_i[E:].any() and not g.edge_j[E:].any()
    np.testing.assert_array_equal(g.poses[J:], np.eye(4, dtype=np.float32)[None].repeat(64 - J, 0))
    assert tpg.junction_buckets(65, 100) == (128, 256)
    assert tpg.junction_buckets(200, 600) == (256, 1024)


def test_padded_junction_solve_equals_the_tight_one():
    _, est, odo, w, clo = _hierarchical(False)
    g, _, J, _ = tpg.junction_graph(est, odo, w, clo)
    tight, _, _, _ = tpg.junction_graph(est, odo, w, clo, pad=False)
    padded, chi2_p = tpg.optimize_pose_graph(from_jax.pose_graph_from_numpy(g._asdict()))
    true, chi2_t = tpg.optimize_pose_graph(from_jax.pose_graph_from_numpy(tight._asdict()))
    np.testing.assert_allclose(padded[:J].numpy(), true.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(chi2_p), float(chi2_t), rtol=1e-5)


def _scatter_normal_equations(r, Ji, Jj, w, ii, jj, P):
    """The assembly the port had before: scatter-adds with repeated
    indices (the JAX package's .at[].add)."""
    Hii = torch.einsum("eri,e,erj->eij", Ji, w, Ji)
    Hjj = torch.einsum("eri,e,erj->eij", Jj, w, Jj)
    Hij = torch.einsum("eri,e,erj->eij", Ji, w, Jj)
    H = torch.zeros((P, P, 6, 6))
    H.index_put_((ii, ii), Hii, accumulate=True)
    H.index_put_((jj, jj), Hjj, accumulate=True)
    H.index_put_((ii, jj), Hij, accumulate=True)
    H.index_put_((jj, ii), Hij.transpose(-1, -2), accumulate=True)
    b = (torch.zeros((P, 6)).index_add(0, ii, torch.einsum("eri,e,er->ei", Ji, w, r))
         .index_add(0, jj, torch.einsum("eri,e,er->ei", Jj, w, r)))
    return H.permute(0, 2, 1, 3), b


def test_one_hot_normal_equations_match_the_scatter_assembly():
    _, est, odo, w, clo = _hierarchical(False)
    g = from_jax.pose_graph_from_numpy(tpg.junction_graph(est, odo, w, clo)[0]._asdict())
    r, Ji, Jj = tpg._edge_residual_jac(g.poses, g.edge_i, g.edge_j, g.edge_T_ij)
    wt = g.edge_weight * g.edge_valid
    P = g.poses.shape[0]
    H, b = tpg.normal_equations(r, Ji, Jj, wt, g.edge_i, g.edge_j, P)
    H0, b0 = _scatter_normal_equations(r, Ji, Jj, wt, g.edge_i, g.edge_j, P)
    assert (H - H0).abs().max() <= 1e-6 * H0.abs().max()
    assert (b - b0).abs().max() <= 1e-6 * b0.abs().max()


@pytest.mark.parametrize("levenberg", [False, True])
def test_pose_graph_solve_does_not_depend_on_the_scatter_order(levenberg):
    """Every junction is an endpoint of two or more edges, the closures'
    of three: a scatter-add assembly changes its bits with the order."""
    _, est, odo, w, clo = _hierarchical(levenberg)
    g = from_jax.pose_graph_from_numpy(tpg.junction_graph(est, odo, w, clo)[0]._asdict())
    want = tpg.optimize_pose_graph(g, levenberg=levenberg)
    with ReversedScatters():
        got = tpg.optimize_pose_graph(g, levenberg=levenberg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Windowed BA
# ---------------------------------------------------------------------------

def _padded_ba_problem(Pp=16, Lp=64):
    """tests/test_torch_ba.py's window padded as the JAX runner pads it."""
    d = ba_cases.make_problem()
    P, L = d["T_wc"].shape[0], d["xyz"].shape[0]
    eye = np.eye(4, dtype=np.float32)
    pad = dict(d)
    pad["T_wc"] = np.concatenate([d["T_wc"], np.tile(eye, (Pp - P, 1, 1))])
    pad["cam_fixed"] = np.r_[d["cam_fixed"], np.ones(Pp - P, bool)]
    pad["odo_T"] = np.concatenate([d["odo_T"], np.tile(eye, (Pp - P, 1, 1))])
    pad["odo_weight"] = np.r_[d["odo_weight"][:P - 1], np.zeros(Pp - P + 1, np.float32)]
    for k in ("xyz", "obs_cam", "obs_uv4", "obs_weight", "obs_mask", "lm_valid"):
        a = d[k]
        pad[k] = np.concatenate([a, np.zeros((Lp - L,) + a.shape[1:], a.dtype)])
    return pad


def test_ba_program_matches_jax_at_the_padded_size():
    pad = _padded_ba_problem()
    jc, tc = jcam.make_camera(**ba_cases.CAM), tcam.make_camera(**ba_cases.CAM, device="cpu")
    Tj, Xj, cj = (np.asarray(a) for a in jba.bundle_adjust(jc, ba_cases._jax_problem(pad)))
    tba.clear_programs()
    for _ in range(2):  # the buffers are reused
        Tt, Xt, ct = (a.numpy() for a in tba.bundle_adjust_program(
            tc, from_jax.ba_problem_from_numpy(pad)))
        assert np.abs(Tt - Tj).max() <= 2e-6
        assert np.abs(Xt - Xj).max() <= 2e-5
        np.testing.assert_allclose(ct, cj, rtol=2e-5)
    assert list(tba._PROGRAMS) == [(16, 64, 4, tba.BAConfig(), True, torch.device("cpu"))]


def test_ba_program_holds_no_camera_of_its_own():
    """The camera is an input: a second camera gives its own solve."""
    pad = from_jax.ba_problem_from_numpy(_padded_ba_problem())
    tc = tcam.make_camera(**ba_cases.CAM, device="cpu")
    other = tcam.make_camera(**dict(ba_cases.CAM, fx=310.0, baseline_m=0.25), device="cpu")
    tba.clear_programs()
    a = tba.bundle_adjust_program(tc, pad)
    b = tba.bundle_adjust_program(other, pad)
    assert len(tba._PROGRAMS) == 1
    for x, y, z in zip(b, tba.bundle_adjust(other, pad), a):
        assert torch.equal(x, y) and not torch.equal(x, z)


# ---------------------------------------------------------------------------
# FAST-ICP
# ---------------------------------------------------------------------------

def _kabsch(S):
    U, _, Vh = torch.linalg.svd(S)
    d = torch.sign(torch.linalg.det(U @ Vh))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    return U @ D @ Vh


def _cross_covariances(kind, rng, B=64, n=60):
    """S = sum f m^T of noisy rotated point sets: spread in 3-D ("random"),
    on a plane ("planar": rank 2), or mirrored ("reflected": det S < 0)."""
    mov = rng.normal(size=(B, n, 3))
    if kind == "planar":
        mov[..., 2] = 0.0
    q = np.linalg.qr(rng.normal(size=(B, 3, 3)))[0]
    fix = np.einsum("bij,bnj->bni", q, mov) + rng.normal(0, 0.05, (B, n, 3))
    if kind == "reflected":
        fix[..., 0] *= -1
    mov -= mov.mean(1, keepdims=True)
    fix -= fix.mean(1, keepdims=True)
    return torch.from_numpy(np.einsum("bni,bnj->bij", fix, mov).astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "planar", "reflected", "gaussian"])
def test_rotation_fit_matches_the_svd_rotation(kind):
    rng = np.random.default_rng(7)
    if kind == "gaussian":
        S = torch.from_numpy(rng.normal(size=(256, 3, 3)).astype(np.float32))
    else:
        S = _cross_covariances(kind, rng)
    if kind == "reflected":
        assert bool((torch.linalg.det(S) < 0).all())
    R = tanderson.rotation_fit(S)
    assert (R - _kabsch(S)).abs().max() <= 1e-5
    np.testing.assert_allclose(torch.linalg.det(R.double()).numpy(), 1.0, atol=1e-6)
    assert torch.equal(tanderson.rotation_fit(torch.zeros(2, 3, 3)), torch.eye(3).repeat(2, 1, 1))


@pytest.mark.parametrize("case", list(anderson_cases.CASES))
def test_fast_icp_program_matches_jax(case):
    """JAX's four problems through the closure ICP program (bucket 8, the
    first row the problem, the rest padding)."""
    noise, outliers, kernel = anderson_cases.CASES[case]
    p_mov, p_fix, _ = anderson_cases.make_problem(np.random.default_rng(11), noise=noise,
                                                  outliers=outliers)
    mask = np.ones(len(p_mov), bool)
    want = anderson_cases._jax(p_mov, p_fix, mask, kernel)
    cfg = tgn.GNConfig(kernel_max_error=kernel, min_num_inliers=20)
    prog = trl.ICPProgram(tanderson.fast_icp_align, cfg, 8, len(p_mov), "cpu")
    got = prog.run(torch.from_numpy(p_mov)[None], torch.from_numpy(p_fix)[None],
                   torch.from_numpy(mask)[None], torch.eye(4)[None])
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x), atol=1e-5)
    assert int(got.num_inliers[0]) == int(want.num_inliers)
    assert bool(got.converged[0]) == bool(want.converged)
    assert not bool(got.converged[1:].any())


# ---------------------------------------------------------------------------
# No host read inside a program
# ---------------------------------------------------------------------------

def _programs():
    """One program of each kind, its buffers loaded with a real problem."""
    _, est, odo, w, clo = _hierarchical(True)
    g, junc, J, _ = tpg.junction_graph(est, odo, w, clo)
    tpg.clear_programs()
    tba.clear_programs()
    junction = tpg.junction_program(64, 128, 10, True, "cpu")
    junction.load((g, np.float32(1.0)))
    dist = tpg.distribute_program(512, 64, "cpu")
    owner = np.minimum(np.arange(512) // 8, J - 2)
    dist.load((tpg._padded(est, 512, np.eye(4, dtype=np.float32)), g.poses, owner,
               (np.arange(512) % 8 / 8).astype(np.float32)))
    tc = tcam.make_camera(**ba_cases.CAM, device="cpu")
    ba = tba.ba_program(tc, 16, 64, 4, tba.BAConfig(), True, "cpu")
    ba.load(((tc.K, tc.baseline_m), from_jax.ba_problem_from_numpy(_padded_ba_problem())))
    p_mov, p_fix, _ = anderson_cases.make_problem(np.random.default_rng(3), noise=0.01,
                                                  outliers=10)
    icp = trl.ICPProgram(tanderson.fast_icp_align, tgn.GNConfig(kernel_max_error=0.5), 8,
                         len(p_mov), "cpu")
    icp.load_batch(torch.from_numpy(p_mov)[None], torch.from_numpy(p_fix)[None],
                   torch.ones(1, len(p_mov), dtype=torch.bool), torch.eye(4)[None])
    return {"junction": junction, "distribute": dist, "ba": ba, "fast-icp": icp}


@pytest.mark.parametrize("name", ["junction", "distribute", "ba", "fast-icp"])
def test_programs_read_nothing_back(name):
    prog = _programs()[name]
    want = prog.eager()
    with NoHostData():
        got = prog.eager()
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------

def _three_into_one():
    jt = merging_cases._table()
    valid = np.asarray(jt.valid)
    live = np.flatnonzero(valid)
    # Three sources into live[1] (large and small positions alike), two
    # into live[2], one plain pair and a padded row.
    src = np.array([live[10], live[11], live[12], live[20], live[21], live[30], 0], np.int32)
    dst = np.array([live[1], live[1], live[1], live[2], live[2], live[4], 0], np.int32)
    use = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    return jt, src, dst, use


def _scatter_merge(table, src, dst, use):
    """The float sums of _apply_merges as they were: index_add."""
    s = torch.where(use, src, 0).long()
    d = torch.where(use, dst, 0).long()
    use = use & table.valid[s] & table.valid[d]
    w_src, w_dst = table.n_updates[s].float(), table.n_updates[d].float()
    tot = torch.clamp(w_src + w_dst, min=1.0)
    xyz_d = table.xyz_w[d]
    merged = xyz_d * (w_dst / tot)[:, None] + table.xyz_w[s] * (w_src / tot)[:, None]
    xyz = table.xyz_w.index_add(0, d, torch.where(use[:, None], merged - xyz_d, 0.0))
    H = table.H_acc.index_add(0, d, torch.where(use[:, None, None], table.H_acc[s], 0.0))
    return xyz, H


def test_three_sources_into_one_destination_match_jax_and_the_scatter_add():
    jt, src, dst, use = _three_into_one()
    want = jmerging._apply_merges(jt, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(use))
    table = from_jax.landmark_table_from_numpy(merging_cases._np(jt))
    args = (torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(use))
    got = tmerging._apply_merges(table, *args, rounds=3)
    merging_cases._assert_tables_match(got, want)
    xyz, H = _scatter_merge(table, *args)
    assert torch.equal(got.xyz_w, xyz) and torch.equal(got.H_acc, H)
    # rounds=None: as many rounds as pairs, the same bits.
    again = tmerging._apply_merges(table, *args)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_merge_does_not_depend_on_the_scatter_order():
    jt, src, dst, use = _three_into_one()
    table = from_jax.landmark_table_from_numpy(merging_cases._np(jt))
    args = (torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(use))
    want = tmerging._apply_merges(table, *args)
    with ReversedScatters():
        got = tmerging._apply_merges(table, *args)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
