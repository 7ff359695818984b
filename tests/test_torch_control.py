"""ops/control.py on the CPU: the port's lax.while_loop and lax.cond.

On the CPU a loop stops as soon as no problem is active and a cond runs
the branch its predicate picks; inside control.masked() the CPU takes
the card's eager route instead (every loop to its cap with frozen state,
both branches computed and selected).  Held here, bit for bit:

  * while_loop against that route and against a literal frozen loop to
    the cap, for batches of 1, 3 and 8 problems, at caps that do and do
    not bind; its record (the active rounds) on both routes;
  * cond against the masked select, for both predicates, on tuples and
    NamedTuples;
  * gn.two_phase through the stereo, RGB-D (UVD) and closure ICP solves:
    the early exit equal to the frozen loop, and num_iterations equal to
    the JAX package's lax.while_loop count on the same problem (poses
    within 1e-5 of JAX's).  The problems carry noise and outliers: on an
    exact problem chi2 falls to rounding level and the stop test reads
    rounding (tests/test_torch_gn.py does not hold that count either);
  * the closure ICP bucket (relocalizer.ICPProgram): a batch padded to 8
    or 16 gives every real problem the bits of its unpadded batch, GN
    ICP and FAST-ICP.  A batch of one is the exception (its einsum takes
    another route), which is why every ICP batch is padded, as in JAX.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.ops import camera as jcam
from vslam_tpu.ops import lie as jlie
from vslam_tpu.solve import aligners as jal
from vslam_tpu.solve import gn as jgn
from vslam_tpu_torch.loop import relocalizer as rl
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.ops import control
from vslam_tpu_torch.ops import lie as tlie
from vslam_tpu_torch.solve import aligners as tal
from vslam_tpu_torch.solve import anderson
from vslam_tpu_torch.solve import gn as tgn

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _loop_problem(B, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, 2)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, 9, B).astype(np.int32))
    return x, target


def _body(s):
    v, it = s
    A = torch.tensor([[1.0, 0.5], [-0.25, 1.0]]).expand(v.shape[0], 2, 2)
    return torch.bmm(A, v[..., None])[..., 0] * 0.9 + 1.0, it + 1


def _frozen_loop(x, target, cap):
    """The loop the port ran before it had a while_loop: every round to
    the cap, each problem frozen once its condition fails."""
    v, it = x, torch.zeros_like(target)
    for _ in range(cap):
        active = it < target
        v2, it2 = _body((v, it))
        v, it = torch.where(active[:, None], v2, v), torch.where(active, it2, it)
    return v, it


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("cap", [4, 12])
def test_while_loop_equals_the_frozen_loop_to_the_cap(B, cap):
    x, target = _loop_problem(B, seed=B)
    cond = (lambda s: s[1] < target)
    with control.recording() as early_rec:
        early = control.while_loop(cond, _body, (x, torch.zeros_like(target)), cap)
    with control.masked(), control.recording() as masked_rec:
        masked = control.while_loop(cond, _body, (x, torch.zeros_like(target)), cap)
    frozen = _frozen_loop(x, target, cap)
    for a, b, c in zip(early, masked, frozen):
        assert torch.equal(a, c) and torch.equal(b, c)
    rounds = min(int(target.max()), cap)
    assert torch.equal(early[1], torch.clamp(target, max=cap))
    assert early_rec.read() == masked_rec.read() == [("while", None, rounds)]


def test_while_loop_stops_without_running_a_round_when_nothing_is_active():
    x = torch.ones(3, 2)
    calls = []

    def body(s):
        calls.append(1)
        return _body(s)

    out = control.while_loop(lambda s: s[1] < 0, body, (x, torch.zeros(3, dtype=torch.int32)),
                             50)
    assert not calls and torch.equal(out[0], x)


@pytest.mark.parametrize("take", [True, False])
@pytest.mark.parametrize("kind", ["tuple", "namedtuple"])
def test_cond_equals_the_masked_select(take, kind):
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    pred = torch.tensor(take)
    wrap = (lambda a, b: tgn.GNResult(a, b, a.sum(), b.sum(), a > 1, b > 2)
            if kind == "namedtuple" else (a, b))

    def yes(v):
        return wrap(v * 2.0, v + 1.0)

    def no(v):
        return wrap(v - 1.0, v * v)

    with control.recording() as rec:
        got = control.cond(pred, yes, no, (x,))
    with control.masked():
        sel = control.cond(pred, yes, no, (x,))
    want = yes(x) if take else no(x)
    assert type(got) is type(want) and type(sel) is type(want)
    for a, b, c in zip(got, sel, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert rec.read() == [("if", None, int(take))]


def test_record_marks_loops_in_a_branch_not_taken():
    x, target = _loop_problem(3, seed=5)

    def loop(v):
        return control.while_loop(lambda s: s[1] < target, _body,
                                  (v, torch.zeros_like(target)), 10)[0]

    for take in (True, False):
        with control.masked(), control.recording() as rec:
            control.cond(torch.tensor(take), loop, lambda v: v + 1.0, (x,))
        values = rec.read()
        assert [(k, p) for k, p, _ in values] == [("if", None), ("while", (0, True))]
        assert rec.reached(values) == [True, take]


def test_host_flag_reads_only_cpu_tensors():
    assert control._host_flag(torch.tensor([False, True]))
    with pytest.raises(RuntimeError, match="host read"):
        control._host_flag(torch.empty(1, device="meta", dtype=torch.bool))


# ---------------------------------------------------------------------------
# two_phase: the early exit, the frozen loop and JAX's counts
# ---------------------------------------------------------------------------

KITTI = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22, baseline_m=0.5372,
             rows=376, cols=1241)
N = 256


def _twist(rng, scale):
    xi = (rng.standard_normal(6) * scale).astype(np.float32)
    return np.asarray(jlie.exp_se3(jnp.asarray(xi)))


def _points(rng, cx, cy, f, umax, vmax, zmin, zmax):
    z = rng.uniform(zmin, zmax, N)
    u, v = rng.uniform(60, umax, N), rng.uniform(40, vmax, N)
    return np.stack([(u - cx) / f * z, (v - cy) / f * z, z], 1).astype(np.float32)


def _stereo(seed):
    """One point set (seed 0) seen under the twist, noise (0.4 px) and
    outliers (10%) of `seed`, as the ladder's attempts share prev's points."""
    p_prev = _points(np.random.default_rng(0), 607.19, 185.22, 718.856, 1141, 336, 4.0, 40.0)
    rng = np.random.default_rng(seed)
    T = _twist(rng, [0.3, 0.1, 0.5, 0.02, 0.04, 0.01])
    p_cur = p_prev @ T[:3, :3].T + T[:3, 3]
    uv_l, uv_r, _ = jcam.project_stereo(jcam.make_camera(**KITTI), jnp.asarray(p_cur))
    meas = np.concatenate([np.asarray(uv_l), np.asarray(uv_r)], 1)
    meas += rng.standard_normal(meas.shape) * 0.4
    out = rng.choice(N, N // 10, replace=False)
    meas[out] += rng.uniform(30, 120, (len(out), 4))
    mask = rng.random(N) > 0.05
    return p_prev, meas.astype(np.float32), mask


UVD_CAM = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, baseline_m=0.075, rows=480, cols=640)


def _uvd(seed):
    p_prev = _points(np.random.default_rng(0), 319.5, 239.5, 525.0, 580, 440, 1.0, 8.0)
    rng = np.random.default_rng(seed)
    T = _twist(rng, [0.05, 0.05, 0.1, 0.01, 0.02, 0.01])
    p_cur = p_prev @ T[:3, :3].T + T[:3, 3]
    meas = np.stack([525 * p_cur[:, 0] / p_cur[:, 2] + 319.5,
                     525 * p_cur[:, 1] / p_cur[:, 2] + 239.5, p_cur[:, 2]], 1)
    meas += rng.standard_normal(meas.shape) * [0.5, 0.5, 0.01]
    out = rng.choice(N, N // 10, replace=False)
    meas[out, :2] += rng.uniform(20, 60, (len(out), 2))
    reliable = rng.random(N) > 0.2
    return UVD_CAM, p_prev, meas.astype(np.float32), reliable


def _icp(seed):
    rng = np.random.default_rng(seed)
    mov = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    T = _twist(rng, [0.2, 0.2, 0.2, 0.05, 0.05, 0.05])
    fix = mov @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.02, (N, 3))
    fix[:N // 8] += rng.uniform(2, 6, (N // 8, 3))
    return mov, fix.astype(np.float32), rng.random(N) > 0.1


SEEDS = (1, 2, 3)


def _solve_all(kind, torch_only=False):
    """(port results of the three problems as one batch, early exit;
    the same on the frozen route; JAX's result for each problem)."""
    cfg = tgn.GNConfig()
    if kind == "stereo":
        probs = [_stereo(s) for s in SEEDS]
        cam = tcam.make_camera(**KITTI, device="cpu")
        p_prev = torch.from_numpy(probs[0][0])
        data = tal.StereoUVData(p_prev, torch.from_numpy(np.stack([p[1] for p in probs])),
                                torch.ones(N))
        mask = torch.from_numpy(np.stack([p[2] for p in probs]))

        def port():
            return tal.stereo_uv_align_fast(cam, data, mask, torch.eye(4).repeat(3, 1, 1), cfg)

        def jax(i):
            p = probs[i]
            return jal.stereo_uv_align_fast(
                jcam.make_camera(**KITTI),
                jal.StereoUVData(jnp.asarray(p[0]), jnp.asarray(p[1]), jnp.ones(N)),
                jnp.asarray(p[2]), jnp.eye(4), jgn.GNConfig())
    elif kind == "uvd":
        probs = [_uvd(s) for s in SEEDS]
        args = probs[0][0]
        probs = [(probs[0][1],) + p[2:] for p in probs]
        cam = tcam.make_camera(**args, device="cpu")
        data = tal.UVDData(torch.from_numpy(probs[0][0]),
                           torch.from_numpy(np.stack([p[1] for p in probs])), torch.ones(N),
                           torch.from_numpy(np.stack([p[2] for p in probs])))
        mask = torch.ones(3, N, dtype=torch.bool)

        def port():
            return tal.uvd_align(cam, data, mask, torch.eye(4).repeat(3, 1, 1), cfg)

        def jax(i):
            p = probs[i]
            return jal.uvd_align(jcam.make_camera(**args),
                                 jal.UVDData(jnp.asarray(p[0]), jnp.asarray(p[1]), jnp.ones(N),
                                             jnp.asarray(p[2])),
                                 jnp.ones(N, bool), jnp.eye(4), jgn.GNConfig())
    else:
        probs = [_icp(s) for s in SEEDS]
        cfg = tgn.GNConfig(kernel_max_error=0.25, min_num_inliers=8, max_iterations=50)
        data = tal.ICPData(*(torch.from_numpy(np.stack([p[k] for p in probs])) for k in (0, 1)),
                           torch.ones(3, N))
        mask = torch.from_numpy(np.stack([p[2] for p in probs]))

        def port():
            return tal.icp_align(data, mask, torch.eye(4).repeat(3, 1, 1), cfg)

        def jax(i):
            p = probs[i]
            return jal.icp_align(jal.ICPData(jnp.asarray(p[0]), jnp.asarray(p[1]), jnp.ones(N)),
                                 jnp.asarray(p[2]), jnp.eye(4),
                                 jgn.GNConfig(kernel_max_error=0.25, min_num_inliers=8,
                                              max_iterations=50))
    early = port()
    with control.masked():
        frozen = port()
    return early, frozen, [jax(i) for i in range(3)]


@pytest.mark.parametrize("kind", ["stereo", "uvd", "icp"])
def test_two_phase_early_exit_equals_the_frozen_loop_and_counts_as_jax(kind):
    early, frozen, jres = _solve_all(kind)
    for name, a, b in zip(early._fields, early, frozen):
        assert torch.equal(a, b), name
    for i, j in enumerate(jres):
        assert int(early.num_iterations[i]) == int(j.num_iterations), (i, early.num_iterations)
        assert int(early.num_inliers[i]) == int(j.num_inliers), i
        np.testing.assert_allclose(early.x[i].numpy(), np.asarray(j.x), atol=1e-5)
    assert int(early.num_iterations.min()) >= 2 and bool(early.converged.all())


# ---------------------------------------------------------------------------
# The closure ICP bucket
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [3, 5, 11])
@pytest.mark.parametrize("solver", ["gn", "fast"])
def test_padded_icp_bucket_equals_the_unpadded_batch(B, solver):
    rng = np.random.default_rng(B)
    cap = 256
    xi = torch.from_numpy((rng.normal(size=(B, 6)) * 0.1).astype(np.float32))
    mov = torch.from_numpy(rng.uniform(-5, 5, (B, cap, 3)).astype(np.float32))
    fix = tlie.transform_points(tlie.exp_se3(xi)[:, None], mov)
    fix = fix + torch.from_numpy(rng.normal(0, 0.05, (B, cap, 3)).astype(np.float32))
    mask = torch.from_numpy(np.arange(cap)[None] < rng.integers(20, cap, (B, 1)))
    T0 = torch.eye(4).repeat(B, 1, 1)
    cfg = tgn.GNConfig(kernel_max_error=0.25, min_num_inliers=8, max_iterations=50)
    solve = tal.icp_align if solver == "gn" else anderson.fast_icp_align
    unpadded = solve(tal.ICPData(mov, fix, torch.ones(B, cap)), mask, T0, cfg)
    prog = rl.ICPProgram(solve, cfg, rl.icp_bucket(B), cap, "cpu")
    for _ in range(2):  # the buffers are reused
        padded = prog.run(mov, fix, mask, T0)
        assert padded.x.shape[0] == (8 if B <= 8 else 16)
        for name, a, b in zip(padded._fields, padded, unpadded):
            assert torch.equal(a[:B], b), name
        assert not bool(padded.converged[B:].any())


def test_icp_buckets():
    assert [rl.icp_bucket(b) for b in (1, 8, 9, 16)] == [8, 8, 16, 16]
    with pytest.raises(ValueError):
        rl.icp_bucket(17)
