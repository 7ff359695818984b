"""Windowed bundle adjustment (backend/ba.py) against the JAX package's
on the CPU, on a random problem: P=6 cameras, L=48 landmarks, O=4 slots,
masked slots, invalid landmarks, outliers past the robust kernel.

Tolerances (f32 sums in another order, a closed-form 3x3 inverse for
JAX's LU, Newton's polar factor for JAX's SVD):
  * Jacobians: 1e-4 relative to the largest entry against JAX's jacfwd;
    1e-10 against torch.func.jacfwd in float64;
  * reduced system: 1e-5 relative to the largest entry of S, b_S, Winv,
    b_l and Y, chi2 within rtol 1e-5;
  * 10 rounds: poses within 1e-5, points within 1e-4 m, every round's
    chi2 within rtol 1e-4 (measured: 2e-6, 2e-5, 2e-5);
  * padded and true sizes: poses within 1e-6, points within 1e-4 m (the
    products sum over more rows; measured 1.05e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.backend import ba as jba
from vslam_tpu.ops import camera as jcam
from vslam_tpu.ops import lie as jlie
from vslam_tpu_torch.backend import ba as tba
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.ops import lie as tlie

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAM = dict(fx=300.0, fy=300.0, cx=160.0, cy=80.0, baseline_m=0.3, rows=160, cols=320)


def _se3(xi):
    return tlie.exp_se3(torch.tensor(np.asarray(xi), dtype=torch.float32)).numpy()


def make_problem(seed=0, P=6, L=48, O=4, odo=True):
    """A random window: cameras 0.3 m apart, landmarks 5-15 m ahead
    observed by O distinct cameras (0.5 px noise, every 7th landmark's
    first slot a 30 px outlier), 20% of the slots past the first two
    masked, every 11th landmark invalid, cameras 1.. and all points
    perturbed; camera 0 is the gauge.  Returns JAX-layout numpy fields."""
    rng = np.random.default_rng(seed)
    T = np.stack([_se3(np.r_[0.3 * p, 0.02 * rng.normal(size=2), 0.01 * rng.normal(size=3)])
                  for p in range(P)])
    X = np.c_[rng.uniform(-4, 4, L), rng.uniform(-2, 2, L), rng.uniform(5, 15, L)]
    obs_cam = np.stack([rng.choice(P, O, replace=False) for _ in range(L)]).astype(np.int32)
    Tc = T[obs_cam]  # (L, O, 4, 4)
    pc = np.einsum("loji,loj->loi", Tc[..., :3, :3], X[:, None] - Tc[..., :3, 3])
    fx, fy, cx, cy, b = (CAM[k] for k in ("fx", "fy", "cx", "cy", "baseline_m"))
    u = fx * pc[..., 0] / pc[..., 2] + cx
    v = fy * pc[..., 1] / pc[..., 2] + cy
    uv4 = np.stack([u, v, u - fx * b / pc[..., 2], v], axis=-1)
    uv4 = (uv4 + rng.normal(0, 0.5, uv4.shape)).astype(np.float32)
    uv4[::7, 0] += 30.0
    mask = rng.uniform(size=(L, O)) > 0.2
    mask[:, :2] = True
    valid = np.ones(L, bool)
    valid[::11] = False
    T0 = T.copy()
    for p in range(1, P):
        T0[p] = _se3(rng.normal(0, [0.05] * 3 + [0.01] * 3)) @ T[p]
    d = dict(T_wc=T0.astype(np.float32),
             xyz=(X + rng.normal(0, 0.1, X.shape)).astype(np.float32),
             obs_cam=obs_cam, obs_uv4=uv4,
             obs_weight=rng.uniform(1, 3, (L, O)).astype(np.float32), obs_mask=mask,
             lm_valid=valid, cam_fixed=np.arange(P) == 0)
    if odo:
        odo_T = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        for k in range(P - 1):
            odo_T[k] = np.linalg.inv(T0[k]) @ T0[k + 1]
        d.update(odo_T=odo_T, odo_weight=np.ones(P, np.float32),
                 odo_info=np.asarray([10.0] * 3 + [1e4] * 3, np.float32))
    return d


def _jax_problem(d):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def cams():
    return jcam.make_camera(**CAM), tcam.make_camera(**CAM, device="cpu")


def _jax_jacobians(jc, T, x, uv4):
    """The JAX package's per-observation linearization (ba.py:74-86)."""

    def r_of(dx_cam, xx):
        p_c = jlie.transform_points(jlie.inverse(jlie.exp_se3(dx_cam) @ T), xx)
        uv_l, uv_r, _ = jcam.project_stereo(jc, p_c)
        return jnp.concatenate([uv_l, uv_r]) - uv4

    z6 = jnp.zeros(6, jnp.float32)
    return (r_of(z6, x), jax.jacfwd(r_of, argnums=0)(z6, x),
            jax.jacfwd(r_of, argnums=1)(z6, x))


def test_jacobians_match_jax_jacfwd(cams):
    jc, tc = cams
    d = make_problem()
    f = jax.jit(jax.vmap(lambda T, x, m: _jax_jacobians(jc, T, x, m)))
    T = d["T_wc"][d["obs_cam"]].reshape(-1, 4, 4)
    x = np.repeat(d["xyz"], 4, axis=0)
    uv4 = d["obs_uv4"].reshape(-1, 4)
    rj, Jcj, Jlj = (np.asarray(a) for a in f(T, x, uv4))
    rt, Jct, Jlt = (a.numpy() for a in tba.stereo_residual_jacobians(
        tc, torch.from_numpy(T), torch.from_numpy(x), torch.from_numpy(uv4)))
    assert _rel(rt, rj) <= 1e-5
    assert _rel(Jct, Jcj) <= 1e-4, _rel(Jct, Jcj)
    assert _rel(Jlt, Jlj) <= 1e-4, _rel(Jlt, Jlj)


def test_jacobians_match_torch_jacfwd_in_float64():
    cam = tcam.make_camera(**CAM, device="cpu")
    cam = cam._replace(K=cam.K.double(), baseline_m=cam.baseline_m.double(),
                       K_inv=cam.K_inv.double())
    d = make_problem(seed=3)
    T = torch.from_numpy(d["T_wc"][2]).double()
    for x, uv4 in zip(d["xyz"][:8], d["obs_uv4"][:8, 0]):
        x = torch.from_numpy(x).double()
        uv4 = torch.from_numpy(uv4).double()

        def r_of(dx, xx):
            p_c = tlie.transform_points(tlie.inverse(tlie.exp_se3(dx) @ T), xx)
            uv_l, uv_r, _ = tcam.project_stereo(cam, p_c)
            return torch.cat([uv_l, uv_r]) - uv4

        z6 = torch.zeros(6, dtype=torch.float64)
        Jc_ad = torch.func.jacfwd(r_of, argnums=0)(z6, x)
        Jl_ad = torch.func.jacfwd(r_of, argnums=1)(z6, x)
        _, Jc, Jl = tba.stereo_residual_jacobians(cam, T, x, uv4)
        assert _rel(Jc, Jc_ad) <= 1e-10
        assert _rel(Jl, Jl_ad) <= 1e-10


def test_reduced_system_matches_jax(cams):
    jc, tc = cams
    d = make_problem()
    jp = _jax_problem(d)
    tp = from_jax.ba_problem_from_numpy(d)
    for k, v in from_jax.ba_problem_to_numpy(tp).items():
        assert v.dtype == d[k].dtype, k
        np.testing.assert_array_equal(v, d[k], err_msg=k)
    ref = jax.jit(lambda p: jba.build_reduced_system(jc, p.T_wc, p, jba.BAConfig()))(jp)
    got = tba.build_reduced_system(tc, tp.T_wc, tp, tba.BAConfig())
    # The robust weight is active: some observations sit past the kernel.
    assert np.asarray(got[-1]) > 0
    for name, a, b in zip(("S", "b_S", "Winv", "b_l", "Y"), got[:5], ref[:5]):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b) <= 1e-5, (name, _rel(a.numpy(), b))
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), rtol=1e-5)


@pytest.mark.parametrize("odo", [False, True], ids=["no_odometry", "odometry"])
def test_bundle_adjust_matches_jax(cams, odo):
    jc, tc = cams
    d = make_problem(odo=odo)
    Tj, Xj, cj = (np.asarray(a) for a in jba.bundle_adjust(jc, _jax_problem(d)))
    Tt, Xt, ct = (a.numpy() for a in tba.bundle_adjust(tc, from_jax.ba_problem_from_numpy(d)))
    assert ct.shape == cj.shape == (10,)
    assert cj[-1] < 0.1 * cj[0]  # the problem converges
    assert np.abs(Tt - Tj).max() <= 1e-5
    assert np.abs(Xt - Xj).max() <= 1e-4
    np.testing.assert_allclose(ct, cj, rtol=1e-4)


def test_padded_and_true_sizes_agree(cams):
    """The runners (the JAX package's, and the port's since its solve
    became a program a bucket) pad L to a power of two (invalid, masked
    rows) and P to the window (frozen cameras with no observations and
    zero-weight odometry): the same answer as the true size."""
    _, tc = cams
    d = make_problem()
    P, L = d["T_wc"].shape[0], d["xyz"].shape[0]
    Pp, Lp = 16, 64
    pad = dict(d)
    pad["T_wc"] = np.concatenate([d["T_wc"], np.tile(np.eye(4, dtype=np.float32),
                                                     (Pp - P, 1, 1))])
    pad["cam_fixed"] = np.r_[d["cam_fixed"], np.ones(Pp - P, bool)]
    pad["odo_T"] = np.concatenate([d["odo_T"], np.tile(np.eye(4, dtype=np.float32),
                                                       (Pp - P, 1, 1))])
    pad["odo_weight"] = np.r_[d["odo_weight"][:P - 1], np.zeros(Pp - P + 1, np.float32)]
    for k in ("xyz", "obs_cam", "obs_uv4", "obs_weight", "obs_mask", "lm_valid"):
        a = d[k]
        pad[k] = np.concatenate([a, np.zeros((Lp - L,) + a.shape[1:], a.dtype)])
    Tt, Xt, _ = tba.bundle_adjust(tc, from_jax.ba_problem_from_numpy(d))
    Tp, Xp, _ = tba.bundle_adjust(tc, from_jax.ba_problem_from_numpy(pad))
    assert np.abs(Tp[:P].numpy() - Tt.numpy()).max() <= 1e-6
    assert np.abs(Xp[:L].numpy() - Xt.numpy()).max() <= 1e-4
    np.testing.assert_array_equal(Tp[P:].numpy(), pad["T_wc"][P:])
    np.testing.assert_array_equal(Xp[L:].numpy(), 0.0)


def test_failed_cholesky_gives_a_zero_camera_step(cams):
    """A reduced system that is not positive definite: JAX's cho_factor
    gives NaNs, zeroed by its isfinite guard; the port's cholesky_ex
    reports the failure and takes the same zero camera step, then
    back-substitutes the landmarks on it.  Poses within 1e-6, points
    within 1e-4 m of JAX's (measured 5.3e-5: Winv and b_l in another
    rounding, on steps of up to 5 m)."""
    jc, tc = cams
    d = make_problem()
    jp = _jax_problem(d)
    tp = from_jax.ba_problem_from_numpy(d)
    S, b_S, Winv, b_l, Y, _ = tba.build_reduced_system(tc, tp.T_wc, tp, tba.BAConfig())
    S_bad = -S  # negative definite
    T_new, xyz_new = tba.solve_reduced_and_backsub(tp.T_wc, tp, S_bad, b_S, Winv, b_l, Y,
                                                   tba.BAConfig())
    np.testing.assert_allclose(T_new.numpy(), d["T_wc"], atol=1e-6)
    dx_l = -torch.einsum("lij,lj->li", Winv, b_l)
    n = torch.linalg.vector_norm(dx_l, dim=1, keepdim=True)
    dx_l = dx_l * torch.clamp(5.0 / n, max=1.0) * tp.lm_valid[:, None]
    np.testing.assert_allclose(xyz_new.numpy(), (tp.xyz + dx_l).numpy(), atol=1e-6)
    assert not np.allclose(xyz_new.numpy(), d["xyz"])  # the landmarks did move

    Sj, bj, Wj, blj, Yj, _ = jba.build_reduced_system(jc, jp.T_wc, jp, jba.BAConfig())
    Tj, Xj = jba.solve_reduced_and_backsub(jp.T_wc, jp, -Sj, bj, Wj, blj, Yj,
                                           jba.BAConfig())
    assert np.abs(T_new.numpy() - np.asarray(Tj)).max() <= 1e-6
    assert np.abs(xyz_new.numpy() - np.asarray(Xj)).max() <= 1e-4
