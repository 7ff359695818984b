"""The generic robust Gauss-Newton engine (solve/gn.py gauss_newton), its
residual factories and the autodiff stereo aligner (solve/aligners.py)
against the JAX package's on the CPU, and render_photo_plane against
JAX's.

  * stereo_uv_align on tests/test_aligners.py's problems (exact, noisy,
    25% outliers, half masked), the UVD and ICP residuals through
    gauss_newton against JAX's uvd_align / icp_align (both the generic
    engine there), and a Euclidean state with the default additive
    retraction: the solution within 1e-5 of JAX's, the inlier count
    equal;
  * the port's stereo_uv_align_fast against its stereo_uv_align, to
    test_fast_stereo_aligner_matches_generic's tolerances (1e-4 on the
    pose, inlier counts within 5), and the closed-form Jacobian against
    the autodiff one (1e-3 on r, 1e-2 on J, as there);
  * render_photo_plane on a smooth seeded "photo" at two poses: within
    1e-4 gray levels of JAX's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.ops import camera as jcam
from vslam_tpu.ops import lie as jlie
from vslam_tpu.solve import aligners as jal
from vslam_tpu.solve import gn as jgn
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.ops import lie as tlie
from vslam_tpu_torch.solve import aligners as tal
from vslam_tpu_torch.solve import gn as tgn

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

KITTI = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22, baseline_m=0.5372,
             rows=376, cols=1241)
N = 256


def _t(a):
    return torch.from_numpy(np.asarray(a))


def stereo_problem(seed, noise_px=0.0, outlier_frac=0.0, masked_half=False):
    """tests/test_aligners.py's make_stereo_problem, from a seed."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(4.0, 40.0, N)
    u = rng.uniform(100, KITTI["cols"] - 100, N)
    v = rng.uniform(40, KITTI["rows"] - 40, N)
    p_prev = np.stack([(u - 607.19) / 718.856 * z, (v - 185.22) / 718.856 * z, z],
                      1).astype(np.float32)
    xi = (rng.standard_normal(6) * [0.3, 0.1, 0.5, 0.02, 0.04, 0.01]).astype(np.float32)
    T_true = np.asarray(jlie.exp_se3(jnp.asarray(xi)))
    p_cur = p_prev @ T_true[:3, :3].T + T_true[:3, 3]
    uv_l, uv_r, _ = jcam.project_stereo(jcam.make_camera(**KITTI), jnp.asarray(p_cur))
    meas = np.concatenate([np.asarray(uv_l), np.asarray(uv_r)], 1)
    meas += rng.standard_normal(meas.shape).astype(np.float32) * noise_px
    n_out = int(outlier_frac * N)
    if n_out:
        idx = rng.choice(N, n_out, replace=False)
        meas[idx] += rng.uniform(30, 120, (n_out, 4)) * rng.choice([-1, 1], (n_out, 4))
    mask = np.ones(N, bool)
    if masked_half:
        meas[:N // 2] += 500.0
        mask[:N // 2] = False
    return p_prev, meas.astype(np.float32), mask, T_true


STEREO_CASES = {
    "exact": dict(seed=3),
    "noise": dict(seed=4, noise_px=0.5),
    "outliers": dict(seed=5, noise_px=0.3, outlier_frac=0.25),
    "masked": dict(seed=6, masked_half=True),
}


def _agree(jres, tres, atol=1e-5):
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=atol)
    assert int(tres.num_inliers) == int(jres.num_inliers)
    assert bool(tres.converged) == bool(jres.converged)
    np.testing.assert_array_equal(tres.inlier_mask.numpy(), np.asarray(jres.inlier_mask))


@pytest.mark.parametrize("case", list(STEREO_CASES))
def test_stereo_uv_align_matches_jax(case):
    p_prev, meas, mask, T_true = stereo_problem(**STEREO_CASES[case])
    jres = jal.stereo_uv_align(
        jcam.make_camera(**KITTI),
        jal.StereoUVData(jnp.asarray(p_prev), jnp.asarray(meas), jnp.ones(N, jnp.float32)),
        jnp.asarray(mask), jnp.eye(4))
    tres = tal.stereo_uv_align(
        tcam.make_camera(**KITTI, device="cpu"),
        tal.StereoUVData(_t(p_prev), _t(meas), torch.ones(N)), _t(mask), torch.eye(4))
    # (The round count is not held: at the f32 plateau the stop test reads
    # chi2 changes at rounding level.)
    _agree(jres, tres)
    assert np.abs(tres.x.numpy() - T_true).max() < 0.05


def test_uvd_residual_through_gauss_newton_matches_jax():
    rng = np.random.default_rng(7)
    args = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, baseline_m=0.075, rows=480, cols=640)
    z = rng.uniform(1.0, 8.0, N)
    u, v = rng.uniform(60, 580, N), rng.uniform(40, 440, N)
    p_prev = np.stack([(u - 319.5) / 525.0 * z, (v - 239.5) / 525.0 * z, z], 1).astype(np.float32)
    T_true = np.asarray(jlie.exp_se3(jnp.asarray([0.05, -0.03, 0.1, 0.02, 0.01, -0.015])))
    p_cur = p_prev @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([525.0 * p_cur[:, 0] / p_cur[:, 2] + 319.5,
                   525.0 * p_cur[:, 1] / p_cur[:, 2] + 239.5], 1)
    meas = np.concatenate([uv, p_cur[:, 2:]], 1).astype(np.float32)
    meas[:20] += rng.uniform(20, 40, (20, 3)).astype(np.float32)  # outliers
    reliable = rng.uniform(size=N) > 0.2
    jres = jal.uvd_align(
        jcam.make_camera(**args),
        jal.UVDData(jnp.asarray(p_prev), jnp.asarray(meas), jnp.ones(N, jnp.float32),
                    jnp.asarray(reliable)),
        jnp.ones(N, bool), jnp.eye(4))
    residual_fn, diag_fn = tal.make_uvd_residual(tcam.make_camera(**args, device="cpu"))
    tres = tgn.gauss_newton(
        residual_fn, torch.eye(4),
        tal.UVDData(_t(p_prev), _t(meas), torch.ones(N), _t(reliable)),
        torch.ones(N, dtype=torch.bool), tgn.GNConfig(), retract=tgn.se3_retract,
        diag_fn=diag_fn)
    _agree(jres, tres)
    # The production closed-form UVD solver agrees with the generic engine.
    fast = tal.uvd_align(tcam.make_camera(**args, device="cpu"),
                         tal.UVDData(_t(p_prev), _t(meas), torch.ones(N), _t(reliable)),
                         torch.ones(N, dtype=torch.bool), torch.eye(4))
    np.testing.assert_allclose(fast.x.numpy(), tres.x.numpy(), atol=1e-4)


@pytest.mark.parametrize("kernel,n_bad", [(1.0, 0), (0.25, 20)])
def test_icp_residual_through_gauss_newton_matches_jax(kernel, n_bad):
    rng = np.random.default_rng(11 + n_bad)
    p_mov = rng.uniform(-10, 10, (128, 3)).astype(np.float32)
    T_true = np.asarray(jlie.exp_se3(jnp.asarray([0.5, 0.2, -0.3, 0.05, 0.1, -0.08])))
    p_fix = p_mov @ T_true[:3, :3].T + T_true[:3, 3]
    p_fix[:n_bad] += rng.uniform(3, 8, (n_bad, 3))
    p_fix = p_fix.astype(np.float32)
    weight = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    cfg_j, cfg_t = jgn.GNConfig(kernel_max_error=kernel), tgn.GNConfig(kernel_max_error=kernel)
    jres = jal.icp_align(jal.ICPData(jnp.asarray(p_mov), jnp.asarray(p_fix), jnp.asarray(weight)),
                         jnp.ones(128, bool), jnp.eye(4), cfg_j)
    residual_fn, diag_fn = tal.make_icp_residual()
    data = tal.ICPData(_t(p_mov), _t(p_fix), _t(weight))
    mask = torch.ones(128, dtype=torch.bool)
    tres = tgn.gauss_newton(residual_fn, torch.eye(4), data, mask, cfg_t,
                            retract=tgn.se3_retract, diag_fn=diag_fn)
    _agree(jres, tres)
    # The production batched closed-form ICP agrees with the generic engine.
    fast = tal.icp_align(tal.ICPData(*(a[None] for a in data)), mask[None],
                         torch.eye(4)[None], cfg_t)
    np.testing.assert_allclose(fast.x[0].numpy(), tres.x.numpy(), atol=1e-4)
    assert int(fast.num_inliers[0]) == int(tres.num_inliers)


def test_euclidean_state_with_the_default_retraction_matches_jax():
    """A 3-vector state, additive steps, no diagonal information: a robust
    point fit (r = x - q_i), 10 of 64 measurements far off."""
    rng = np.random.default_rng(13)
    q = (np.array([1.0, -2.0, 3.0]) + rng.normal(0, 0.3, (64, 3))).astype(np.float32)
    q[:10] += 30.0
    mask = np.ones(64, bool)
    mask[-4:] = False
    cfg = dict(kernel_max_error=1.0, min_num_inliers=8)

    def j_res(x, q_i):
        return x - q_i, jnp.eye(3, dtype=jnp.float32)

    def t_res(x, q_i):
        return x - q_i, torch.eye(3)

    jres = jgn.gauss_newton(j_res, jnp.zeros(3, jnp.float32), jnp.asarray(q),
                            jnp.asarray(mask), jgn.GNConfig(**cfg))
    tres = tgn.gauss_newton(t_res, torch.zeros(3), _t(q), _t(mask), tgn.GNConfig(**cfg))
    _agree(jres, tres)
    assert int(tres.num_iterations) == int(jres.num_iterations)
    np.testing.assert_allclose(float(tres.chi2), float(jres.chi2), rtol=1e-4)


def test_robust_weights_match_jax():
    chi2 = np.array([0.0, 1e-13, 0.5, 25.0, 25.5, 1e4], np.float32)
    np.testing.assert_allclose(tgn._robust_weights(_t(chi2), 25.0).numpy(),
                               np.asarray(jgn._robust_weights(jnp.asarray(chi2), 25.0)),
                               rtol=1e-7)


def test_fast_stereo_aligner_matches_generic():
    """JAX's test_fast_stereo_aligner_matches_generic on the port's two
    solvers (same problem, same tolerances)."""
    rng = np.random.default_rng(2)
    n = 512
    p_prev = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n),
                       rng.uniform(4, 25, n)], 1).astype(np.float32)
    T_true = tlie.exp_se3(torch.tensor([0.05, -0.02, 0.3, 0.01, -0.02, 0.015]))
    cam = tcam.make_camera(**KITTI, device="cpu")
    uv_l, uv_r, _ = tcam.project_stereo(cam, tlie.transform_points(T_true, _t(p_prev)))
    meas = torch.cat([uv_l, uv_r], 1).numpy()
    meas += rng.normal(0, 0.2, meas.shape).astype(np.float32)
    out_idx = rng.choice(n, 40, replace=False)
    meas[out_idx] += rng.normal(0, 40, (40, 4)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-30:] = False
    data = tal.StereoUVData(_t(p_prev), _t(meas), torch.ones(n))

    residual_fn, _ = tal.make_stereo_uv_residual(cam)
    r_ad, J_ad = torch.func.vmap(residual_fn, in_dims=(None, 0))(torch.eye(4), data)
    r_an, J_an, _ = tal._stereo_r_J_analytic(cam, data.p_prev, data.meas)
    assert float((r_ad - r_an).abs().max()) < 1e-3
    assert float((J_ad - J_an).abs().max()) < 1e-2

    gen = tal.stereo_uv_align(cam, data, _t(mask), torch.eye(4))
    fast = tal.stereo_uv_align_fast(cam, data, _t(mask), torch.eye(4))
    assert float((fast.x - T_true).abs().max()) < 2e-3
    assert float((fast.x - gen.x).abs().max()) < 1e-4
    assert abs(int(fast.num_inliers) - int(gen.num_inliers)) <= 5


def _photo(seed, shape=(240, 320)):
    """A smooth random gray image: white noise, box-blurred twice."""
    img = np.random.default_rng(seed).uniform(0, 255, shape)
    for _ in range(2):
        pad = np.pad(img, 3, mode="edge")
        img = sum(pad[3 + dy:3 + dy + shape[0], 3 + dx:3 + dx + shape[1]]
                  for dy in range(-3, 4) for dx in range(-3, 4)) / 49.0
    return img.astype(np.float32)


@pytest.mark.parametrize("pose", ["frontal", "oblique"])
def test_render_photo_plane_matches_jax(pose):
    T = np.eye(4, dtype=np.float32)
    if pose == "oblique":
        T[:3, :3] = np.asarray(jlie.exp_so3(jnp.asarray([0.05, -0.12, 0.08], jnp.float32)))
        T[:3, 3] = [0.3, -0.2, 1.5]
    args = dict(fx=300.0, fy=300.0, cx=160.0, cy=96.0, baseline_m=0.4, rows=192, cols=320)
    photo = _photo(17)
    jl, jr = jsyn.render_photo_plane(photo, jcam.make_camera(**args), T)
    tl, tr = tsyn.render_photo_plane(photo, tcam.make_camera(**args, device="cpu"), T)
    assert tl.shape == (192, 320) and tl.dtype == np.float32
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    np.testing.assert_allclose(tr, jr, atol=1e-4)
    assert np.abs(tl - tr).max() > 1.0  # the two eyes differ
