"""Port parity: ops/ (SE(3), camera, Hamming) against vslam_tpu on the
inputs of test_lie.py, test_camera.py and test_hamming.py.

Tolerances: integer outputs (masks, Hamming distances, match indices)
must be identical; f32 outputs agree to atol=1e-5 — the two frameworks
order sums differently and XLA contracts multiply-adds on the CPU, so
results differ in the last bits (orthonormalize also uses a different
but equivalent algorithm: Newton's polar iteration against an SVD).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from vslam_tpu.ops import camera as jcam
from vslam_tpu.ops import hamming as jham
from vslam_tpu.ops import lie as jlie
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.ops import hamming as tham
from vslam_tpu_torch.ops import lie as tlie

# Under pytest-xdist each core runs a worker process; torch's own intra-op
# threads on top of that oversubscribe the CPU and slow these tests ~30x.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ATOL = 1e-5
RNG = np.random.default_rng(0)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _rotvecs(n, scale):
    return (RNG.standard_normal((n, 3)) * scale).astype(np.float32)


def _twists(n, scale):
    return (RNG.standard_normal((n, 6)) * scale).astype(np.float32)


def _rotations(n, seed):
    return Rsc.random(n, random_state=seed).as_matrix().astype(np.float32)


LIE_CASES = {
    "hat": (lambda: _rotvecs(16, 2.0), "hat"),
    "exp_so3": (lambda: _rotvecs(64, 2.0), "exp_so3"),
    "log_so3": (lambda: _rotations(32, 7), "log_so3"),
    "exp_se3": (lambda: _twists(32, 0.8), "exp_se3"),
    "exp_se3_small": (lambda: _twists(32, 1e-4), "exp_se3"),
    "rot_to_quat": (lambda: _rotations(32, 7), "rot_to_quat"),
    "rotation_angle": (lambda: _rotations(32, 3), "rotation_angle"),
}


@pytest.mark.parametrize("case", sorted(LIE_CASES))
def test_lie_unary_matches_jax(case):
    make, fn = LIE_CASES[case]
    x = make()
    _close(getattr(tlie, fn)(_t(x)), getattr(jlie, fn)(jnp.asarray(x)))


def test_log_se3_inverse_transform_match_jax():
    T = np.asarray(jlie.exp_se3(jnp.asarray(_twists(32, 0.8))))
    Tt = _t(T)
    _close(tlie.log_se3(Tt), jlie.log_se3(jnp.asarray(T)), atol=2e-5)
    _close(tlie.inverse(Tt), jlie.inverse(jnp.asarray(T)))
    pts = RNG.standard_normal((100, 3)).astype(np.float32)
    _close(tlie.transform_points(Tt[0], _t(pts)),
           jlie.transform_points(jnp.asarray(T[0]), jnp.asarray(pts)))
    _close(tlie.transform_point_cloud(Tt[0], _t(pts)),
           jlie.transform_point_cloud(jnp.asarray(T[0]), jnp.asarray(pts)))


def test_orthonormalize_matches_jax():
    R = _rotations(16, 3)
    noisy = R + RNG.standard_normal(R.shape).astype(np.float32) * 0.01
    _close(tlie.orthonormalize(_t(noisy)),
           jlie.orthonormalize(jnp.asarray(noisy)))


# -- camera ------------------------------------------------------------------

CAM_ARGS = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                baseline_m=0.5372, rows=376, cols=1241)
JCAM = jcam.make_camera(**CAM_ARGS)
TCAM = tcam.make_camera(**CAM_ARGS, device="cpu")


def _points(n, zmin=2.0, zmax=50.0):
    z = RNG.uniform(zmin, zmax, n)
    u = RNG.uniform(50, 1241 - 50, n)
    v = RNG.uniform(20, 376 - 20, n)
    return np.stack([(u - 607.19) / 718.856 * z, (v - 185.22) / 718.856 * z, z],
                    1).astype(np.float32)


def test_project_and_stereo_match_jax():
    p = _points(256)
    p[:8, 2] *= -1.0  # some behind the camera
    for t_out, j_out in zip(tcam.project_stereo(TCAM, _t(p)),
                            jcam.project_stereo(JCAM, jnp.asarray(p))):
        _close(t_out, j_out, atol=1e-3, rtol=1e-6)
    uv, z = jcam.project(JCAM, jnp.asarray(p))
    np.testing.assert_array_equal(
        tcam.in_field_of_view(TCAM, _t(uv),
                              _t(z), 20).numpy(),
        np.asarray(jcam.in_field_of_view(JCAM, uv, z, 20)),
    )


def test_back_project_and_triangulate_disparity_match_jax():
    p = _points(256)
    uv_l, uv_r, z = (np.array(a) for a in jcam.project_stereo(JCAM, jnp.asarray(p)))
    uv_r[:16, 0] = uv_l[:16, 0] - 0.5  # below the minimum disparity
    _close(tcam.back_project(TCAM, _t(uv_l), _t(z)),
           jcam.back_project(JCAM, jnp.asarray(uv_l), jnp.asarray(z)), rtol=1e-6)
    tp, tv = tcam.triangulate_disparity(TCAM, _t(uv_l),
                                        _t(uv_r), 1.0)
    jp, jv = jcam.triangulate_disparity(JCAM, jnp.asarray(uv_l), jnp.asarray(uv_r), 1.0)
    _close(tp, jp, rtol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_triangulate_midpoint_matches_jax():
    p_a = _points(128, zmin=4.0, zmax=40.0)
    T_a_b = jlie.exp_se3(jnp.asarray(np.array([0.8, 0.05, 0.4, 0.01, -0.02, 0.005],
                                              np.float32)))
    p_b = jlie.transform_point_cloud(jlie.inverse(T_a_b), jnp.asarray(p_a))
    uv_a = np.asarray(jcam.project(JCAM, jnp.asarray(p_a))[0])
    uv_b = np.asarray(jcam.project(JCAM, p_b)[0])
    jm, jv = jcam.triangulate_midpoint(JCAM, jnp.asarray(uv_a), jnp.asarray(uv_b), T_a_b)
    tm, tv = tcam.triangulate_midpoint(TCAM, _t(uv_a),
                                       _t(uv_b),
                                       _t(T_a_b))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(tm, jm, atol=1e-3, rtol=1e-5)


# -- Hamming -----------------------------------------------------------------


def _desc(n, bits_set=None):
    d = RNG.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    if bits_set is not None:  # few distinct values -> many distance ties
        d &= np.uint32(bits_set)
    return d


def test_hamming_pairwise_and_matrix_exact():
    a, b = _desc(40), _desc(40)
    np.testing.assert_array_equal(
        tham.hamming_pairwise(_t(a.view(np.int32)),
                              _t(b.view(np.int32))).numpy(),
        np.asarray(jham.hamming_pairwise(jnp.asarray(a), jnp.asarray(b))))
    q, db = _desc(37), _desc(53)
    np.testing.assert_array_equal(
        tham.hamming_matrix(_t(q.view(np.int32)),
                            _t(db.view(np.int32))).numpy(),
        np.asarray(jham.hamming_matrix(jnp.asarray(q), jnp.asarray(db))))


@pytest.mark.parametrize("bits_set", [None, 0x8000000F])
def test_masked_argmin_and_mutual_best_exact(bits_set):
    q, db = _desc(48, bits_set), _desc(64, bits_set)
    jd = jham.hamming_matrix(jnp.asarray(q), jnp.asarray(db))
    td = _t(jd)
    mask = RNG.uniform(size=(48, 64)) < 0.7
    mask[3] = False  # an all-masked row
    for gate in (0, 6, 300):
        for t_out, j_out in zip(
            tham.masked_argmin(td, _t(mask), gate),
            jham.masked_argmin(jd, jnp.asarray(mask), gate),
        ):
            np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        for t_out, j_out in zip(
            tham.mutual_best_match(td, _t(mask), gate),
            jham.mutual_best_match(jd, jnp.asarray(mask), gate),
        ):
            np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))


# -- closed-form solves ------------------------------------------------------


def _spd(n, dim):
    A = RNG.standard_normal((n, dim, dim)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + dim * np.eye(dim, dtype=np.float32)


@pytest.mark.parametrize("dim", [3, 6])
def test_closed_form_solves_match_jax(dim):
    from vslam_tpu.solve import gn as jgn
    from vslam_tpu_torch.solve import gn as tgn

    H = _spd(16, dim)
    b = RNG.standard_normal((16, dim)).astype(np.float32)
    inv = tgn.inv3 if dim == 3 else tgn.inv6
    jinv = jgn.inv3 if dim == 3 else jgn.inv6
    _close(inv(_t(H)), jinv(jnp.asarray(H)), atol=1e-5, rtol=1e-4)
    _close(tgn.solve_spd(_t(H), _t(b)), jgn.solve_spd(jnp.asarray(H), jnp.asarray(b)),
           atol=1e-5, rtol=1e-4)
    _close(tgn.solve_normal_equations(_t(H[0]), _t(b[0]), 1.0),
           jgn.solve_normal_equations(jnp.asarray(H[0]), jnp.asarray(b[0]), 1.0),
           atol=1e-5, rtol=1e-4)


def test_se3_retract_matches_jax():
    from vslam_tpu.solve import gn as jgn
    from vslam_tpu_torch.solve import gn as tgn

    T = np.asarray(jlie.exp_se3(jnp.asarray(_twists(1, 0.8)[0])))
    dx = _twists(1, 0.05)[0]
    _close(tgn.se3_retract(_t(T), _t(dx)), jgn.se3_retract(jnp.asarray(T), jnp.asarray(dx)))
