"""Port parity: the fused FAST/BRIEF front-end (K1's plain version), its
binning tail, descriptor lookup and the two matchers, against vslam_tpu.

The JAX side runs the TPU kernel through the Pallas interpreter on the
CPU, as tests/test_pallas_frontend.py does.  Tolerance: none — every
output is compared for equality.  Planes and scores are compared on the
interior (>= 16 px from the edge: the TPU kernel's NMS wraps its edge
columns, the port's does not); the band reduction is compared whole,
since its border mask (>= 16 px) keeps the edge out of it.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vslam_tpu.frontend import brief as jbrief
from vslam_tpu.frontend import matching as jmatch
from vslam_tpu.frontend import pallas_frontend as jpf
from vslam_tpu_torch.frontend import fast_brief as fb
from vslam_tpu_torch.frontend import matching as tmatch

# Under pytest-xdist each core runs a worker process; torch's own intra-op
# threads on top of that oversubscribe the CPU and slow these tests ~30x.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RNG = np.random.default_rng(7)
EDGE = 16


def _imgs(h, w, uint8_valued):
    imgs = RNG.uniform(0, 255, (2, h, w)).astype(np.float32)
    return np.round(imgs) if uint8_valued else imgs


def _jax_k1(imgs, thr, arc_len, border=20):
    out = jpf.fast_brief_frontend_pair(jnp.asarray(imgs), jnp.float32(thr),
                                       arc_len=arc_len, border=border,
                                       interpret=True)
    return [np.asarray(a) for a in out]


def test_pattern_and_circle_are_the_reference_constants():
    from vslam_tpu.frontend import detect

    np.testing.assert_array_equal(fb.PATTERN, np.asarray(jbrief._PAT))
    np.testing.assert_array_equal(fb.CIRCLE, detect.CIRCLE)


def _exact_fma_f32(a, b, c):
    """Correctly rounded f32 a*b + c by exact rational arithmetic."""
    from fractions import Fraction

    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(v))
    cands = [r, np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))]
    dist = [abs(Fraction(float(x)) - v) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda x: int(np.array(x).view(np.int32)) & 1)


def test_plain_fma_is_correctly_rounded():
    """The plain version's f64 FMA emulation equals a true f32 FMA,
    including the double-rounding cases (sum on an f32 midpoint)."""
    a = np.float32(1 + 2.0**-12)
    mid_cases = [(a, a, np.float32(2.0**-80)), (a, a, np.float32(-(2.0**-80))),
                 (-a, a, np.float32(2.0**-80)), (a, a, np.float32(0.0))]
    rnd = np.random.default_rng(11)
    x = (rnd.standard_normal((3, 300)) * 10.0 ** rnd.integers(-12, 12, (3, 300)))
    cases = mid_cases + [tuple(np.float32(v) for v in col) for col in x.T]
    A, B, C = (torch.tensor(np.array(v, np.float32)) for v in zip(*cases))
    got = fb._fma(A, B, C).numpy()
    want = np.array([_exact_fma_f32(*c) for c in cases], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arc_len,uint8_valued,shape,thr", [
    (9, False, (96, 260), 18.0),
    (12, False, (80, 200), 25.0),
    (9, True, (64, 140), 10.0),
    (12, True, (96, 300), 20.0),
])
def test_k1_plain_version_matches_pallas_kernel(arc_len, uint8_valued, shape, thr):
    imgs = _imgs(*shape, uint8_valued)
    j_planes, j_score, j_rowmax, j_rowarg = _jax_k1(imgs, thr, arc_len)
    t_planes, t_score, t_rowmax, t_rowarg = (
        a.numpy() for a in fb.fast_brief_frontend_pair(
            torch.from_numpy(imgs), torch.tensor(thr), arc_len=arc_len)
    )
    e = EDGE
    np.testing.assert_array_equal(t_planes[:, :, e:-e, e:-e],
                                  j_planes.view(np.int32)[:, :, e:-e, e:-e])
    np.testing.assert_array_equal(t_score[:, e:-e, e:-e], j_score[:, e:-e, e:-e])
    np.testing.assert_array_equal(t_rowmax, j_rowmax)
    np.testing.assert_array_equal(t_rowarg, j_rowarg)


def test_band_tail_matches_jax_on_uint8_images():
    """Integer FAST scores tie often: the tail's tie order (lowest row,
    then column inside a cell; lower cell index across cells) must match
    lax.top_k's exactly."""
    h, w, cap = 112, 390, 96
    imgs = _imgs(h, w, uint8_valued=True)
    _, _, rowmax, rowarg = _jax_k1(imgs, 5.0, 9)
    t_uv, t_s, t_v = fb.keypoints_from_band_reduction(
        torch.tensor(rowmax), torch.tensor(rowarg), h, w, 16, cap)
    ties = 0
    for b in range(2):
        j_uv, j_s, j_v = jpf.keypoints_from_band_reduction(
            jnp.asarray(rowmax[b]), jnp.asarray(rowarg[b]), h, w, 16, cap)
        np.testing.assert_array_equal(t_uv[b].numpy(), np.asarray(j_uv))
        np.testing.assert_array_equal(t_s[b].numpy(), np.asarray(j_s))
        np.testing.assert_array_equal(t_v[b].numpy(), np.asarray(j_v))
        ties += len(j_s) - len(np.unique(np.asarray(j_s)))
    assert ties > 0  # the case under test occurred


def test_band_tail_pads_past_the_cell_count():
    h, w = 48, 128  # 3 x 8 = 24 cells < capacity
    imgs = _imgs(h, w, uint8_valued=True)
    _, _, rowmax, rowarg = _jax_k1(imgs, 5.0, 9)
    t_uv, t_s, t_v = fb.keypoints_from_band_reduction(
        torch.tensor(rowmax), torch.tensor(rowarg), h, w, 16, 32)
    j_uv, j_s, j_v = jpf.keypoints_from_band_reduction(
        jnp.asarray(rowmax[0]), jnp.asarray(rowarg[0]), h, w, 16, 32)
    np.testing.assert_array_equal(t_uv[0].numpy(), np.asarray(j_uv))
    np.testing.assert_array_equal(t_v[0].numpy(), np.asarray(j_v))


def test_gather_descriptors_matches_jax():
    planes = RNG.integers(0, 2**32, (8, 40, 60), dtype=np.uint32)
    uv = RNG.uniform(-3, 65, (50, 2)).astype(np.float32)  # some out of bounds
    uv[:5] = np.array([[2.5, 3.5]], np.float32)  # round-half-even cases
    got = fb.gather_descriptors(torch.from_numpy(planes.view(np.int32)), (40, 60),
                                torch.from_numpy(uv))
    want = jbrief.gather_descriptors(jnp.asarray(planes), (40, 60), jnp.asarray(uv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))


def _keypoint_sets(n, m, bits):
    uv_a = RNG.uniform(0, 200, (n, 2)).astype(np.float32)
    uv_b = uv_a[RNG.integers(0, n, m)] + RNG.normal(0, 2, (m, 2)).astype(np.float32)
    d_a = RNG.integers(0, 2**32, (n, 8), dtype=np.uint32) & np.uint32(bits)
    d_b = RNG.integers(0, 2**32, (m, 8), dtype=np.uint32) & np.uint32(bits)
    return (uv_a, d_a, RNG.uniform(size=n) < 0.9,
            uv_b.astype(np.float32), d_b, RNG.uniform(size=m) < 0.9)


def _both(j_fn, t_fn, arrays, *scalars):
    j = j_fn(*(jnp.asarray(a) for a in arrays), *scalars)
    t = t_fn(*(torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)) for a in arrays), *scalars)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [0xFFFFFFFF, 0x0000F00F])
def test_match_stereo_and_projective_exact(bits):
    uv_a, d_a, m_a, uv_b, d_b, m_b = _keypoint_sets(120, 150, bits)
    uv_b[:, 1] = uv_a[RNG.integers(0, 120, 150), 1]  # share epipolar rows
    _both(jmatch.match_stereo, tmatch.match_stereo,
          (uv_a, d_a, m_a, uv_b, d_b, m_b), 60, 1.5, 0.0, 200.0)
    _both(jmatch.match_projective, tmatch.match_projective,
          (uv_a, d_a, m_a, uv_b, d_b, m_b), 12.0, 70)

