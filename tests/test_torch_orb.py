"""Port parity: the ORB256 descriptor (frontend/orb.py: orientations,
the bilinear gather, describe), ops/hamming.py::pack_bits, and the
rotation / lighting stress material of io/synthetic.py, against
vslam_tpu on the CPU, on rendered 128 x 192 frames.

Tolerances:
  * pack_bits, roll_trajectory, render_stressed, _bilinear: exact;
  * orientations: within 1e-4 rad (the 961-pixel disk sums run in
    another order than XLA's reduction; measured 6.9e-5);
  * describe: the differing bits are counted and at most 0.1% (a bit
    flips only where its two samples tie within rounding; measured 0).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.frontend import detect as jdet
from vslam_tpu.frontend import orb as jorb
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.ops import camera as jcam
from vslam_tpu.ops import hamming as jham
from vslam_tpu_torch.frontend import orb as torb
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.ops import hamming as tham

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAM_ARGS = dict(fx=300.0, fy=300.0, cx=96.0, cy=64.0, baseline_m=0.4, rows=128, cols=192)
ROLL = dict(step=0.35, roll_amplitude_deg=15.0, roll_period=16)


@pytest.fixture(scope="module")
def worlds():
    jposes, jrolls = jsyn.roll_trajectory(12, **ROLL)
    tposes, trolls = tsyn.roll_trajectory(12, **ROLL)
    jw = jsyn.make_world(jcam.make_camera(**CAM_ARGS), n_points=1500, seed=11, poses=jposes)
    tw = tsyn.make_world(tcam.make_camera(**CAM_ARGS, device="cpu"), n_points=1500,
                         seed=11, poses=tposes)
    return (jposes, jrolls, jw), (tposes, trolls, tw)


def _keypoints(img):
    kp = jdet.detect_keypoints(jnp.asarray(img), jnp.float32(12.0), 12, 256, 16)
    assert int(kp.valid.sum()) > 80
    return np.asarray(kp.uv)


def _differing_bits(a, b):
    return int(np.unpackbits((a ^ b).view(np.uint8)).sum())


def test_pack_bits_is_exact():
    rng = np.random.default_rng(0)
    bits = rng.random((300, 256)) < 0.5
    bits[0] = True  # every word's sign bit set
    bits[1] = False
    want = np.asarray(jham.pack_bits(jnp.asarray(bits))).view(np.int32)
    got = tham.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tham.unpack_bits(torch.from_numpy(got)).numpy(), bits)


def test_roll_trajectory_and_render_stressed_are_exact(worlds):
    (jposes, jrolls, jw), (tposes, trolls, tw) = worlds
    np.testing.assert_array_equal(tposes, jposes)
    np.testing.assert_array_equal(trolls, jrolls)
    assert np.abs(trolls).max() > np.deg2rad(10.0)
    for t, gain, offset in ((0, 1.0, 0.0), (4, 1.2, -10.0), (9, 0.8, 15.0)):
        want = jsyn.render_stressed(jw, t, roll_rad=float(jrolls[t]), gain=gain, offset=offset)
        got = tsyn.render_stressed(tw, t, roll_rad=float(trolls[t]), gain=gain, offset=offset)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_bilinear_clamps_as_jax():
    """Coordinates past every edge, NaN, and in-range ones, against JAX's
    _bilinear as written (eager: jitted alone, XLA contracts the weighted
    sum into FMAs and 18% of these samples move by an ulp; inside
    describe no descriptor bit moved in these tests)."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    r = np.r_[rng.uniform(-10, 50, 300), np.nan, 39.5, 0.0].astype(np.float32)
    c = np.r_[rng.uniform(-10, 66, 300), 3.0, np.nan, 55.999].astype(np.float32)
    want = np.asarray(jorb._bilinear(jnp.asarray(img), jnp.asarray(r), jnp.asarray(c)))
    got = torb._bilinear(torch.from_numpy(img), torch.from_numpy(r), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("frame", [0, 4])
def test_orientations_match_jax(worlds, frame):
    (_, jrolls, jw), _ = worlds
    img = jsyn.render_stressed(jw, frame, roll_rad=float(jrolls[frame]))[0]
    uv = _keypoints(img)
    smooth = np.asarray(jax.jit(jorb.box_blur)(jnp.asarray(img)))
    want = np.asarray(jax.jit(jorb.orientations)(jnp.asarray(smooth), jnp.asarray(uv)))
    got = torb.orientations(torch.from_numpy(smooth), torch.from_numpy(uv)).numpy()
    d = np.abs(got - want)
    assert np.minimum(d, 2 * np.pi - d).max() <= 1e-4


@pytest.mark.parametrize("frame", [0, 4, 8])
def test_describe_matches_jax(worlds, frame):
    """Frame 0 is upright; frames 4 and 8 roll by 15 and -15 degrees with
    the patches rotated and the lighting changed."""
    (_, jrolls, jw), _ = worlds
    img = jsyn.render_stressed(jw, frame, roll_rad=float(jrolls[frame]),
                               gain=1.0 if frame == 0 else 1.15, offset=0.0)[0]
    uv = _keypoints(img)
    want = np.asarray(jorb.describe(jnp.asarray(img), jnp.asarray(uv))).view(np.int32)
    got = torb.describe(torch.from_numpy(img), torch.from_numpy(uv)).numpy()
    n_diff = _differing_bits(got, want)
    print(f"describe, frame {frame}: {n_diff} of {want.size * 32} bits differ")
    assert n_diff <= 1e-3 * want.size * 32
