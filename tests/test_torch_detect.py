"""Port parity: FAST detection over the image pyramid (frontend/detect.py)
against vslam_tpu.

Tolerance: none.  Scores are sums of f32 threshold excesses taken in the
same order; keypoints are compared as sets in order (uv, score, valid,
octave), so the per-cell argmax and the top-K tie order must match
lax.argmax / lax.top_k exactly.  uint8-valued images make ties common.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.frontend import detect as jdet
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.ops import camera as jcam
from vslam_tpu_torch.frontend import detect as tdet

# Under pytest-xdist each core runs a worker process; torch's own intra-op
# threads on top of that oversubscribe the CPU and slow these tests ~30x.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _random(shape, seed):
    return np.round(np.random.default_rng(seed).uniform(0, 255, shape)).astype(np.float32)


def _rendered():
    cam = jcam.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                           rows=192, cols=512)
    world = jsyn.make_world(cam, n_frames=4, n_points=1500, seed=42, step=0.45)
    return np.asarray(jsyn.render_frame(world, 2)[0]).astype(np.uint8).astype(np.float32)


@pytest.mark.parametrize("arc_len", [9, 12])
@pytest.mark.parametrize("thr", [5.0, 30.0])
def test_fast_score_and_nms_are_exact(arc_len, thr):
    img = _random((60, 90), arc_len)
    want = np.asarray(jdet.fast_score_map(jnp.asarray(img), jnp.float32(thr), arc_len))
    got = tdet.fast_score_map(torch.from_numpy(img), torch.tensor(thr), arc_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 10
    np.testing.assert_array_equal(tdet.nms3(got).numpy(),
                                  np.asarray(jdet.nms3(jnp.asarray(want))))


@pytest.mark.parametrize("bin_size,capacity", [(12, 40), (16, 200), (24, 64)])
def test_keypoints_from_score_tie_order(bin_size, capacity):
    """Integer scores with many equal values, inside cells and across
    cells; capacity 200 exceeds the cell count (padding)."""
    score = np.random.default_rng(bin_size).integers(0, 4, (100, 130)).astype(np.float32)
    want = jdet.keypoints_from_score(jnp.asarray(score), bin_size, capacity, 6)
    got = tdet.keypoints_from_score(torch.from_numpy(score), bin_size, capacity, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("detector", ["FAST", "FAST12"])
@pytest.mark.parametrize("octaves", [1, 2])
@pytest.mark.parametrize("bin_size", [12, 16, 24])
def test_detect_keypoints_is_exact(detector, octaves, bin_size):
    img = _rendered()
    thr = 12.0 if detector == "FAST" else 8.0
    want = jdet.detect_keypoints(jnp.asarray(img), jnp.float32(thr), bin_size, 256, 20,
                                 detector, octaves=octaves)
    got = tdet.detect_keypoints(torch.from_numpy(img), torch.tensor(thr), bin_size, 256,
                                20, detector, octaves=octaves)
    for name in ("uv", "score", "valid", "octave"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(want.valid.sum()) > 60


def test_pyramid_helpers_match_jax():
    img = _random((75, 131), 3)
    np.testing.assert_array_equal(tdet.downsample2(torch.from_numpy(img)).numpy(),
                                  np.asarray(jdet.downsample2(jnp.asarray(img))))
    for cap, octs in ((1024, 1), (1024, 2), (1000, 3), (512, 4)):
        assert tdet.octave_capacities(cap, octs) == jdet.octave_capacities(cap, octs)


@pytest.mark.parametrize("detector", ["HARRIS", "GFTT", "DOG", "KAZE"])
def test_unported_detectors_raise(detector):
    with pytest.raises(NotImplementedError, match="item 14"):
        tdet.score_map(torch.zeros((32, 32)), torch.tensor(10.0), detector)
