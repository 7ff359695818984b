"""Port parity: detection over the image pyramid (frontend/detect.py)
against vslam_tpu.

FAST: no tolerance.  Scores are sums of f32 threshold excesses taken in
the same order; keypoints are compared as sets in order (uv, score,
valid, octave), so the per-cell argmax and the top-K tie order must match
lax.argmax / lax.top_k exactly.  uint8-valued images make ties common.

HARRIS, GFTT, DOG and KAZE, on a rendered 128 x 192 frame: XLA-CPU fuses
and contracts their blurs and products in its own order (no order written
in torch reproduces its conv_general_dilated), so
  * the score maps agree where JAX's is nonzero within atol 1e-4 (HARRIS,
    GFTT; measured 4.6e-5) or 1e-3 (DOG; measured 5.5e-4), and for KAZE
    within 1e-5 of the map's largest score: its response is a Hessian
    determinant scaled by sigma^4 * 4e4 after 30 explicit diffusion
    steps, so f32 rounding in the evolved image shows at every score as
    an absolute error (measured 1.9e-2 with scores up to 4,972, 3.9e-6
    of the largest; JAX's own jitted and eager KAZE differ by 9.3e-3);
  * their zero / nonzero support differs in at most 0.1% of pixels;
  * KAZE's contrast factor is within 1/64 of the gradient maximum (its
    histogram bin width), and the test reports whether it is exact;
  * detect_keypoints keeps at least 99% of JAX's valid keypoints at
    identical coordinates, at 1 and 2 octaves.
A 16-frame stereo tracker run with DOG gives JAX's event counts, every
position within 1e-4 m.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.frontend import detect as jdet
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.ops import camera as jcam
from vslam_tpu.tracking.tracker import FusedPoseTracker as JTracker
from vslam_tpu_torch.frontend import detect as tdet
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.tracking.tracker import FusedPoseTracker as TTracker

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


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("detector", ["FAST", "FAST12"])
@pytest.mark.parametrize("bin_size", [16, 24])
def test_batched_detection_matches_per_image_and_jax(batch, detector, bin_size):
    """detect_keypoints over a (B, H, W) stack (one fast_cells call a
    level: on the CPU its plain version) equals the per-image call and
    JAX's detector image by image, at 1-3 octaves and borders 0 / 3 / 20,
    on a ragged 100 x 213 shape (no dimension a multiple of the bins)."""
    imgs = np.stack([_random((100, 213), 10 * batch + b) for b in range(batch)])
    thr = 12.0 if detector == "FAST" else 8.0
    stack = torch.from_numpy(imgs)
    for octaves in (1, 2, 3):
        for border in (0, 3, 20):
            args = (bin_size, 200, border, detector)
            got = tdet.detect_keypoints(stack, torch.tensor(thr), *args, octaves=octaves)
            for b in range(batch):
                one = tdet.detect_keypoints(stack[b], torch.tensor(thr), *args, octaves=octaves)
                want = jdet.detect_keypoints(jnp.asarray(imgs[b]), jnp.float32(thr), *args,
                                             octaves=octaves)
                for name in ("uv", "score", "valid", "octave"):
                    g = getattr(got, name)[b].numpy()
                    np.testing.assert_array_equal(g, getattr(one, name).numpy(), err_msg=name)
                    np.testing.assert_array_equal(g, np.asarray(getattr(want, name)),
                                                  err_msg=f"{name} octaves {octaves} "
                                                          f"border {border}")
                assert int(want.valid.sum()) > 20


def test_pyramid_helpers_match_jax():
    img = _random((75, 131), 3)
    np.testing.assert_array_equal(tdet.downsample2(torch.from_numpy(img)).numpy(),
                                  np.asarray(jdet.downsample2(jnp.asarray(img))))
    for cap, octs in ((1024, 1), (1024, 2), (1000, 3), (512, 4)):
        assert tdet.octave_capacities(cap, octs) == jdet.octave_capacities(cap, octs)


@pytest.mark.parametrize("detector", ["HARRIS", "GFTT", "DOG", "KAZE"])
def test_unported_detectors_raise(detector):
    """Every detector is ported: the registry dispatches each name and its
    alias to its score map, and only an unknown name raises."""
    img = torch.from_numpy(_small(2))
    thr = torch.tensor(5.0)
    want = {"HARRIS": tdet.harris_score_map, "GFTT": tdet.gftt_score_map,
            "DOG": tdet.dog_score_map, "KAZE": tdet.kaze_score_map}[detector](img, thr)
    alias = {"GFTT": "shi_tomasi", "KAZE": "AKAZE"}.get(detector, detector.lower())
    assert (want > 0).any()
    np.testing.assert_array_equal(tdet.score_map(img, thr, alias).numpy(), want.numpy())
    with pytest.raises(ValueError, match="unknown detector"):
        tdet.score_map(img, thr, detector + "X")


SMALL_CAM = dict(fx=300.0, fy=300.0, cx=96.0, cy=64.0, baseline_m=0.4, rows=128, cols=192)
FLOAT_THRESHOLDS = {"HARRIS": 10.0, "GFTT": 5.0, "DOG": 5.0, "KAZE": 5.0}
# Score-map atol where JAX's map is nonzero (KAZE: a share of its largest
# score).
SCORE_TOL = {"HARRIS": 1e-4, "GFTT": 1e-4, "DOG": 1e-3, "KAZE": None}


def _small(frame):
    """A rendered 128 x 192 left image, uint8-valued."""
    world = jsyn.make_world(jcam.make_camera(**SMALL_CAM), n_frames=4, n_points=1500,
                            seed=42, step=0.45)
    return np.asarray(jsyn.render_frame(world, frame)[0]).astype(np.uint8).astype(np.float32)


@pytest.mark.parametrize("detector", ["HARRIS", "GFTT", "DOG", "KAZE"])
def test_float_score_maps_match_jax(detector):
    img = _small(2)
    thr = FLOAT_THRESHOLDS[detector]
    want = np.asarray(jax.jit(lambda x, t: jdet.score_map(x, t, detector))(
        jnp.asarray(img), jnp.float32(thr)))
    got = tdet.score_map(torch.from_numpy(img), torch.tensor(thr), detector).numpy()
    nz = want != 0
    assert nz.sum() > 50
    assert ((got != 0) != nz).mean() <= 1e-3
    atol = SCORE_TOL[detector] or 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got[nz], want[nz], atol=atol, rtol=0.0)


def test_kaze_contrast_factor_matches_jax():
    x = _small(1) * np.float32(1.0 / 255.0)
    want = float(jax.jit(jdet._kaze_contrast_k)(jnp.asarray(x)))
    got = float(tdet._kaze_contrast_k(torch.from_numpy(x)))
    gx, gy = jdet._grad_xy(jdet.gauss_blur(jnp.asarray(x), 1.0))
    mmax = float(jnp.sqrt(gx * gx + gy * gy).max())
    print(f"KAZE contrast factor: port {got!r}, JAX {want!r}, exact: {got == want}")
    assert abs(got - want) <= mmax / 64.0


@pytest.mark.parametrize("detector", ["HARRIS", "GFTT", "DOG", "KAZE"])
@pytest.mark.parametrize("octaves", [1, 2])
def test_float_detectors_keypoints_match_jax(detector, octaves):
    img = _small(2)
    thr = FLOAT_THRESHOLDS[detector]
    want = jdet.detect_keypoints(jnp.asarray(img), jnp.float32(thr), 12, 128, 16, detector,
                                 octaves=octaves)
    got = tdet.detect_keypoints(torch.from_numpy(img), torch.tensor(thr), 12, 128, 16,
                                detector, octaves=octaves)
    kj = set(map(tuple, np.asarray(want.uv)[np.asarray(want.valid)]))
    kt = set(map(tuple, got.uv.numpy()[got.valid.numpy()]))
    assert len(kj) > 30
    assert len(kj & kt) >= 0.99 * len(kj), (len(kj), len(kj & kt), len(kt))


def _tracker_config(cls):
    cfg = cls()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 12
    cfg.framepoint_generation.border_pixels = 16
    cfg.framepoint_generation.detector_type = "DOG"
    return cfg


def test_stereo_tracker_with_dog_matches_jax():
    """16 frames of the stereo FusedPoseTracker with the DOG detector (the
    JAX package's tests/test_detectors.py runs its tracker with it), on a
    denser world than the score tests': DOG finds ~40 keypoints a frame
    at this size."""
    cam_args = dict(SMALL_CAM, fx=200.0, fy=200.0)
    cam = tcam.make_camera(**cam_args, device="cpu")
    world = tsyn.make_world(cam, n_frames=16, n_points=3000, seed=5, step=0.2)
    jt = JTracker(jcam.make_camera(**cam_args), _tracker_config(JConfig),
                  landmark_capacity=4096)
    tt = TTracker(cam, _tracker_config(TConfig), landmark_capacity=4096, device="cpu")
    for t in range(16):
        left, right = tsyn.render_frame(world, t)[:2]
        jt.compute(left, right)
        tt.compute(left, right)
    jt.flush()
    tt.flush()
    for k in ("n_frames", "n_breaks", "n_recovered", "n_spawned", "n_keypoints",
              "n_framepoints", "n_tracked_points", "n_inliers"):
        assert getattr(tt.stats, k) == getattr(jt.stats, k), k
    assert tt.stats.n_breaks == 0 and tt.stats.n_inliers > 0
    Tj, Tt = np.stack(jt.trajectory), np.stack(tt.trajectory)
    assert np.abs(Tt[:, :3, 3] - Tj[:, :3, 3]).max() <= 1e-4
