"""Port parity: the staged stereo front-end (mapping/frame.py ::
stereo_frontend_core away from the fused K1 branch) and the K1 branch's
image-sized binning tail, against vslam_tpu on a rendered synthetic
stereo pair (192 x 512, uint8-valued).

JAX on the CPU takes its staged front-end (brief._use_pallas() is False
there), and so does the port for everything but BRIEF256 at one octave
with border >= 16: the KITTI-style pyramid (2 octaves), the EuRoC-style
rotated banks (BRIEF256R) and border 8 are compared with the JAX staged
path.  The K1 branch at bins 12 and 24 is compared with the JAX fused
branch, run through the Pallas interpreter with _use_pallas patched, as
tests/test_torch_frame.py does.

Tolerances: FrameState and the level-0 planes are compared exactly
(p_cam to rtol=1e-6), except where BRIEF256R's orientation bins differ:
torch's and XLA's arctan2 may differ by an ulp, which flips a bin when
theta * 16 / (2 pi) lands that close to a half-integer
(tests/test_torch_brief.py bounds the share of such pixels).  The
BRIEF256R run asserts that bins agree on >= 99.9% of pixels and at every
keypoint, and then holds the frame to exact equality.

The detector and descriptor variants (HARRIS, GFTT, DOG and KAZE; ORB256
at one and two octaves): keypoints and the integer fields exact, p_cam to
rtol 1e-6, and the descriptor bits that differ counted and at most 0.1%
(ORB256 compares bilinear samples, and a pair within rounding of a tie
may flip; measured 0).  The float detectors' keypoints need not be
exact in general (tests/test_torch_detect.py); on this pair they are.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.frontend import brief as jbrief
from vslam_tpu.frontend import pallas_frontend as jpf
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.mapping import frame as jframe
from vslam_tpu.ops import camera as jcam
from vslam_tpu_torch.frontend import brief as tbrief
from vslam_tpu_torch.frontend import detect as tdet
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.mapping import frame as tframe

# Under pytest-xdist each core runs a worker process; torch's own intra-op
# threads on top of that oversubscribe the CPU and slow these tests ~30x.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAM_ARGS = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                rows=192, cols=512)
CAPACITY = 256
STEREO = (60, 1.5, 1.0, 200.0)  # max Hamming, epipolar tol, min/max disparity


@pytest.fixture(scope="module")
def scene():
    jc = jcam.make_camera(**CAM_ARGS)
    tc = from_jax.camera_from_numpy(np.asarray(jc.K), np.asarray(jc.baseline_m),
                                    jc.rows, jc.cols)
    world = jsyn.make_world(jc, n_frames=8, n_points=1500, seed=42, step=0.45)
    pair = np.stack(jsyn.render_frame(world, 5)[:2]).astype(np.uint8).astype(np.float32)
    return jc, tc, pair


def _jax_frontend(jc, pair, thr, **kw):
    mh, et, mind, maxd = STEREO

    @jax.jit
    def run(il, ir, t):
        return jframe.stereo_frontend_core(
            jc, il, ir, t, jnp.int32(mh), jnp.float32(et), jnp.float32(mind),
            jnp.float32(maxd), capacity=CAPACITY, want_planes=True, **kw)

    out = run(jnp.asarray(pair[0]), jnp.asarray(pair[1]), jnp.float32(thr))
    return {k: np.asarray(v) for k, v in out[0]._asdict().items()}, out[1:]


def _torch_frontend(tc, pair, thr, **kw):
    p = torch.from_numpy(pair)
    out = tframe.stereo_frontend_core(tc, p[0], p[1], torch.tensor(thr), *STEREO,
                                      capacity=CAPACITY, want_planes=True, **kw)
    return out[0], out[1:]


def _assert_same_frame(tf, jf, tn, jn):
    assert int(tn[0]) == int(jn[0]) and int(tn[1]) == int(jn[1])
    assert int(tn[1]) > 50  # a real frame, not an empty one
    for name in ("uv4", "valid", "reliable", "track_len", "landmark_slot"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), jf[name], err_msg=name)
    np.testing.assert_array_equal(tf.desc.numpy(), jf["desc"].view(np.int32))
    np.testing.assert_allclose(tf.p_cam.numpy(), jf["p_cam"], rtol=1e-6)
    np.testing.assert_array_equal(tn[2].numpy(), np.asarray(jn[2]).view(np.int32))


@pytest.mark.parametrize("name,kw", [
    ("harris", dict(detector="HARRIS")),
    ("gftt_orb256", dict(detector="GFTT", descriptor="ORB256")),
    ("orb256", dict(descriptor="ORB256")),
    ("orb256_pyramid", dict(descriptor="ORB256", octaves=2)),
    ("dog_pyramid", dict(detector="DOG", octaves=2)),
    ("kaze", dict(detector="KAZE")),
])
def test_front_end_variants_match_jax(scene, name, kw):
    jc, tc, pair = scene
    kw = dict(dict(bin_size=16, border=20), **kw)
    jf, jn = _jax_frontend(jc, pair, 15.0, **kw)
    tf, tn = _torch_frontend(tc, pair, 15.0, **kw)
    assert int(tn[0]) == int(jn[0]) and int(tn[1]) == int(jn[1])
    assert int(tn[1]) > 50
    for field in ("uv4", "valid", "reliable", "track_len", "landmark_slot"):
        np.testing.assert_array_equal(getattr(tf, field).numpy(), jf[field], err_msg=field)
    np.testing.assert_allclose(tf.p_cam.numpy(), jf["p_cam"], rtol=1e-6)
    n_diff = int(np.unpackbits((tf.desc.numpy() ^ jf["desc"].view(np.int32))
                               .view(np.uint8)).sum())
    print(f"{name}: {n_diff} descriptor bits of {jf['desc'].size * 32} differ")
    assert n_diff <= 1e-3 * jf["desc"].size * 32
    if kw.get("descriptor") == "ORB256":
        assert tn[2] is None and jn[2] is None  # recovery describes the images
    else:
        np.testing.assert_array_equal(tn[2].numpy(), np.asarray(jn[2]).view(np.int32))


@pytest.mark.parametrize("name,kw", [
    ("kitti_pyramid", dict(octaves=2, bin_size=16, border=20)),
    ("border_8", dict(octaves=1, bin_size=16, border=8)),
    ("border_8_pyramid_bin_12", dict(octaves=2, bin_size=12, border=8)),
])
def test_staged_frontend_matches_jax(scene, name, kw):
    jc, tc, pair = scene
    jf, jn = _jax_frontend(jc, pair, 15.0, **kw)
    tf, tn = _torch_frontend(tc, pair, 15.0, **kw)
    _assert_same_frame(tf, jf, tn, jn)


def test_staged_frontend_rotated_banks_match_jax(scene, monkeypatch):
    """EuRoC-style: BRIEF256R over a 2-octave pyramid; the recovery planes
    are the upright level-0 planes."""
    monkeypatch.setattr(jbrief, "_ROT_FILTERS_CACHE", {})
    jc, tc, pair = scene
    kw = dict(octaves=2, bin_size=16, border=20, descriptor="BRIEF256R")
    jf, jn = _jax_frontend(jc, pair, 15.0, **kw)
    tf, tn = _torch_frontend(tc, pair, 15.0, **kw)
    # The bins agree on >= 99.9% of pixels and at every keypoint of this
    # scene (in fact everywhere), so the frame must be exact.
    for img in pair:
        t_img = torch.from_numpy(img)
        kp = tdet.detect_keypoints(t_img, torch.tensor(15.0), 16, CAPACITY, 20, octaves=2)
        bins_t = tbrief.orientation_bin_map(tbrief.box_blur(t_img, 2)).numpy()
        bins_j = np.asarray(jax.jit(lambda x: jbrief.orientation_bin_map(
            jbrief.box_blur(x, 2)))(jnp.asarray(img)))
        same = bins_t == bins_j
        assert same.mean() >= 0.999, same.mean()
        r, c = np.round(kp.uv.numpy()[:, ::-1]).astype(int).T
        assert same[r, c].all()
    _assert_same_frame(tf, jf, tn, jn)


@pytest.mark.parametrize("bin_size", [12, 24])
def test_k1_branch_binning_tail_matches_jax(scene, monkeypatch, bin_size):
    """BRIEF256 at one octave runs K1; a bin size other than 16 takes the
    image-sized tail keypoints_from_score over K1's score map."""
    monkeypatch.setattr(jbrief, "_use_pallas", lambda: True)
    monkeypatch.setattr(jpf, "fast_brief_frontend_pair",
                        partial(jpf.fast_brief_frontend_pair, interpret=True))
    jc, tc, pair = scene
    kw = dict(bin_size=bin_size, border=20)
    jf, jn = _jax_frontend(jc, pair, 15.0, **kw)
    tf, tn = _torch_frontend(tc, pair, 15.0, **kw)
    _assert_same_frame(tf, jf, tn, jn)
