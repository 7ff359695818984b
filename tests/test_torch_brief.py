"""Port parity: the dense BRIEF planes (kernels K2/K3/K4's plain version),
the box blur, the orientation bins and the rotated-bank descriptors,
against vslam_tpu.

The JAX side runs both of its formulations on the CPU: the conv path
(brief.dense_bit_planes, brief._dense_bit_planes_bank — what JAX on the
CPU runs) and the three Pallas kernels through the Pallas interpreter,
as tests/test_pallas_brief.py does.  Tolerance: none — planes, blurs and
descriptors are compared for equality over the whole image, borders
included — except for the orientation bins (see that test).

Image widths are multiples of 16.  XLA on the CPU contracts the box
blur's column pass into a fused multiply-add chain, which the port
computes explicitly; at some other widths (150, for one) XLA's vector
loop leaves a few right-edge columns uncontracted, which no formula of
the blur alone reproduces.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.frontend import brief as jbrief
from vslam_tpu.frontend import orb as jorb
from vslam_tpu.frontend import pallas_brief as jpb
from vslam_tpu_torch.frontend import brief as tbrief
from vslam_tpu_torch.frontend import dense_brief as db
from vslam_tpu_torch.frontend import orb as torb

# Under pytest-xdist each core runs a worker process; torch's own intra-op
# threads on top of that oversubscribe the CPU and slow these tests ~30x.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SHAPES = [(24, 144), (40, 160)]


def _img(shape, uint8_valued, seed=0):
    img = np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)
    return np.round(img) if uint8_valued else img


def _u32(a):
    return np.asarray(a).view(np.int32)


def test_pattern_tables_are_the_reference_tables():
    np.testing.assert_array_equal(tbrief._PAT, np.asarray(jbrief._PAT))
    np.testing.assert_array_equal(tbrief._ROT_PATS, jbrief._ROT_PATS)
    assert tbrief.N_ROT_BANKS == jbrief.N_ROT_BANKS
    assert db.TABLES.shape == (17, 256, 2, 2)
    assert np.abs(db.TABLES).max() <= torb.PATTERN_RADIUS
    np.testing.assert_array_equal(torb._make_pattern(), jorb._make_pattern())


@pytest.mark.parametrize("radius", [2, 7])
@pytest.mark.parametrize("uint8_valued", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(33, 512)])
def test_box_blur_is_bit_exact(radius, uint8_valued, shape):
    img = _img(shape, uint8_valued, seed=radius)
    want = np.asarray(jax.jit(jorb.box_blur, static_argnums=1)(jnp.asarray(img), radius))
    got = torb.box_blur(torch.from_numpy(img), radius).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [2, 3, 7])
@pytest.mark.parametrize("batch", [1, 2, 4])
def test_batched_box_blur_equals_each_image_and_jax(radius, batch):
    """One call over a (B, H, W) stack (one kernel launch on the card)
    gives every image's own blur and JAX's jitted blur, bit for bit."""
    H, W = 24 + 8 * batch, 16 * (6 + batch)
    imgs = np.stack([_img((H, W), b % 2 == 0, seed=10 * radius + b) for b in range(batch)])
    got = torb.box_blur(torch.from_numpy(imgs), radius).numpy()
    assert got.shape == imgs.shape and got.dtype == np.float32
    blur = jax.jit(jorb.box_blur, static_argnums=1)
    for b in range(batch):
        one = torb.box_blur(torch.from_numpy(imgs[b]), radius).numpy()
        np.testing.assert_array_equal(got[b], one)
        np.testing.assert_array_equal(got[b], np.asarray(blur(jnp.asarray(imgs[b]), radius)))


@pytest.mark.parametrize("shape", [(480, 752), (37, 53)])
def test_orientation_bins_blur_both_gradients_in_one_call(monkeypatch, shape):
    """orientation_bin_map blurs stack([gy, gx]) in one call; its bins
    equal those of the gradients blurred one at a time, bit for bit, at
    EuRoC's 480 x 752 and at an odd shape.  At 480 x 752 (a multiple of
    16 wide) the blurred gradients also equal JAX's bit for bit, and the
    bins JAX's (within the arctan2 tolerance of the test below; they
    agreed on every pixel when this was written)."""
    img = _textured(shape, 20)
    smooth = torb.box_blur(torch.from_numpy(img), 2)
    calls = []

    def counted(x, radius=2):
        calls.append((tuple(x.shape), radius))
        return torb.box_blur(x, radius)

    monkeypatch.setattr(tbrief, "box_blur", counted)
    got = tbrief.orientation_bin_map(smooth)
    assert calls == [((2,) + shape, 7)]
    gx = 0.5 * (torch.roll(smooth, -1, 1) - torch.roll(smooth, 1, 1))
    gy = 0.5 * (torch.roll(smooth, -1, 0) - torch.roll(smooth, 1, 0))
    theta = torch.atan2(torb.box_blur(gy, 7), torb.box_blur(gx, 7))
    want = torch.remainder(torch.round(theta * (16 / (2.0 * np.pi))).to(torch.int32), 16)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if shape[1] % 16 == 0:
        blur = jax.jit(jorb.box_blur, static_argnums=1)
        both = torb.box_blur(torch.stack([gy, gx]), 7).numpy()
        for g, b in zip((gy, gx), both):
            np.testing.assert_array_equal(b, np.asarray(blur(jnp.asarray(g.numpy()), 7)))
        want_j = np.asarray(jax.jit(jbrief.orientation_bin_map)(jnp.asarray(smooth.numpy())))
        assert np.mean(got.numpy() == want_j) >= 0.999


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_dense_planes_batch_blurs_the_stack_in_one_call(monkeypatch, batch):
    """dense_planes_batch blurs its stack in one call and gives the
    planes of the images blurred one at a time (and dense_planes')."""
    imgs = torch.from_numpy(np.stack([_img((40, 160), True, seed=30 + b)
                                      for b in range(batch)]))
    calls = []

    def counted(x, radius=2):
        calls.append((tuple(x.shape), radius))
        return torb.box_blur(x, radius)

    monkeypatch.setattr(tbrief, "box_blur", counted)
    got = tbrief.dense_planes_batch(imgs)
    assert calls == [((batch, 40, 160), 2)]
    want = db.dense_bit_planes_batch(torch.stack([torb.box_blur(im, 2) for im in imgs]))
    assert got.shape == (batch, 8, 40, 160) and torch.equal(got, want)
    for b in range(batch):
        assert torch.equal(got[b], tbrief.dense_planes(imgs[b]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("uint8_valued", [True, False])
def test_plain_planes_match_the_conv_formulation(monkeypatch, shape, uint8_valued):
    """brief.dense_bit_planes blurs and describes by four difference
    convolutions, bit = [conv > 0]; the port blurs and compares."""
    # The JAX package caches its bank filters; a fresh cache per test
    # keeps a filter traced inside another test's jit out of this one.
    monkeypatch.setattr(jbrief, "_ROT_FILTERS_CACHE", {})
    img = _img(shape, uint8_valued, seed=3)
    want = _u32(jbrief.dense_bit_planes(jnp.asarray(img)))
    got = tbrief.dense_planes(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    smooth = np.array(jorb.box_blur(jnp.asarray(img), 2))
    for bank in (0, 5, 11):
        want = _u32(jbrief._dense_bit_planes_bank(jnp.asarray(smooth), bank))
        got = tbrief._dense_bit_planes_bank(torch.from_numpy(smooth), bank).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"bank {bank}")


def _smooth_stack(shape, seed):
    """A blurred uint8-valued image (ties in S are common) and a
    continuous one."""
    a = torb.box_blur(torch.from_numpy(_img(shape, True, seed)), 2).numpy()
    b = _img(shape, False, seed + 1)
    return np.stack([a, b])


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_planes_match_pallas_k2_k3(shape):
    sm = _smooth_stack(shape, 4)
    want = _u32(jpb.dense_bit_planes_pallas_batch(jnp.asarray(sm), interpret=True))
    np.testing.assert_array_equal(db.dense_bit_planes_batch(torch.from_numpy(sm)).numpy(),
                                  want)
    want = _u32(jpb.dense_bit_planes_pallas(jnp.asarray(sm[0]), interpret=True))
    np.testing.assert_array_equal(db.dense_bit_planes(torch.from_numpy(sm[0])).numpy(),
                                  want)


@pytest.mark.parametrize("bank", [0, 5, 11])
def test_plain_planes_match_pallas_k4(bank):
    sm = _smooth_stack(SHAPES[0], 5 + bank)
    for img in sm:
        want = _u32(jpb.dense_bit_planes_pallas_pattern(jnp.asarray(img), bank,
                                                        interpret=True))
        got = db.dense_bit_planes_pattern(torch.from_numpy(img), bank).numpy()
        np.testing.assert_array_equal(got, want)


def test_pair_and_keypoint_description_match_jax():
    imgs = np.stack([_img((40, 160), True, 8), _img((40, 160), True, 9)])
    want = _u32(jbrief.dense_planes_pair(jnp.asarray(imgs[0]), jnp.asarray(imgs[1])))
    t = torch.from_numpy(imgs)
    np.testing.assert_array_equal(tbrief.dense_planes_pair(t[0], t[1]).numpy(), want)
    uv = np.random.default_rng(1).uniform(-4, 170, (64, 2)).astype(np.float32)
    want = _u32(jbrief.describe_dense(jnp.asarray(imgs[0]), jnp.asarray(uv)))
    got = tbrief.describe_dense(t[0], torch.from_numpy(uv)).numpy()
    np.testing.assert_array_equal(got, want)


def _textured(shape, seed):
    """A smooth random texture (blurred noise, uint8-valued): orientation
    is well defined almost everywhere."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (shape[0] // 4 + 1, shape[1] // 4 + 1))
    big = np.kron(small, np.ones((4, 4)))[:shape[0], :shape[1]]
    return np.round(np.array(jorb.box_blur(jnp.asarray(big.astype(np.float32)), 3)))


def test_orientation_bins_and_rotated_descriptors_match_jax(monkeypatch):
    """Tolerance: arctan2 in torch and in XLA may differ by an ulp, and a
    bin flips when theta * 16 / (2 pi) lands within an ulp of a
    half-integer.  So bins must agree on >= 99.9% of pixels, and the
    rotated descriptors bit for bit at every keypoint whose bin agrees."""
    for seed, shape in ((0, (48, 160)), (1, (64, 192))):
        monkeypatch.setattr(jbrief, "_ROT_FILTERS_CACHE", {})  # one per jit trace
        img = _textured(shape, seed)
        smooth = np.array(jorb.box_blur(jnp.asarray(img), 2))
        want = np.asarray(jax.jit(jbrief.orientation_bin_map)(jnp.asarray(smooth)))
        got = tbrief.orientation_bin_map(torch.from_numpy(smooth)).numpy()
        assert got.dtype == np.int32 and got.min() >= 0 and got.max() < 16
        assert len(np.unique(want)) == 16  # every bank is in use
        assert np.mean(got == want) >= 0.999, np.mean(got == want)

        uv = np.random.default_rng(seed).uniform(0, shape[1], (300, 2)).astype(np.float32)
        uv[:, 1] *= shape[0] / shape[1]
        want_d = _u32(jax.jit(jbrief.describe_dense_rotated)(jnp.asarray(img),
                                                              jnp.asarray(uv)))
        got_d = tbrief.describe_dense_rotated(torch.from_numpy(img),
                                              torch.from_numpy(uv)).numpy()
        r = np.clip(np.round(uv[:, 1]).astype(int), 0, shape[0] - 1)
        c = np.clip(np.round(uv[:, 0]).astype(int), 0, shape[1] - 1)
        same_bin = got[r, c] == want[r, c]
        assert same_bin.mean() >= 0.99
        np.testing.assert_array_equal(got_d[same_bin], want_d[same_bin])


def test_cpu_wrappers_run_the_plain_version_and_count_no_launch():
    before = [e.launches for e in (db.K2, db.K3, db.K4)]
    sm = torch.zeros((2, 20, 30))
    assert db.dense_bit_planes_batch(sm).shape == (2, 8, 20, 30)
    assert db.dense_bit_planes(sm[0]).dtype == torch.int32
    assert db.dense_bit_planes_pattern(sm[0], 15).shape == (8, 20, 30)
    assert [e.launches for e in (db.K2, db.K3, db.K4)] == before
    with pytest.raises(ValueError):
        db.dense_bit_planes_pattern(sm[0], 16)

