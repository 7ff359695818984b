"""Port parity for landmark merging and the pose graph's landmark-side
back-propagation: the union-find remap, the batched absorb
(_apply_merges), merge_landmarks, the device free stack
(push_free_slots) and apply_kf_corrections, against the JAX package on
the same seeded inputs.

Tolerances: remaps, integer and boolean fields exact; xyz and H_acc
atol 1e-5 (f32 sums in another order); against the JAX package's Python
union-find fallback, whose remap lists the same merges in another order,
rtol 1e-6 on top (measured 1.9e-7: one ulp).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.mapping import landmarks as jlm
from vslam_tpu.mapping import merging as jmerging
from vslam_tpu.ops import lie as jlie
from vslam_tpu.tracking import fused as jfused
from vslam_tpu.utils import native
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.mapping import landmarks as tlm
from vslam_tpu_torch.mapping import merging as tmerging
from vslam_tpu_torch.tracking import fused as tfused

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAP = 256
INT_FIELDS = ("desc", "n_updates", "last_seen", "valid", "origin_kf", "protected")


def _pairs(seed=0):
    """Random merge pairs with chains, repeats, self-pairs and -1 rows."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, 80, (120, 2)).astype(np.int32)
    pairs[::17] = -1
    pairs[5::23, 1] = pairs[5::23, 0]
    return pairs


@pytest.mark.parametrize("library", ["native", "fallback"])
def test_union_find_remap_matches_jax(library, monkeypatch):
    if library == "fallback":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif not native.available():
        pytest.skip("native library not built")  # as tests/test_native.py
    for seed in range(3):
        pairs = _pairs(seed)
        want = native.union_find(pairs)
        got = tmerging.union_find(pairs)
        assert got == want
        if library == "native":  # same iteration order too
            assert list(got.items()) == list(want.items())


def _table(seed=1):
    """A JAX landmark table with random valid rows, weights and flags."""
    rng = np.random.default_rng(seed)
    t = jlm.empty_table(CAP)
    n_upd = rng.integers(0, 9, CAP).astype(np.int32)
    H = rng.standard_normal((CAP, 3, 3)).astype(np.float32)
    return t._replace(
        xyz_w=jnp.asarray(rng.uniform(-20, 20, (CAP, 3)).astype(np.float32)),
        H_acc=jnp.asarray(H @ H.transpose(0, 2, 1)),
        desc=jnp.asarray(rng.integers(0, 2**32, (CAP, 8), dtype=np.uint32)),
        n_updates=jnp.asarray(n_upd),
        last_seen=jnp.asarray(rng.integers(-1, 300, CAP).astype(np.int32)),
        valid=jnp.asarray(rng.random(CAP) < 0.9),
        origin_kf=jnp.asarray(rng.integers(0, 12, CAP).astype(np.int32)),
        protected=jnp.asarray(rng.random(CAP) < 0.5),
    )


def _np(table):
    return {k: np.asarray(v) for k, v in table._asdict().items()}


def _assert_tables_match(got, want, rtol=0.0):
    got = from_jax.landmark_table_to_numpy(got)
    want = _np(want)
    for k in INT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["xyz_w"], want["xyz_w"], rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(got["H_acc"], want["H_acc"], rtol=rtol, atol=1e-5)


def test_apply_merges_matches_jax():
    jt = _table()
    valid = np.asarray(jt.valid)
    live = np.flatnonzero(valid)
    stale = int(np.flatnonzero(~valid)[0])
    # Two sources into one destination, a chain-free set of other pairs,
    # a pair whose source is stale (recycled) and padded rows.
    src = np.array([live[10], live[11], live[20], stale, live[30], 0, 0], np.int32)
    dst = np.array([live[1], live[1], live[2], live[3], live[4], 0, 0], np.int32)
    use = np.array([1, 1, 1, 1, 1, 0, 0], bool)
    want = jmerging._apply_merges(jt, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(use))
    got = tmerging._apply_merges(from_jax.landmark_table_from_numpy(_np(jt)),
                                 torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(use))
    _assert_tables_match(got, want)
    assert not from_jax.landmark_table_to_numpy(got)["valid"][live[10]]
    assert from_jax.landmark_table_to_numpy(got)["n_updates"][live[1]] == (
        np.asarray(jt.n_updates)[[live[1], live[10], live[11]]].sum())


class _Allocator:
    def __init__(self):
        self.released = []

    def release(self, slots):
        self.released.extend(int(s) for s in slots)


@pytest.mark.parametrize("library", ["native", "fallback"])
def test_merge_landmarks_matches_jax(library, monkeypatch):
    """The JAX package releases the absorbed slots in its union-find's
    remap order: ascending with the native library, insertion order with
    its Python fallback (used where the library is not built).  The port
    always releases them ascending, as the native library does."""
    if library == "fallback":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif not native.available():
        pytest.skip("native library not built")  # as tests/test_native.py
    jt = _table(seed=2)
    corr = _pairs(seed=4)
    jalloc = jlm.SlotAllocator(CAP)
    want, want_remap = jmerging.merge_landmarks(jt, jalloc, corr)
    talloc = _Allocator()
    got, got_remap = tmerging.merge_landmarks(
        from_jax.landmark_table_from_numpy(_np(jt)), talloc, corr)
    assert got_remap == want_remap and len(got_remap) > 10
    if library == "native":
        assert talloc.released == jalloc._free
    else:
        assert talloc.released == sorted(jalloc._free)
        assert talloc.released != jalloc._free  # the orders differ here
    # The fallback's remap order is another order of the same f32 sums.
    _assert_tables_match(got, want, rtol=1e-6 if library == "fallback" else 0.0)


def test_push_free_slots_matches_jax():
    rng = np.random.default_rng(5)
    F = 64
    free_list = rng.integers(0, 1000, F).astype(np.int32)
    for fc, n in ((0, 20), (50, 30), (64, 4)):
        slots = rng.integers(0, 1000, n).astype(np.int32)
        slots[::3] = -1
        jl, jc = jfused.push_free_slots(jnp.asarray(free_list), jnp.int32(fc),
                                        jnp.asarray(slots))
        tl, tc = tfused.push_free_slots(torch.from_numpy(free_list),
                                        torch.tensor(fc, dtype=torch.int32),
                                        torch.from_numpy(slots))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert int(tc) == int(jc)


def test_apply_kf_corrections_matches_jax():
    jt = _table(seed=3)
    rng = np.random.default_rng(6)
    n_kf = 9  # origin_kf reaches 11: clipped onto the last correction
    xi = (rng.standard_normal((n_kf, 6)) * 0.1).astype(np.float32)
    C = np.array(jlie.exp_se3(jnp.asarray(xi)))
    C_pad = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    C_pad[:n_kf] = C
    want = jlm.apply_kf_corrections(jt, jnp.asarray(C_pad), jnp.int32(n_kf))
    got = tlm.apply_kf_corrections(from_jax.landmark_table_from_numpy(_np(jt)),
                                   torch.from_numpy(C))
    _assert_tables_match(got, want)
