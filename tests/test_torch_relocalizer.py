"""Port parity for the relocalizer (loop/relocalizer.py) against the JAX
package on the same seeded numpy inputs, and tests of the three reference
faults the port repairs.

Tolerances: the database query (best row, ok) and the database after the
insert are bit-exact; votes, correspondences, remaps and the grown
database exact; ICP poses atol 1e-4 with num_inliers and converged exact
(the inputs keep every residual far from the kernel boundary, so f32
summation order cannot flip an inlier); closures: ids and correspondences
exact, T_ref_query atol 1e-4.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.io.config import RelocalizationParameters as JParams
from vslam_tpu.loop import relocalizer as jrel
from vslam_tpu.mapping.local_maps import LocalMap as JLocalMap
from vslam_tpu.ops import lie as jlie
from vslam_tpu.solve import aligners as jal
from vslam_tpu.solve import gn as jgn
from vslam_tpu_torch.io import config as tconfig
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.io.config import RelocalizationParameters as TParams
from vslam_tpu_torch.loop import relocalizer as trel
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.solve import aligners as tal
from vslam_tpu_torch.solve import gn as tgn
from vslam_tpu_torch.system.engine import SlamEngine
from vslam_tpu_torch.tracking import fused as tfused

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

POSE_ATOL = 1e-4


def _params(cls, **kw):
    p = cls()
    p.preliminary_minimum_interspace_queries = 6
    p.minimum_number_of_matches_per_landmark = 10
    p.icp_minimum_number_of_inliers = 10
    p.icp_minimum_inlier_ratio = 0.3
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _exp(xi):
    return np.asarray(jlie.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


# ---------------------------------------------------------------------------
# The database query + insert program
# ---------------------------------------------------------------------------


def test_query_and_insert_many_is_bit_exact():
    """S = 3 queries (+1 padded) of 64 rows against a 700-row database in
    a 1024-row prefix: exact copies, near copies, rows whose best match is
    tied by a duplicate database row (margin 0: rejected), rows whose only
    match lies past the interspace bound, and random rows."""
    rng = np.random.default_rng(0)
    cap, n_rows, CAP, SB = 2048, 700, 64, 4
    db = rng.integers(0, 2**32, (cap, 8), dtype=np.uint32)
    db[n_rows:] = 0
    mid = np.full(cap, -1, np.int32)
    mid[:n_rows] = np.sort(rng.integers(0, 30, n_rows))
    db[101] = db[100]  # a duplicated row: its copies tie
    maxm = np.array([12, 25, 20, -1], np.int32)
    q = rng.integers(0, 2**32, (SB, CAP, 8), dtype=np.uint32)
    q[3] = 0
    for s in range(3):
        eligible = np.setdiff1d(np.flatnonzero((mid >= 0) & (mid <= maxm[s])), [100, 101])
        late = np.flatnonzero(mid > maxm[s])
        q[s, :16] = db[rng.choice(eligible, 16)]  # exact copies
        q[s, 16:32] = db[rng.choice(eligible, 16)]
        flips = rng.integers(0, 256, (16, 5))
        for r in range(16):
            for b in flips[r]:
                q[s, 16 + r, b // 32] ^= np.uint32(1 << (b % 32))  # near copies
        q[s, 32] = db[100]  # tied best (rows 100 and 101)
        q[s, 33:37] = db[late[:4]]  # ineligible only
    fresh = rng.random(SB * CAP) < 0.4
    fresh[3 * CAP:] = False
    dest = np.full(SB * CAP, -1, np.int32)
    sel = np.flatnonzero(fresh)
    dest[sel] = n_rows + np.arange(len(sel))
    row_mid = np.where(fresh, np.repeat(np.array([40, 41, 42, 0]), CAP), 0).astype(np.int32)

    jb, jok, jdb, jmid = jrel._query_and_insert_many(
        jnp.asarray(q), jnp.asarray(dest), jnp.asarray(row_mid), jnp.asarray(db),
        jnp.asarray(mid), jnp.asarray(maxm), jnp.int32(45), jnp.int32(8), 1024)
    tb, tok, tdb, tmid = trel._query_and_insert_many(
        _i32(q), torch.from_numpy(dest), torch.from_numpy(row_mid), _i32(db),
        torch.from_numpy(mid), torch.from_numpy(maxm), 45, 8, 1024)

    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tdb.numpy(), np.asarray(jdb).view(np.int32))
    np.testing.assert_array_equal(tmid.numpy(), np.asarray(jmid))
    ok = tok.numpy()
    assert ok[:3, :32].all()  # copies and near copies match
    assert not ok[:3, 32].any()  # a tied runner-up gives margin 0
    assert not ok[:3, 33:37].any() and not ok[3].any()
    assert tdb.numpy()[n_rows:n_rows + len(sel)].tolist() == q.reshape(-1, 8)[sel].view(
        np.int32).tolist()


# ---------------------------------------------------------------------------
# A synthetic two-lap sequence of local maps
# ---------------------------------------------------------------------------

N_PLACES, PER_PLACE, OVERLAP = 8, 90, 20


def _pose(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:3, 3] = t
    return T


def _scenario(seed=0):
    """Two laps over N_PLACES places.  Lap 0 spawns one slot per point;
    lap 1 sees the same points as new slots (3 flipped descriptor bits),
    from keyframes displaced by 0.8 m / 8 deg, with drift-carrying pose
    estimates.  Consecutive maps of a lap share OVERLAP points.
    Returns a list of LocalMap field dicts (host descriptors, uint32)."""
    rng = np.random.default_rng(seed)
    R = 20.0
    centers = [np.array([R * np.sin(a), 0.0, R * (1 - np.cos(a))])
               for a in 2 * np.pi * np.arange(N_PLACES) / N_PLACES]
    pts = np.concatenate([c + rng.uniform(-4, 4, (PER_PLACE, 3)) for c in centers])
    desc = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    maps = []
    for k in range(2 * N_PLACES):
        lap, p = divmod(k, N_PLACES)
        yaw = 2 * np.pi * p / N_PLACES
        ids = np.arange(p * PER_PLACE, (p + 1) * PER_PLACE)
        if p + 1 < N_PLACES:
            ids = np.concatenate([ids, (p + 1) * PER_PLACE + np.arange(OVERLAP)])
        T_true = _pose(yaw + lap * np.deg2rad(8.0), centers[p] + lap * np.array([0.8, 0.1, -0.3]))
        T_est = T_true
        if lap:
            s = (p + 1) / N_PLACES
            T_est = _exp([0.3 * s, -0.1 * s, 0.2 * s, 0.0, 0.05 * s, 0.0]) @ T_true
        d = desc[ids].copy()
        if lap:
            for r in range(len(ids)):
                for b in rng.integers(0, 256, 3):
                    d[r, b // 32] ^= np.uint32(1 << (b % 32))
        xyz = (pts[ids] - T_true[:3, 3]) @ T_true[:3, :3] + rng.normal(0, 0.005, (len(ids), 3))
        maps.append(dict(map_id=k, keyframe_index=3 * k, T_world_kf=T_est.astype(np.float32),
                         landmark_slots=(ids + lap * len(pts)).astype(np.int32),
                         xyz_kf=xyz.astype(np.float32), desc=d, uv4=None))
    return maps


def _jmap(d):
    return JLocalMap(**{k: d[k] for k in ("map_id", "keyframe_index", "T_world_kf",
                                          "landmark_slots", "xyz_kf", "desc")})


def _run_both(maps, batch=3, **kw):
    """Feed the same maps to both relocalizers in batches (submit_batch),
    resolving each batch's handles before the next; returns the two
    closure lists."""
    jr = jrel.Relocalizer(_params(JParams, **kw), capacity=4096)
    tr = trel.Relocalizer(_params(TParams, **kw), query_cap=1024, capacity=4096,
                            device="cpu")
    out = ([], [])
    for i in range(0, len(maps), batch):
        group = maps[i:i + batch]
        for r, lms, res in ((jr, [_jmap(d) for d in group], out[0]),
                            (tr, [from_jax.local_map_from_numpy(d) for d in group], out[1])):
            for h in r.submit_batch(lms):
                c = r.resolve(h)
                if c is not None:
                    res.append(c)
    return jr, tr, out


def test_whole_relocalizer_gives_the_same_closures():
    jr, tr, (jc, tc) = _run_both(_scenario())
    assert len(jc) >= 6  # most revisits close
    assert [(c.query_id, c.reference_id) for c in tc] == [
        (c.query_id, c.reference_id) for c in jc]
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.T_ref_query, np.asarray(b.T_ref_query), atol=POSE_ATOL)
        np.testing.assert_array_equal(a.correspondences, b.correspondences)
        assert a.n_correspondences == b.n_correspondences
        assert a.inlier_ratio == b.inlier_ratio
    assert tr.n_rows == jr.n_rows
    np.testing.assert_array_equal(tr.db_desc.numpy(), np.asarray(jr.db_desc).view(np.int32))
    np.testing.assert_array_equal(tr.db_map_id.numpy(), np.asarray(jr.db_map_id))
    np.testing.assert_array_equal(tr.row_slot, jr.row_slot)


def _loaded(maps, upto, **kw):
    """A JAX relocalizer holding maps[:upto], its query handle for
    maps[upto], and the port relocalizer carried over from it."""
    jr = jrel.Relocalizer(_params(JParams, **kw), capacity=4096)
    for d in maps[:upto]:
        jr.add_local_map(_jmap(d))
    h = jr.submit(_jmap(maps[upto]))
    h.idx_dev, h.ok_dev = np.asarray(h.idx_dev), np.asarray(h.ok_dev)
    tmaps = {m.map_id: from_jax.local_map_from_numpy(
        {k: getattr(m, k) for k in ("map_id", "keyframe_index", "T_world_kf",
                                    "landmark_slots", "xyz_kf", "desc")})
        for m in jr.maps.values()}
    tr = trel.Relocalizer(_params(TParams, **kw), capacity=4096, device="cpu")
    from_jax.relocalizer_state_from_numpy(tr, dict(
        db_desc=np.asarray(jr.db_desc).view(np.int32), db_map_id=np.asarray(jr.db_map_id),
        row_slot=jr.row_slot, n_rows=jr.n_rows, _slot_maps=jr._slot_maps,
        _slot_in_db=jr._slot_in_db), maps=tmaps)
    th = trel.QueryHandle(query=tmaps[h.query.map_id], nq=h.nq, idx_dev=h.idx_dev,
                          ok_dev=h.ok_dev)
    return jr, h, tr, th


@pytest.mark.parametrize("upto", [8, 11, 15])
def test_vote_gives_the_same_candidate(upto):
    maps = _scenario()
    jr, jh, tr, th = _loaded(maps, upto)
    jc, tc = jr.vote(jh), tr.vote(th)
    assert jc is not None and tc is not None
    assert tc.reference.map_id == jc.reference.map_id
    np.testing.assert_array_equal(tc.q_rows, jc.q_rows)
    np.testing.assert_array_equal(tc.r_rows, jc.r_rows)
    assert tc.n == jc.n


def test_vote_gates_match_jax():
    """A first-lap query (no eligible map holds its landmarks), and a
    revisit with its ok mask cleared, give no candidate in either package."""
    maps = _scenario()
    jr, jh, tr, th = _loaded(maps, 6)  # lap 0: nothing eligible matches
    assert jr.vote(jh) is None and tr.vote(th) is None
    jr, jh, tr, th = _loaded(maps, 9)
    jh.ok_dev = th.ok_dev = np.zeros_like(th.ok_dev)
    assert jr.vote(jh) is None and tr.vote(th) is None


@pytest.mark.parametrize("upto", [8, 13])
def test_detect_and_verify_matches_jax(upto):
    """The synchronous query that leaves the database as it was."""
    maps = _scenario()
    jr = jrel.Relocalizer(_params(JParams), capacity=4096)
    tr = trel.Relocalizer(_params(TParams), capacity=4096, device="cpu")
    for d in maps[:upto]:
        jr.add_local_map(_jmap(d))
        tr.add_local_map(from_jax.local_map_from_numpy(d))
    want = jr.detect_and_verify(_jmap(maps[upto]))
    got = tr.detect_and_verify(from_jax.local_map_from_numpy(maps[upto]))
    assert want is not None and got is not None
    assert (got.query_id, got.reference_id) == (want.query_id, want.reference_id)
    np.testing.assert_allclose(got.T_ref_query, np.asarray(want.T_ref_query), atol=POSE_ATOL)
    np.testing.assert_array_equal(got.correspondences, want.correspondences)
    assert tr.n_rows == jr.n_rows and upto not in tr.maps


# ---------------------------------------------------------------------------
# Batched closure ICP
# ---------------------------------------------------------------------------


def _icp_inputs(seed=3, B=6, N=96):
    """B point-set pairs with known transforms, 0.01 m noise and a block
    of gross outliers; one pair has too few points to converge."""
    rng = np.random.default_rng(seed)
    T_true = _exp(rng.standard_normal((B, 6)) * np.array([1.0, 1.0, 1.0, 0.15, 0.15, 0.15]))
    mov = rng.uniform(-5, 5, (B, N, 3)).astype(np.float32)
    fix = (np.einsum("bij,bnj->bni", T_true[:, :3, :3], mov) + T_true[:, None, :3, 3]
           + rng.normal(0, 0.01, (B, N, 3))).astype(np.float32)
    fix[:, -15:] += rng.uniform(-8, 8, (B, 15, 3)).astype(np.float32)
    n = np.array([N, 80, 64, 50, 40, 8])[:B]
    mask = np.arange(N)[None, :] < n[:, None]
    T0 = (T_true @ _exp(rng.normal(0, 0.05, (B, 6)))).astype(np.float32)
    return mov, fix, mask, T0, T_true


def _gn_config(p):
    return dict(kernel_max_error=p.icp_maximum_error_kernel,
                min_num_inliers=p.icp_minimum_number_of_inliers, max_iterations=50)


def _jax_icp(mov, fix, mask, T0, p):
    cfg = jgn.GNConfig(**_gn_config(p))
    data = jal.ICPData(p_moving=jnp.asarray(mov), p_fixed=jnp.asarray(fix),
                       weight=jnp.ones(mask.shape, jnp.float32))
    return jax.vmap(lambda d, m, t: jal.icp_align(d, m, t, cfg))(
        data, jnp.asarray(mask), jnp.asarray(T0))


def _assert_icp_match(x, n_inl, conv, want):
    np.testing.assert_allclose(x, np.asarray(want.x), atol=POSE_ATOL)
    np.testing.assert_array_equal(n_inl, np.asarray(want.num_inliers))
    np.testing.assert_array_equal(conv, np.asarray(want.converged))


def test_icp_align_batched_matches_jax():
    p = _params(TParams)
    mov, fix, mask, T0, T_true = _icp_inputs()
    want = _jax_icp(mov, fix, mask, T0, p)
    got = tal.icp_align(
        tal.ICPData(p_moving=torch.from_numpy(mov), p_fixed=torch.from_numpy(fix),
                    weight=torch.ones(mask.shape)),
        torch.from_numpy(mask), torch.from_numpy(T0), tgn.GNConfig(**_gn_config(p)))
    _assert_icp_match(got.x.numpy(), got.num_inliers.numpy(), got.converged.numpy(), want)
    np.testing.assert_array_equal(got.num_iterations.numpy(), np.asarray(want.num_iterations))
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    conv = got.converged.numpy()
    assert conv[:5].all() and not conv[5]
    np.testing.assert_allclose(got.x.numpy()[:5], T_true[:5], atol=0.02)


def _icp_candidates(mov, fix, mask, T_true, id_pairs):
    """ICP candidates over the point sets: the query keyframe at a random
    pose, the reference at query @ inv(T_true), ring rows = map id % 4.
    Returns (candidates, archive kf_pose (4,4,4), kf_xyz (4,K,3))."""
    rng = np.random.default_rng(9)
    B, N, _ = mov.shape
    KR = 4
    kf_pose = np.tile(np.eye(4, dtype=np.float32), (KR, 1, 1))
    kf_xyz = np.zeros((KR, N, 3), np.float32)
    cands = []
    for b, (rid, qid) in enumerate(id_pairs):
        n = int(mask[b].sum())
        Tq = _exp(rng.standard_normal(6) * 2)
        Tr = (Tq @ np.linalg.inv(T_true[b])).astype(np.float32)
        q = SimpleNamespace(map_id=qid, ring_row=qid % KR, T_world_kf=Tq,
                            xyz_kf=mov[b], landmark_slots=np.arange(N))
        r = SimpleNamespace(map_id=rid, ring_row=rid % KR, T_world_kf=Tr,
                            xyz_kf=fix[b], landmark_slots=np.arange(N) + 1000)
        for m in (q, r):
            kf_pose[m.ring_row] = m.T_world_kf
            kf_xyz[m.ring_row] = m.xyz_kf @ m.T_world_kf[:3, :3].T + m.T_world_kf[:3, 3]
        cands.append(trel.ICPCandidate(query=q, reference=r, q_rows=np.arange(n),
                                       r_rows=np.arange(n), n=n))
    return cands, kf_pose, kf_xyz


@pytest.mark.parametrize("path", ["host", "archive"])
def test_dispatch_icp_batch_matches_jax_icp_align(path):
    """One candidate per batch row, ring rows disjoint: the archive path
    gathers its point sets from kf_xyz (world positions) moved back into
    each keyframe frame by kf_pose; the host path stacks xyz_kf."""
    p = _params(TParams)
    mov, fix, mask, _, T_true = _icp_inputs(B=2)
    cands, kf_pose, kf_xyz = _icp_candidates(mov, fix, mask, T_true, [(0, 1), (2, 3)])
    T0 = np.stack([np.linalg.inv(c.reference.T_world_kf) @ c.query.T_world_kf
                   for c in cands]).astype(np.float32)
    want = _jax_icp(mov, fix, mask, T0, p)
    reloc = trel.Relocalizer(p, capacity=1024, device="cpu")
    if path == "archive":
        reloc.ring_provider = lambda: (torch.from_numpy(kf_pose), torch.from_numpy(kf_xyz), -1)
    jobs = reloc.dispatch_icp_batch(cands)
    res = [reloc.job_result(j) for j in jobs]
    _assert_icp_match(np.stack([r.x for r in res]), [r.num_inliers for r in res],
                      [r.converged for r in res], want)
    assert all(r.converged for r in res)


def test_finish_icp_matches_jax():
    maps = _scenario()
    jr, jh, tr, th = _loaded(maps, 9)
    jc, tc = jr.vote(jh), tr.vote(th)
    rng = np.random.default_rng(2)
    x = _exp(rng.normal(0, 0.1, 6))
    for n_inl, conv in ((tc.n, True), (tc.n - 3, True), (tc.n, False), (3, True),
                        (int(0.3 * tc.n) - 1, True)):
        job = SimpleNamespace(query=jc.query, reference=jc.reference, q_rows=jc.q_rows,
                              r_rows=jc.r_rows, n=jc.n)
        want = jr.finish_icp(job, SimpleNamespace(x=x, num_inliers=n_inl, converged=conv,
                                                  chi2=0.5))
        got = tr.finish_icp(tc, trel.ICPVerdict(x=x, num_inliers=n_inl, converged=conv,
                                                 chi2=0.5))
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.query_id, got.reference_id) == (want.query_id, want.reference_id)
            np.testing.assert_array_equal(got.T_ref_query, want.T_ref_query)
            np.testing.assert_array_equal(got.correspondences, want.correspondences)
            assert (got.n_correspondences, got.inlier_ratio) == (
                want.n_correspondences, want.inlier_ratio)


@pytest.mark.parametrize("with_lut", [True, False])
def test_apply_remap_matches_jax(with_lut):
    maps = _scenario()
    jr, _, tr, _ = _loaded(maps, 12)
    rng = np.random.default_rng(4)
    slots = np.unique(jr.row_slot[:jr.n_rows])
    src = rng.choice(slots, 40, replace=False)
    remap = {int(s): int(min(slots[slots != s][rng.integers(0, 50)], s)) for s in src}
    remap = {s: d for s, d in remap.items() if s != d and d not in remap}
    lut = None
    if with_lut:
        lut = np.arange(int(slots.max()) + 1, dtype=np.int32)
        for s, d in remap.items():
            lut[s] = d
    jr.apply_remap(remap, lut=lut)
    tr.apply_remap(remap, lut=lut)
    np.testing.assert_array_equal(tr.row_slot, jr.row_slot)
    assert tr._slot_in_db == jr._slot_in_db
    assert tr._slot_maps == jr._slot_maps
    assert tr._map_slot_row == jr._map_slot_row == {}


def test_grow_matches_jax():
    maps = _scenario()
    jr = jrel.Relocalizer(_params(JParams), capacity=256)
    tr = trel.Relocalizer(_params(TParams), capacity=256, device="cpu")
    for d in maps[:5]:
        jr.add_local_map(_jmap(d))
        tr.add_local_map(from_jax.local_map_from_numpy(d))
    assert tr.capacity == jr.capacity == 512 and tr.n_rows == jr.n_rows > 256
    np.testing.assert_array_equal(tr.db_desc.numpy(), np.asarray(jr.db_desc).view(np.int32))
    np.testing.assert_array_equal(tr.db_map_id.numpy(), np.asarray(jr.db_map_id))
    np.testing.assert_array_equal(tr.row_slot, jr.row_slot)
    assert tr._active_prefix() == jr._active_prefix()


# ---------------------------------------------------------------------------
# Reference faults repaired in the port
# ---------------------------------------------------------------------------


def test_archive_horizon_counts_frames_in_flight():
    """Keyframe ring of KR = 4 rows; 10 keyframes harvested and 3 frames
    dispatched past the last harvest, so the device may hold up to 13
    keyframes and rows of maps <= 9 may have been overwritten.  The JAX
    engine's horizon (harvested - KR = 6) would gather maps 7 and 9 from
    the archive; the port's (10 + 3 - 4 = 9) sends them to host xyz_kf.
    Maps 10 and 12 lie above both horizons and use the archive."""
    p = _params(TParams)
    mov, fix, mask, _, T_true = _icp_inputs(B=2)
    tracker = SimpleNamespace(_kf_harvested=10, _dispatched=40, _harvested=37)

    def run(ids, spoil):
        cands, kf_pose, kf_xyz = _icp_candidates(mov[:1], fix[:1], mask[:1], T_true[:1],
                                                 [ids])
        if spoil == "ring":  # overwritten rows: another keyframe's points
            kf_xyz = kf_xyz[::-1].copy() + 3.0
        else:  # the archive is right, the host copy is not
            cands[0].query.xyz_kf = np.zeros_like(mov[0])
        tracker.state = SimpleNamespace(kf_pose=torch.from_numpy(kf_pose),
                                        kf_xyz=torch.from_numpy(kf_xyz))
        eng = SimpleNamespace(tracker=tracker)
        reloc = trel.Relocalizer(p, capacity=1024, device="cpu")
        reloc.ring_provider = lambda: SlamEngine._ring_provider(eng)
        assert reloc.ring_provider()[2] == 9
        return reloc.job_result(reloc.dispatch_icp_batch(cands)[0])

    for ids, spoil in (((7, 9), "ring"), ((10, 12), "host")):
        res = run(ids, spoil)
        assert res.converged, ids
        np.testing.assert_allclose(res.x, T_true[0], atol=0.02)


def test_descriptor_block_is_as_wide_as_the_snapshot():
    """local_map.maximum_number_of_landmarks = 1536 (> the JAX package's
    fixed 1024): the snapshot rows, the gathered query block and the
    database insert keep all 1536 rows."""
    cfg = tconfig.ParameterCollection()
    cfg.framepoint_generation.capacity = 2048
    cfg.local_map.maximum_number_of_landmarks = 1536
    cam = tcam.make_camera(fx=300, fy=300, cx=256, cy=96, baseline_m=0.4, rows=192, cols=512,
                           device="cpu")
    eng = SlamEngine(cam, cfg, landmark_capacity=4096, device="cpu")
    K = eng.tracker.state.kf_desc.shape[1]
    assert K == eng.relocalizer.QUERY_CAP == 1536
    rng = np.random.default_rng(8)
    kf_desc = torch.from_numpy(rng.integers(-2**31, 2**31, (4, K, 8), dtype=np.int64)
                               .astype(np.int32))
    block = tfused.gather_kf_desc(kf_desc, torch.tensor([2, 0]), out_cap=K)
    assert torch.equal(block, kf_desc[[2, 0]])
    lm = from_jax.local_map_from_numpy(dict(
        map_id=0, keyframe_index=0, T_world_kf=np.eye(4), landmark_slots=np.arange(K),
        xyz_kf=np.zeros((K, 3)), desc=None))
    lm.desc_dev = block[0]
    eng.relocalizer.add_local_map(lm)
    assert eng.relocalizer.n_rows == K
    assert torch.equal(eng.relocalizer.db_desc[:K], kf_desc[2])


def test_closure_support_setting_warns_and_closes_nothing(capsys):
    """minimum_matches_per_correspondence >= 2 can never pass with top-1
    matching: the port says so once, at construction, and, like the JAX
    package, closes no loop."""
    trel.Relocalizer(_params(TParams, minimum_matches_per_correspondence=2), capacity=1024,
                     device="cpu")
    err = capsys.readouterr().err
    assert err.count("minimum_matches_per_correspondence") == 1 and "no loop" in err
    _, _, (jc, tc) = _run_both(_scenario(), minimum_matches_per_correspondence=2)
    assert jc == [] and tc == []
    capsys.readouterr()
    trel.Relocalizer(_params(TParams, minimum_matches_per_correspondence=1), capacity=1024,
                     device="cpu")
    assert "minimum_matches_per_correspondence" not in capsys.readouterr().err
