"""The relocalizer's DB query as one program per key
(relocalizer.query_program: the JAX package's jitted
_query_and_insert_many, the database donated and `prefix` static) on the
CPU, where the program runs eagerly on the same buffers the card
captures.

  * the program against the plain function and against JAX's
    _query_and_insert_many at SB 1, 2, 4, 8 and prefixes 1,024 and 8,192:
    best and ok exact, the database after the insert bit-exact (in the
    program's buffers, updated in place);
  * the row blocks of the search (relocalizer.QUERY_BLOCK) give the
    bits of one unblocked distance matrix;
  * a database that grows inside a run drops the programs of the old
    capacity, builds those of the new and keeps every result;
  * detect_and_verify goes through the program and inserts nothing;
  * relocalizers taking turns on the shared programs each keep their own
    database;
  * the warm-up reaches every (SB, prefix) key of the settings.
The closed loops of tests/test_torch_closed_loop.py (borders 12 and 20)
run their queries through these programs and keep their events.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.loop import relocalizer as jrel
from vslam_tpu_torch.io.config import RelocalizationParameters as TParams
from vslam_tpu_torch.loop import relocalizer as trel
from vslam_tpu_torch.mapping.local_maps import LocalMap as TLocalMap

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

MAX_D, MARGIN = 45, 8


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _problem(seed, SB, CAP, prefix, cap):
    """A database of about 0.7 prefix live rows in a `cap`-row table and
    SB queries of CAP rows (exact and near copies, random rows; the last
    query padded when SB > 1), with fresh rows inserted after the live
    ones."""
    rng = np.random.default_rng(seed)
    n_rows = int(0.7 * prefix)
    db = rng.integers(0, 2**32, (cap, 8), dtype=np.uint32)
    db[n_rows:] = 0
    mid = np.full(cap, -1, np.int32)
    mid[:n_rows] = np.sort(rng.integers(0, 40, n_rows))
    maxm = rng.integers(5, 40, SB).astype(np.int32)
    if SB > 1:
        maxm[-1] = -1
    q = rng.integers(0, 2**32, (SB, CAP, 8), dtype=np.uint32)
    for s in range(SB):
        eligible = np.flatnonzero((mid >= 0) & (mid <= max(maxm[s], 0)))
        q[s, :CAP // 4] = db[rng.choice(eligible, CAP // 4)]
        near = db[rng.choice(eligible, CAP // 4)]
        near[:, 0] ^= np.uint32(0x10101)
        q[s, CAP // 4:CAP // 2] = near
    fresh = rng.random(SB * CAP) < 0.3
    if SB > 1:
        fresh[(SB - 1) * CAP:] = False
    dest = np.full(SB * CAP, -1, np.int32)
    sel = np.flatnonzero(fresh)
    dest[sel] = n_rows + np.arange(len(sel))
    row_mid = np.where(fresh, np.repeat(40 + np.arange(SB), CAP), 0).astype(np.int32)
    return q, dest, row_mid, db, mid, maxm


def _program(SB, CAP, prefix, cap, db, mid):
    """A fresh query program with the database loaded into its buffers."""
    trel.clear_query_programs()
    prog = trel.query_program(SB, CAP, prefix, cap, MAX_D, MARGIN, "cpu")
    store = trel._database(cap, torch.device("cpu"))
    store.desc.copy_(_i32(db))
    store.map_id.copy_(torch.from_numpy(mid))
    return prog, store


@pytest.mark.parametrize("SB", [1, 2, 4, 8])
@pytest.mark.parametrize("prefix", [1024, 8192])
def test_query_program_matches_function_and_jax(SB, prefix):
    CAP, cap = 64, 2 * prefix
    q, dest, row_mid, db, mid, maxm = _problem(SB * 10 + prefix, SB, CAP, prefix, cap)
    prog, store = _program(SB, CAP, prefix, cap, db, mid)
    best, ok = prog.run((_i32(q), dest, row_mid, maxm))

    fb, fok, fdb, fmid = trel._query_and_insert_many(
        _i32(q), torch.from_numpy(dest), torch.from_numpy(row_mid), _i32(db),
        torch.from_numpy(mid), torch.from_numpy(maxm), MAX_D, MARGIN, prefix)
    assert torch.equal(best, fb) and torch.equal(ok, fok)
    assert torch.equal(store.desc, fdb) and torch.equal(store.map_id, fmid)

    jb, jok, jdb, jmid = jrel._query_and_insert_many(
        jnp.asarray(q), jnp.asarray(dest), jnp.asarray(row_mid), jnp.asarray(db),
        jnp.asarray(mid), jnp.asarray(maxm), jnp.int32(MAX_D), jnp.int32(MARGIN), prefix)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(store.desc.numpy(), np.asarray(jdb).view(np.int32))
    np.testing.assert_array_equal(store.map_id.numpy(), np.asarray(jmid))
    ok_np = ok.numpy()
    real = SB - 1 if SB > 1 else 1
    assert ok_np[:real, :CAP // 2].all()  # copies of eligible rows match
    assert not ok_np[real:].any()  # a padded query matches nothing


def test_search_blocks_give_the_unblocked_bits(monkeypatch):
    SB, CAP, prefix, cap = 4, 64, 1024, 2048
    q, dest, row_mid, db, mid, maxm = _problem(3, SB, CAP, prefix, cap)
    args = (_i32(q), torch.from_numpy(dest), torch.from_numpy(row_mid), _i32(db),
            torch.from_numpy(mid), torch.from_numpy(maxm), MAX_D, MARGIN, prefix)
    whole = trel._query_and_insert_many(*args)
    monkeypatch.setattr(trel, "QUERY_BLOCK", 24 * prefix)  # blocks of 24 rows
    blocked = trel._query_and_insert_many(*args)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def _local_map(map_id, slots, desc):
    T = np.eye(4, dtype=np.float32)
    return TLocalMap(map_id=map_id, keyframe_index=map_id, T_world_kf=T,
                     landmark_slots=np.asarray(slots, np.int32),
                     xyz_kf=np.zeros((len(slots), 3), np.float32),
                     desc=np.asarray(desc, np.uint32))


def _params():
    p = TParams()
    p.preliminary_minimum_interspace_queries = 2
    return p


def _maps(seed, n_maps=6, per_map=400):
    """Local maps at three places, visited twice: each map holds half of
    its place's landmarks (the same slots and descriptors at every visit)
    and per_map / 2 landmarks of its own."""
    rng = np.random.default_rng(seed)
    half = per_map // 2
    desc = rng.integers(0, 2**32, (3 * per_map + n_maps * half, 8),
                        dtype=np.uint64).astype(np.uint32)
    maps = []
    for m in range(n_maps):
        slots = np.concatenate([np.arange((m % 3) * per_map, (m % 3) * per_map + half),
                                3 * per_map + np.arange(m * half, (m + 1) * half)])
        maps.append(_local_map(m, slots, desc[slots]))
    return maps


def _drive(reloc, maps):
    """Submit the maps two at a time; returns the fetched (best, ok) of
    every handle."""
    out = []
    for i in range(0, len(maps), 2):
        for h in reloc.submit_batch(maps[i:i + 2]):
            if h is not None:
                reloc.fetch([h], [])
                out.append((h.idx_dev.copy(), h.ok_dev.copy()))
    return out


def test_growing_database_rebuilds_the_programs():
    trel.clear_query_programs()
    maps = _maps(5)
    grown = trel.Relocalizer(_params(), query_cap=512, capacity=1024, device="cpu")
    ref = trel.Relocalizer(_params(), query_cap=512, capacity=8192, device="cpu")
    got = _drive(grown, maps)
    assert grown.capacity > 1024  # it grew inside the run
    # Only the grown capacity's programs and database are left.
    assert {k[3] for k in trel._QUERY_PROGRAMS} == {grown.capacity}
    assert set(trel._DATABASES) == {(grown.capacity, torch.device("cpu"))}
    trel.clear_query_programs()
    want = _drive(ref, maps)
    assert len(got) == len(want) > 0
    for (gb, gok), (wb, wok) in zip(got, want):
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gok, wok)
    n = grown.n_rows
    assert n == ref.n_rows
    assert torch.equal(grown.db_desc[:n], ref.db_desc[:n])
    assert torch.equal(grown.db_map_id[:n], ref.db_map_id[:n])
    assert any(ok.any() for _, ok in got)  # the revisits match their places


def test_detect_and_verify_inserts_nothing():
    trel.clear_query_programs()
    maps = _maps(6)
    reloc = trel.Relocalizer(_params(), query_cap=512, capacity=8192, device="cpu")
    _drive(reloc, maps[:4])
    desc, mid = reloc.db_desc.clone(), reloc.db_map_id.clone()
    n_rows, uses = reloc.n_rows, sum(p.uses for p in trel._QUERY_PROGRAMS.values())
    reloc.detect_and_verify(maps[5])
    assert sum(p.uses for p in trel._QUERY_PROGRAMS.values()) == uses + 1
    assert reloc.n_rows == n_rows
    assert torch.equal(reloc.db_desc, desc) and torch.equal(reloc.db_map_id, mid)


def test_relocalizers_taking_turns_keep_their_databases():
    trel.clear_query_programs()
    a_maps, b_maps = _maps(7), _maps(8)
    alone = []
    for maps in (a_maps, b_maps):
        trel.clear_query_programs()
        r = trel.Relocalizer(_params(), query_cap=512, capacity=8192, device="cpu")
        alone.append((_drive(r, maps), r.db_desc.clone(), r.db_map_id.clone()))
    trel.clear_query_programs()
    a = trel.Relocalizer(_params(), query_cap=512, capacity=8192, device="cpu")
    b = trel.Relocalizer(_params(), query_cap=512, capacity=8192, device="cpu")
    got = {id(a): [], id(b): []}
    for i in range(0, len(a_maps), 2):
        for r, maps in ((a, a_maps), (b, b_maps)):
            for h in r.submit_batch(maps[i:i + 2]):
                if h is not None:
                    r.fetch([h], [])
                    got[id(r)].append((h.idx_dev.copy(), h.ok_dev.copy()))
    for r, (res, desc, mid) in zip((a, b), alone):
        assert len(got[id(r)]) == len(res)
        for (gb, gok), (wb, wok) in zip(got[id(r)], res):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gok, wok)
        assert torch.equal(r.db_desc, desc) and torch.equal(r.db_map_id, mid)


def test_warm_up_reaches_every_key():
    trel.clear_query_programs()
    p = TParams()
    p.preliminary_minimum_interspace_queries = 6
    trel.warm_query_programs(p, 128, 4096, capacity=8192, device="cpu")
    keys = {(k[0], k[2]) for k in trel._QUERY_PROGRAMS}
    assert keys == {(SB, prefix) for SB in (1, 2, 4, 8) for prefix in (1024, 2048, 4096)}
    assert all(prog.uses == 1 for prog in trel._QUERY_PROGRAMS.values())
