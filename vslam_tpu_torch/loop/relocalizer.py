"""Loop-closure detection and geometric verification (port of
vslam_tpu/loop/relocalizer.py, single-device path).

The reference's HBST tree (src/relocalization/relocalizer.cpp:42-280)
becomes one device-resident Hamming database: every landmark of every
local map is a row (`db_desc`, 8 int32 words, with `db_map_id`, the local
map that first inserted it); a query local map is matched against the
whole database as one bit-matrix product, votes are counted per
reference map on the host, and the winning candidates are verified with
batched point-to-point ICP (reference XYZAligner, xyz_aligner.cpp:106-177),
or, with aligner_type FAST-ICP, Anderson-accelerated ICP (solve/anderson.py).

* One row per landmark: the second-best margin test would reject every
  landmark whose rows were duplicated across local maps.
* Votes follow membership: a matched row votes for every local map that
  holds its landmark (merged HBST matchables, relocalizer.cpp:86-123).
* The interspace gate lives on the device: rows with
  map_id > query_id - interspace are masked before the arg-min.
* Pipelined: submit_batch dispatches one query+insert program per drain
  and returns handles without a sync; the engine fetches the results at
  its next drain, votes, dispatches the ICP batch, and fetches that at
  the drain after.

With a mesh (parallelism.shard_descriptor_db under a process group of
more than one rank) every rank matches its row block of the database and
the ranks' winners are combined (parallel/sharded_search.py).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from itertools import chain

import numpy as np
import torch

from vslam_tpu_torch.io.config import RelocalizationParameters
from vslam_tpu_torch.mapping.local_maps import Closure, LocalMap
from vslam_tpu_torch.ops import hamming, program
from vslam_tpu_torch.parallel import mesh as mesh_mod
from vslam_tpu_torch.parallel import sharded_search
from vslam_tpu_torch.solve import aligners, anderson, gn
from vslam_tpu_torch.utils import log
from vslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# Largest ICP batch: bigger drains verify in several batches; a batch is
# padded to the next bucket.
ICP_MAX_BATCH = 16
ICP_BUCKETS = (8, 16)


def _insert(db_desc, db_map_id, rows, dest, row_map_id):
    """Append rows at their database destinations (dest -1 = skip) as
    predicated add-delta scatters: skipped rows alias row 0 and add zero;
    inserted rows hit distinct, still-empty rows, so each delta is the
    value itself (no int32 wrap-around)."""
    put = dest >= 0
    tgt = torch.where(put, dest, 0).to(torch.int64)
    db_desc = db_desc.index_add(
        0, tgt, torch.where(put[:, None], rows - db_desc[tgt], 0).to(db_desc.dtype))
    db_map_id = db_map_id.index_add(
        0, tgt, torch.where(put, row_map_id - db_map_id[tgt], 0).to(db_map_id.dtype))
    return db_desc, db_map_id


def _query_and_insert_many(q_desc, dest, row_map_id, db_desc, db_map_id, max_map_id,
                           max_distance: int, min_margin: int, prefix: int, mesh=None):
    """S keyframe queries against the database as it was before this call,
    in one distance matrix, then all their fresh rows appended.

    q_desc: (S, CAP, 8) int32 query descriptors; dest: (S*CAP,) database
    row per flattened query row (-1 = not fresh); row_map_id: (S*CAP,)
    first-insertion map id to write; max_map_id: (S,) interspace bound
    (-1 = padded query).  Only the active `prefix` rows are matched.
    Returns (best (S, CAP) row, ok (S, CAP), db_desc, db_map_id).

    The margin test masks only the column equal to `best`, so a tied
    runner-up gives margin 0 and the row is rejected.

    With a mesh every rank matches its contiguous block of the prefix
    (sharded_search.search_sharded_top2; the database itself, and the
    inserts, are the same on every rank).  A missing runner-up then
    counts 511, not BIG: the margin test decides alike while min_margin
    <= 511 - max_distance."""
    S, CAP, _ = q_desc.shape
    qs = q_desc.reshape(S * CAP, 8)
    mid = db_map_id[:prefix]
    bound = torch.repeat_interleave(max_map_id, CAP)[:, None]
    if mesh is not None:
        mid = mesh_mod.shard_rows(mid, mesh)
        best, best_d, second_d = sharded_search.search_sharded_top2(
            qs, mesh_mod.shard_rows(db_desc[:prefix], mesh),
            (mid[None, :] >= 0) & (mid[None, :] <= bound), mesh)
    else:
        dist = hamming.hamming_matrix_bits(qs, db_desc[:prefix])
        eligible = (mid[None, :] >= 0) & (mid[None, :] <= bound)
        best_d, best = hamming._min_first(hamming._masked(dist, eligible), 1)
        cols = torch.arange(prefix, dtype=torch.int32, device=dist.device)
        dist_m = torch.where(eligible, dist, hamming.BIG)
        second_d = torch.where(cols[None, :] == best[:, None], hamming.BIG,
                               dist_m).amin(dim=1)
    ok = (best_d <= max_distance) & (second_d - best_d >= min_margin)
    db_desc, db_map_id = _insert(db_desc, db_map_id, qs, dest, row_map_id)
    return best.reshape(S, CAP), ok.reshape(S, CAP), db_desc, db_map_id


def _fetch(tensors) -> list[np.ndarray]:
    """Copy several device tensors to the host in ONE transfer (packed as
    f64, exact for the int32/bool/f32 fields carried here)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, k = [], 0
    for t in tensors:
        n = t.numel()
        a = flat[k:k + n].reshape(tuple(t.shape))
        out.append(a.astype(str(t.dtype).replace("torch.", "")))
        k += n
    return out


@dataclass
class QueryHandle:
    """An in-flight closure query: idx/ok are device tensors until the
    engine fetches them (then host arrays)."""

    query: LocalMap
    nq: int
    idx_dev: object  # (QUERY_CAP,) int32 database rows
    ok_dev: object  # (QUERY_CAP,) bool


@dataclass
class ICPCandidate:
    """A vote-gate survivor awaiting geometric verification."""

    query: LocalMap
    reference: LocalMap
    q_rows: np.ndarray
    r_rows: np.ndarray
    n: int


@dataclass(eq=False)
class ICPBatch:
    """One dispatched batched ICP: its device result, shared by the
    batch's jobs and fetched once."""

    res_dev: gn.GNResult
    fetched: object = None  # host copy (x, num_inliers, converged, chi2)


@dataclass
class ICPJob:
    """An in-flight closure verification (gate it with finish_icp)."""

    query: LocalMap
    reference: LocalMap
    q_rows: np.ndarray
    r_rows: np.ndarray
    n: int
    batch: ICPBatch
    index: int  # row of this job inside the batch


@dataclass
class ICPVerdict:
    """One job's host result."""

    x: np.ndarray
    num_inliers: int
    converged: bool
    chi2: float


def _icp_config(p: RelocalizationParameters) -> gn.GNConfig:
    return gn.GNConfig(kernel_max_error=p.icp_maximum_error_kernel,
                       min_num_inliers=p.icp_minimum_number_of_inliers,
                       max_iterations=50)


def icp_bucket(B: int) -> int:
    """The padded batch of B closure ICP problems (the JAX package's
    compile buckets, warm_icp_batches)."""
    if not 1 <= B <= ICP_MAX_BATCH:
        raise ValueError(f"ICP batch of {B} (1..{ICP_MAX_BATCH})")
    return next(b for b in ICP_BUCKETS if B <= b)


class ICPProgram(program.StaticProgram):
    """The closure ICP solve at one batch bucket as one device program
    (the JAX package's _batched_icp_solver, jitted per bucket): static
    input buffers of B = bucket problems, the rows past the batch masked
    out (no points, the identity guess).  On CUDA its first use runs
    eagerly, its second captures it (control.graph_capture: each GN
    phase a WHILE node; FAST-ICP's fixed rounds as they are) and every
    use replays it; results are copied out of the program's outputs,
    which the next replay overwrites.  On the CPU every use runs the
    same solve eagerly on the same buffers.

    The relocalizers of a process share one program a key (icp_program,
    the JAX package's memoized _batched_icp_solver); on CUDA, EVENTS
    counts their eager batches, captures and replays."""

    def __init__(self, solve, config: gn.GNConfig, B: int, cap: int, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.solve, self.config = solve, config
        self.mov = torch.zeros((B, cap, 3), **f32)
        self.fix = torch.zeros((B, cap, 3), **f32)
        self.weight = torch.ones((B, cap), **f32)
        self.mask = torch.zeros((B, cap), dtype=torch.bool, device=device)
        self.eye = torch.eye(4, **f32)
        self.T0 = self.eye.repeat(B, 1, 1)
        super().__init__(self._solve, (self.mov, self.fix, self.weight, self.mask, self.T0),
                         EVENTS)

    def _solve(self, bufs) -> gn.GNResult:
        mov, fix, weight, mask, T0 = bufs
        return self.solve(aligners.ICPData(mov, fix, weight), mask, T0, self.config)

    def run(self, mov, fix, mask, T0) -> gn.GNResult:
        """Solve n <= B problems: mov, fix (n, cap, 3), mask (n, cap), T0
        (n, 4, 4) on the program's device.  The result has the bucket's
        B rows; rows n.. are the padding's."""
        self.load_batch(mov, fix, mask, T0)
        return self.evaluate()

    def load_batch(self, mov, fix, mask, T0) -> None:
        """The batch into the buffers, the rows past it masked out."""
        n = mov.shape[0]
        for buf, src in ((self.mov, mov), (self.fix, fix), (self.mask, mask), (self.T0, T0)):
            buf[:n].copy_(src)
        self.mov[n:].zero_()
        self.fix[n:].zero_()
        self.mask[n:].fill_(False)
        self.T0[n:].copy_(self.eye.expand_as(self.T0[n:]))


# Eager batches, captures and replays of every ICPProgram (CUDA only).
EVENTS: Counter = Counter()
# The process's ICP programs, by (aligner, bucket, cap, config, device).
_PROGRAMS: dict[tuple, ICPProgram] = {}


def icp_program(p: RelocalizationParameters, bucket: int, device) -> ICPProgram:
    """The process's closure ICP program for a bucket of this
    configuration on this device (one per key, as the JAX package's
    memoized _batched_icp_solver and its jit cache)."""
    cap, config, device = int(p.icp_correspondence_cap), _icp_config(p), resolve_device(device)
    key = (p.aligner_type, bucket, cap, config, device)
    if key not in _PROGRAMS:
        fast = p.aligner_type == "FAST-ICP"
        _PROGRAMS[key] = ICPProgram(anderson.fast_icp_align if fast else aligners.icp_align,
                                    config, bucket, cap, device)
    return _PROGRAMS[key]


def clear_icp_programs() -> None:
    """Forget every shared ICP program."""
    _PROGRAMS.clear()


def warm_icp_batches(params: RelocalizationParameters, buckets=ICP_BUCKETS,
                     device=DEFAULT_DEVICE) -> None:
    """Run the batched ICP program of each bucket on the JAX package's
    warm-up problem (no points, every row masked in, the identity guess)
    until it is captured, so a later closure batch replays it (the JAX
    package's warm_icp_batches, which compiles the buckets)."""
    for B in buckets:
        prog = icp_program(params, B, device)
        cap, dev = prog.mov.shape[1], prog.device
        zeros = torch.zeros((B, cap, 3), dtype=torch.float32, device=dev)
        prog.load_batch(zeros, zeros, torch.ones((B, cap), dtype=torch.bool, device=dev),
                        torch.eye(4, dtype=torch.float32, device=dev).repeat(B, 1, 1))
        prog.warm()


class Relocalizer:
    def __init__(self, params: RelocalizationParameters, query_cap: int = 1024,
                 capacity: int = 131072, device=DEFAULT_DEVICE, mesh=None):
        """query_cap: the query/insert block width — the snapshot width
        min(local_map.maximum_number_of_landmarks, capacity), so no
        landmark of a local map is dropped (the JAX package fixes 1024).
        mesh: a parallel.mesh.Mesh to search the database row-sharded
        (None: one device)."""
        if params.minimum_matches_per_correspondence >= 2:
            # Top-1 Hamming matching gives every pair a support of exactly
            # 1, so the reference's count_best > threshold gate
            # (relocalizer.cpp:267) can never pass.
            log.warning(
                f"relocalization.minimum_matches_per_correspondence = "
                f"{params.minimum_matches_per_correspondence} >= 2: no closure "
                "correspondence can form (every match has support 1), so no "
                "loop will close; use 0 or 1")
        self.params = params
        self.mesh = mesh
        self.QUERY_CAP = int(query_cap)
        self.capacity = capacity
        self.device = resolve_device(device)
        # () -> (kf_pose (KR,4,4), kf_xyz (KR,K,3), horizon map id): the
        # tracker's snapshot archive; maps above the horizon gather their
        # ICP point sets there on the device.
        self.ring_provider = None
        self.db_desc = torch.zeros((capacity, 8), dtype=torch.int32, device=self.device)
        self.db_map_id = torch.full((capacity,), -1, dtype=torch.int32, device=self.device)
        self.row_slot = np.full(capacity, -1, np.int32)
        self.n_rows = 0
        self.maps: dict[int, LocalMap] = {}
        # landmark slot -> every local map containing it (drives voting).
        self._slot_maps: dict[int, list[int]] = {}
        self._slot_in_db: set[int] = set()
        self._map_slot_row: dict[int, dict[int, int]] = {}

    def _active_prefix(self) -> int:
        """Power-of-two bucket (>= 1024) covering the live rows."""
        n = max(self.n_rows, 1)
        return min(1 << max((n - 1).bit_length(), 10), self.capacity)

    def _grow(self):
        """Double the device database."""
        new_cap = self.capacity * 2
        log.warning(f"relocalizer database full at {self.n_rows} rows — growing to {new_cap}")
        db_desc = torch.zeros((new_cap, 8), dtype=torch.int32, device=self.device)
        db_map_id = torch.full((new_cap,), -1, dtype=torch.int32, device=self.device)
        db_desc[:self.capacity] = self.db_desc
        db_map_id[:self.capacity] = self.db_map_id
        self.db_desc, self.db_map_id = db_desc, db_map_id
        row_slot = np.full(new_cap, -1, np.int32)
        row_slot[:self.capacity] = self.row_slot
        self.row_slot = row_slot
        self.capacity = new_cap

    def _stage_chunk(self, lm: LocalMap):
        """Host prep shared by submit and add: dedup fresh rows, register
        membership, reserve row metadata.  Returns (q_desc (QUERY_CAP, 8)
        device block, fresh (QUERY_CAP,) host mask, nq, offset).

        q_desc is lm.desc_dev when the descriptors never left the device
        (rows past nq may then hold stale ring data: never fresh, and
        their query results are ignored by vote())."""
        CAP = self.QUERY_CAP
        nq = min(len(lm.landmark_slots), CAP)
        self.maps[lm.map_id] = lm
        fresh = np.zeros(CAP, bool)
        slots = np.asarray(lm.landmark_slots[:nq])
        for i in range(nq):
            s = int(slots[i])
            self._slot_maps.setdefault(s, []).append(lm.map_id)
            if s not in self._slot_in_db:
                fresh[i] = True
                self._slot_in_db.add(s)
        k = int(fresh.sum())
        while self.n_rows + k > self.capacity:
            self._grow()
        if lm.desc is None:
            if lm.desc_dev is None:
                raise ValueError(f"local map {lm.map_id}: no host descriptors and no "
                                 "device block (desc_dev)")
            q_desc = lm.desc_dev
        else:
            block = np.zeros((CAP, 8), np.int32)
            block[:nq] = np.asarray(lm.desc[:nq]).view(np.int32)
            q_desc = torch.from_numpy(block).to(self.device)
        offset = self.n_rows
        self.row_slot[offset:offset + k] = slots[np.flatnonzero(fresh)]
        self.n_rows += k
        return q_desc, fresh, nq, offset

    def _dest(self, fresh: np.ndarray, offset: int) -> np.ndarray:
        dest = np.full(len(fresh), -1, np.int32)
        sel = np.flatnonzero(fresh)
        dest[sel] = offset + np.arange(len(sel))
        return dest

    def add_local_map(self, lm: LocalMap) -> None:
        """Insert a local map's fresh landmark rows (no query)."""
        q_desc, fresh, _, offset = self._stage_chunk(lm)
        if not fresh.any():
            return
        dest = torch.from_numpy(self._dest(fresh, offset)).to(self.device)
        row_mid = torch.full_like(dest, lm.map_id)
        self.db_desc, self.db_map_id = _insert(self.db_desc, self.db_map_id, q_desc,
                                               dest, row_mid)

    def submit(self, lm: LocalMap) -> QueryHandle | None:
        """Dispatch query+insert for one new local map (no sync)."""
        return self.submit_batch([lm])[0]

    def submit_batch(self, lms: list[LocalMap]) -> list[QueryHandle | None]:
        """Dispatch query+insert for several new local maps as one device
        program per interspace-sized group, without a sync.  A handle is
        None where nothing can be eligible yet.  Groups never exceed the
        interspace, so within-group maps stay mutually ineligible and the
        result equals the one-by-one path."""
        p = self.params
        interspace = max(int(p.preliminary_minimum_interspace_queries), 1)
        if len(lms) > interspace:
            out = []
            for i in range(0, len(lms), interspace):
                out.extend(self.submit_batch(lms[i:i + interspace]))
            return out
        S = len(lms)
        assert S <= interspace, (
            f"relocalizer batch of {S} maps exceeds interspace {interspace}")
        CAP = self.QUERY_CAP
        prefix = self._active_prefix()  # the rows before this insert
        with log.measure("reloc_stage"):
            staged = [self._stage_chunk(lm) for lm in lms]
        SB = 1 << max(S - 1, 0).bit_length()  # padded queries match nothing
        dest = np.full(SB * CAP, -1, np.int32)
        row_mid = np.zeros(SB * CAP, np.int32)
        maxm = np.full(SB, -1, np.int32)
        for i, (lm, (_, fresh, _, offset)) in enumerate(zip(lms, staged)):
            dest[i * CAP:(i + 1) * CAP] = self._dest(fresh, offset)
            row_mid[i * CAP:(i + 1) * CAP] = np.where(fresh, lm.map_id, 0)
            maxm[i] = lm.map_id - p.preliminary_minimum_interspace_queries
        parts = [st[0][None] for st in staged]
        if SB > S:
            parts.append(torch.zeros((SB - S, CAP, 8), dtype=torch.int32,
                                     device=self.device))
        host = torch.from_numpy(np.concatenate([dest, row_mid, maxm])).to(self.device)
        with log.measure("reloc_dispatch"):
            best, ok, self.db_desc, self.db_map_id = self._query_and_insert(
                torch.cat(parts), host[:SB * CAP], host[SB * CAP:2 * SB * CAP],
                host[2 * SB * CAP:], prefix)
        return [
            None if maxm[i] < 0 or nq == 0
            else QueryHandle(query=lm, nq=nq, idx_dev=best[i], ok_dev=ok[i])
            for i, (lm, (_, _, nq, _)) in enumerate(zip(lms, staged))
        ]

    def _query_and_insert(self, q_desc, dest, row_map_id, max_map_id, prefix: int):
        """_query_and_insert_many on this relocalizer's database: row-sharded
        over the mesh when the searched prefix divides across it (the
        same results), else on one device."""
        p = self.params
        args = (q_desc, dest, row_map_id, self.db_desc, self.db_map_id, max_map_id,
                int(p.maximum_descriptor_distance), int(p.minimum_second_best_margin), prefix)
        if (self.mesh is not None and prefix % self.mesh.size == 0
                and prefix <= sharded_search.MAX_ROWS):
            return _query_and_insert_many(*args, mesh=self.mesh)
        return _query_and_insert_many(*args)

    def vote(self, handle: QueryHandle | None):
        """Vote per reference map on a fetched query result and build the
        winner's correspondences (host only).  Returns an ICPCandidate, or
        None if no candidate clears the gates."""
        if handle is None:
            return None
        p = self.params
        lm, nq = handle.query, handle.nq
        idx = np.asarray(handle.idx_dev)[:nq]
        ok = np.asarray(handle.ok_dev)[:nq]
        if not ok.any():
            return None
        max_map_id = lm.map_id - p.preliminary_minimum_interspace_queries
        # Each matched row votes for every eligible map holding its landmark.
        q_rows_all = np.flatnonzero(ok)
        matched_slots = self.row_slot[idx[q_rows_all]]
        mids = np.fromiter(
            chain.from_iterable(self._slot_maps.get(int(s), ()) for s in matched_slots),
            np.int64)
        mids = mids[mids <= max_map_id]
        if len(mids) == 0:
            return None
        # Ambiguity gate (relocalizer.cpp:126): enough distinct landmarks.
        if len(np.unique(matched_slots)) < p.minimum_number_of_matches_per_landmark:
            return None
        counts = np.bincount(mids)
        best_map = int(np.argmax(counts))  # lowest map id among ties
        n_votes = int(counts[best_map])
        ratio = n_votes / nq
        if (ratio < p.preliminary_minimum_matching_ratio
                or n_votes < p.icp_minimum_number_of_inliers):
            log.debug(f"closure candidate {best_map}<-{lm.map_id}: vote gate failed "
                      f"({n_votes} votes, ratio {ratio:.3f})")
            return None
        # Correspondences into the winner, in its keyframe frame.
        ref = self.maps[best_map]
        slot_row = self._map_slot_row.get(best_map)
        if slot_row is None:
            slot_row = {int(s): j for j, s in enumerate(ref.landmark_slots)}
            self._map_slot_row[best_map] = slot_row
        pairs = [(int(q), slot_row[int(s)]) for q, s in zip(q_rows_all, matched_slots)
                 if int(s) in slot_row]
        # Per-correspondence support gate (relocalizer.cpp:267): top-1
        # matching gives every pair support 1, so >= 2 keeps none (warned
        # about at construction).
        if p.minimum_matches_per_correspondence >= 2:
            pairs = []
        if len(pairs) < p.icp_minimum_number_of_inliers:
            return None
        return ICPCandidate(
            query=lm, reference=ref,
            q_rows=np.asarray([a for a, _ in pairs]),
            r_rows=np.asarray([b for _, b in pairs]),
            n=min(len(pairs), int(p.icp_correspondence_cap)),
        )

    def dispatch_icp_batch(self, candidates) -> list[ICPJob]:
        """Verify all of a drain's vote survivors as batched robust
        point-to-point ICP (no sync): one ICPProgram run a batch, padded
        to its bucket (8 or 16).

        Point sets come from the tracker's snapshot archive on the device
        when every map of the batch lies above the ring provider's
        horizon (rows that cannot have been overwritten), else from the
        local maps' host xyz_kf blocks.  The initial guess is the current
        (drift-carrying) relative keyframe pose, as the reference seeds
        its closure aligners (xyz_aligner.cpp:13-40)."""
        candidates = [c for c in candidates if c is not None]
        if not candidates:
            return []
        if len(candidates) > ICP_MAX_BATCH:
            out = []
            for i in range(0, len(candidates), ICP_MAX_BATCH):
                out.extend(self.dispatch_icp_batch(candidates[i:i + ICP_MAX_BATCH]))
            return out
        p = self.params
        cap = int(p.icp_correspondence_cap)
        B = len(candidates)
        dev = self.device
        T0 = np.stack([np.linalg.inv(c.reference.T_world_kf) @ c.query.T_world_kf
                       for c in candidates]).astype(np.float32)
        n = np.asarray([c.n for c in candidates])
        q_rows = np.zeros((B, cap), np.int64)
        r_rows = np.zeros((B, cap), np.int64)
        for i, c in enumerate(candidates):
            q_rows[i, :c.n] = c.q_rows[:c.n]
            r_rows[i, :c.n] = c.r_rows[:c.n]
        mask = torch.from_numpy(np.arange(cap)[None, :] < n[:, None]).to(dev)
        ring = self.ring_provider() if self.ring_provider else None
        archive_ok = ring is not None and all(
            c.query.ring_row >= 0 and c.reference.ring_row >= 0
            and c.query.map_id > ring[2] and c.reference.map_id > ring[2]
            for c in candidates)
        if archive_ok:
            kf_pose, kf_xyz, _ = ring
            qr = torch.tensor([c.query.ring_row for c in candidates], device=dev)
            rr = torch.tensor([c.reference.ring_row for c in candidates], device=dev)
            b = torch.arange(B, device=dev)[:, None]

            def in_kf_frame(ring_rows, rows):
                T = kf_pose[ring_rows]
                pts = kf_xyz[ring_rows][b, torch.from_numpy(rows).to(dev)]
                return (pts - T[:, None, :3, 3]) @ T[:, :3, :3]

            mov, fix = in_kf_frame(qr, q_rows), in_kf_frame(rr, r_rows)
        else:
            mov = np.zeros((B, cap, 3), np.float32)
            fix = np.zeros((B, cap, 3), np.float32)
            for i, c in enumerate(candidates):
                mov[i, :c.n] = c.query.xyz_kf[c.q_rows[:c.n]]
                fix[i, :c.n] = c.reference.xyz_kf[c.r_rows[:c.n]]
            mov, fix = torch.from_numpy(mov).to(dev), torch.from_numpy(fix).to(dev)
        prog = icp_program(p, icp_bucket(B), dev)
        batch = ICPBatch(res_dev=prog.run(mov, fix, mask, torch.from_numpy(T0).to(dev)))
        return [ICPJob(query=c.query, reference=c.reference, q_rows=c.q_rows,
                       r_rows=c.r_rows, n=c.n, batch=batch, index=i)
                for i, c in enumerate(candidates)]

    @staticmethod
    def fetch(handles, batches) -> None:
        """Copy query results and ICP batch results (each batch once) to
        the host in one transfer."""
        batches = [b for b in dict.fromkeys(batches) if b.fetched is None]
        fields = [t for h in handles for t in (h.idx_dev, h.ok_dev)]
        fields += [t for b in batches for t in (b.res_dev.x, b.res_dev.num_inliers,
                                                b.res_dev.converged, b.res_dev.chi2)]
        if not fields:
            return
        host = _fetch(fields)
        for k, h in enumerate(handles):
            h.idx_dev, h.ok_dev = host[2 * k], host[2 * k + 1]
        base = 2 * len(handles)
        for k, b in enumerate(batches):
            b.fetched = tuple(host[base + 4 * k:base + 4 * k + 4])

    @classmethod
    def job_result(cls, job: ICPJob) -> ICPVerdict:
        """Host result of one ICP job (fetches its batch on first use)."""
        cls.fetch([], [job.batch])
        x, n_inl, conv, chi2 = job.batch.fetched
        i = job.index
        return ICPVerdict(x=x[i].astype(np.float32), num_inliers=int(n_inl[i]),
                          converged=bool(conv[i]), chi2=float(chi2[i]))

    def finish_icp(self, job: ICPJob, res: ICPVerdict) -> Closure | None:
        """Gate a fetched ICP result (xyz_aligner.cpp:106-177) and emit
        the Closure."""
        p = self.params
        lm, ref = job.query, job.reference
        inlier_ratio = res.num_inliers / max(job.n, 1)
        if (not res.converged or res.num_inliers < p.icp_minimum_number_of_inliers
                or inlier_ratio < p.icp_minimum_inlier_ratio):
            log.debug(f"closure candidate {ref.map_id}<-{lm.map_id}: ICP rejected "
                      f"(converged={res.converged}, inliers={res.num_inliers}/{job.n}, "
                      f"chi2={res.chi2:.3f})")
            return None
        q_slots = np.asarray(lm.landmark_slots)[job.q_rows]
        r_slots = np.asarray(ref.landmark_slots)[job.r_rows]
        keep = q_slots != r_slots  # identical slots merge to a no-op
        return Closure(
            query_id=lm.map_id,
            reference_id=ref.map_id,
            T_ref_query=res.x,
            n_correspondences=job.n,
            inlier_ratio=inlier_ratio,
            correspondences=np.stack([q_slots[keep], r_slots[keep]], axis=1).astype(np.int32),
        )

    def resolve(self, handle: QueryHandle | None) -> Closure | None:
        """Synchronous resolve of one query: fetch, vote, verify."""
        if handle is None:
            return None
        if isinstance(handle.idx_dev, torch.Tensor):
            self.fetch([handle], [])
        jobs = self.dispatch_icp_batch([self.vote(handle)])
        if not jobs:
            return None
        return self.finish_icp(jobs[0], self.job_result(jobs[0]))

    def detect_and_verify(self, query: LocalMap) -> Closure | None:
        """Synchronous query that does not insert `query` (tests)."""
        p = self.params
        if self.n_rows == 0 or len(query.landmark_slots) == 0:
            return None
        max_map_id = query.map_id - p.preliminary_minimum_interspace_queries
        if max_map_id < 0:
            return None
        CAP = self.QUERY_CAP
        nq = min(len(query.landmark_slots), CAP)
        if query.desc is None:
            q_desc = query.desc_dev
        else:
            block = np.zeros((CAP, 8), np.int32)
            block[:nq] = np.asarray(query.desc[:nq]).view(np.int32)
            q_desc = torch.from_numpy(block).to(self.device)
        none = torch.full((CAP,), -1, dtype=torch.int32, device=self.device)
        best, ok, _, _ = self._query_and_insert(
            q_desc[None], none, none,
            torch.tensor([max_map_id], dtype=torch.int32, device=self.device),
            self._active_prefix())
        return self.resolve(QueryHandle(query=query, nq=nq, idx_dev=best[0], ok_dev=ok[0]))

    def apply_remap(self, remap: dict[int, int], lut=None) -> None:
        """Follow landmark merges: database rows of an absorbed slot now
        name its representative (reference LocalMap::replace,
        local_map.cpp:109-127).  lut: optional slot lookup table."""
        if not remap or self.n_rows == 0:
            return
        rows = self.row_slot[:self.n_rows]
        if lut is not None and len(lut) > int(rows.max(initial=0)):
            valid = rows >= 0
            rows[valid] = lut[rows[valid]]
        else:
            for src, dst in remap.items():
                rows[rows == src] = dst
        for src, dst in remap.items():
            if src in self._slot_in_db:
                self._slot_in_db.discard(src)
                self._slot_in_db.add(dst)
            if src in self._slot_maps:
                dst_maps = self._slot_maps.setdefault(dst, [])
                dst_maps.extend(m for m in self._slot_maps.pop(src) if m not in dst_maps)
        self._map_slot_row.clear()
