"""Row-sharded loop-closure descriptor search (port of
vslam_tpu/parallel/sharded_search.py).

Each rank holds one contiguous block of the database rows, computes its
slice of the Hamming matrix and its local first-index minimum, and one
all_reduce(MIN) of the packed int32 (min(d, 511) << 22) | global_idx
combines the winners: the lexicographic (distance, index) minimum, so the
result is a brute-force search's first-index arg-min, exactly.
Distances are <= 256 and a masked pair counts 512, clamped to 511 (9
bits); shift 22 is the largest that keeps 511 << 22 | idx in int32
(databases up to 2^22 rows).  Communication is O(Q) integers, whatever
the database size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vslam_tpu_torch.ops import hamming
from vslam_tpu_torch.parallel import mesh as mesh_mod

IDX_BITS = 22
MAX_ROWS = 1 << IDX_BITS
SENTINEL = 511  # a masked-out pair, after the clamp


def _local_min(query, db_shard, valid_shard):
    """(Q, D_s) masked distances, local (best <= 511, first index)."""
    dist_m = hamming._masked(hamming.hamming_matrix_bits(query, db_shard),
                             valid_shard.expand(query.shape[0], db_shard.shape[0]))
    best, idx = hamming._min_first(dist_m, 1)
    return dist_m, torch.clamp(best, max=SENTINEL), idx


def _combine(d, global_idx, mesh):
    packed = mesh_mod.all_reduce((d << IDX_BITS) | global_idx, dist.ReduceOp.MIN, mesh)
    return packed & (MAX_ROWS - 1), packed >> IDX_BITS


def search_sharded(query: torch.Tensor, db_shard: torch.Tensor, valid_shard: torch.Tensor,
                   mesh: mesh_mod.Mesh):
    """Global nearest database row per query.

    query: (Q, 8) int32, the same on every rank; db_shard: (D_s, 8) this
    rank's block (mesh_mod.shard_rows of the (D, 8) database);
    valid_shard: (D_s,) or (Q, D_s) bool.  Returns (best_idx (Q,) int32
    into the whole database, best_dist (Q,) int32; 511 where every row
    is masked)."""
    if db_shard.shape[0] * mesh.size > MAX_ROWS:
        raise ValueError(f"database of {db_shard.shape[0] * mesh.size} rows > {MAX_ROWS}")
    _, d1, l1 = _local_min(query, db_shard, valid_shard)
    return _combine(d1, l1 + mesh.rank * db_shard.shape[0], mesh)


def search_sharded_top2(query: torch.Tensor, db_shard: torch.Tensor,
                        valid_shard: torch.Tensor, mesh: mesh_mod.Mesh):
    """Global best and second-best distances per query (the relocalizer's
    margin test), as search_sharded plus a second MIN reduction over
    "my runner-up if my winner is the global winner, else my best".
    Returns (best_idx, best_dist, second_dist), each (Q,) int32."""
    if db_shard.shape[0] * mesh.size > MAX_ROWS:
        raise ValueError(f"database of {db_shard.shape[0] * mesh.size} rows > {MAX_ROWS}")
    dist_m, d1, l1 = _local_min(query, db_shard, valid_shard)
    cols = torch.arange(db_shard.shape[0], dtype=torch.int32, device=db_shard.device)
    d2 = torch.clamp(torch.where(cols[None, :] == l1[:, None], hamming._SENT, dist_m)
                     .amin(dim=1), max=SENTINEL)
    g1 = l1 + mesh.rank * db_shard.shape[0]
    best_idx, best_dist = _combine(d1, g1, mesh)
    alt = torch.where(g1 == best_idx, d2, d1)
    second = mesh_mod.all_reduce(alt, dist.ReduceOp.MIN, mesh)
    return best_idx, best_dist, second
