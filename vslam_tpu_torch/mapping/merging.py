"""Landmark merging after loop closures (port of vslam_tpu/mapping/merging.py).

The reference splices framepoint chains and appearance maps
(WorldMap::mergeLandmarks + Landmark::merge, world_map.cpp:305-478,
landmark.cpp:169-265).  Over the columnar table the same operation is a
host-side union-find over slot ids and one batched device pass: each
representative absorbs its merged landmarks' information (H_acc and
n_updates summed, position information-weighted) and the absorbed slots
are invalidated and returned to the free stack.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from vslam_tpu_torch.mapping.landmarks import LandmarkTable


class UnionFind:
    def __init__(self):
        self.parent: dict[int, int] = {}

    def find(self, x: int) -> int:
        root = x
        while self.parent.setdefault(root, root) != root:
            root = self.parent[root]
        while x != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # The smaller (elder) slot is the representative, as the
            # reference keeps the elder landmark (world_map.cpp:420-436).
            ra, rb = min(ra, rb), max(ra, rb)
            self.parent[rb] = ra


def union_find(pairs: np.ndarray) -> dict[int, int]:
    """Absorbed slot -> representative over (N, 2) merge pairs (pairs with
    a negative or repeated slot are skipped), in ascending slot order —
    the JAX package's native union-find (utils/native.py) returns the
    same dict in the same order."""
    uf = UnionFind()
    for a, b in np.asarray(pairs, np.int64).reshape(-1, 2):
        if a >= 0 and b >= 0 and a != b:
            uf.union(int(a), int(b))
    remap = {}
    for x in sorted(uf.parent):
        r = uf.find(x)
        if r != x:
            remap[x] = r
    return remap


def _add_in_pair_order(rows: torch.Tensor, d: torch.Tensor, deltas: torch.Tensor,
                       rounds: int) -> torch.Tensor:
    """rows with each pair's delta (n, ...) added at its destination d
    (n,), the deltas of one destination in pair order, as the JAX
    package's .at[d].add sums them on the CPU.  Round r adds each
    destination's r-th pair (its rank among the earlier pairs of the same
    destination) and zeros from every other pair: a repeated index then
    adds only exact zeros besides its one delta, so the sum does not
    depend on the order a CUDA scatter takes.  `rounds` is at least the
    largest number of pairs of one destination."""
    same = d[:, None] == d[None, :]
    rank = torch.tril(same, diagonal=-1).sum(dim=1)
    shape = (-1,) + (1,) * (deltas.dim() - 1)
    for r in range(rounds):
        rows = rows.index_add(0, d, torch.where((rank == r).reshape(shape), deltas, 0.0))
    return rows


def _apply_merges(table: LandmarkTable, src: torch.Tensor, dst: torch.Tensor,
                  use: torch.Tensor, rounds: int | None = None) -> LandmarkTable:
    """Batched absorb: for each used (src -> dst) pair, dst takes src's
    information and src is invalidated.  A pair whose slot is no longer
    valid (recycled since the snapshot) is skipped.  Several sources may
    merge into one destination: the deltas add, as the JAX package's
    .at[].add/max/min do (the float sums in pair order,
    _add_in_pair_order, over `rounds` rounds: the most pairs of one
    destination, None for the number of pairs; the integer sums and the
    max/min by index_add and scatter_reduce, whose results do not depend
    on the order)."""
    rounds = len(src) if rounds is None else rounds
    s = torch.where(use, src, 0).to(torch.int64)
    d = torch.where(use, dst, 0).to(torch.int64)
    use = use & table.valid[s] & table.valid[d]
    w_src = table.n_updates[s].to(torch.float32)
    w_dst = table.n_updates[d].to(torch.float32)
    tot = torch.clamp(w_src + w_dst, min=1.0)
    xyz_d = table.xyz_w[d]
    merged = xyz_d * (w_dst / tot)[:, None] + table.xyz_w[s] * (w_src / tot)[:, None]
    xyz = _add_in_pair_order(table.xyz_w, d, torch.where(use[:, None], merged - xyz_d, 0.0),
                             rounds)
    H = _add_in_pair_order(table.H_acc, d, torch.where(use[:, None, None], table.H_acc[s], 0.0),
                           rounds)
    n = table.n_updates.index_add(
        0, d, torch.where(use, table.n_updates[s], 0).to(table.n_updates.dtype))
    last = table.last_seen.scatter_reduce(
        0, d, torch.where(use, table.last_seen[s], -1).to(table.last_seen.dtype), "amax")
    # The representative inherits the external references (local maps and
    # database rows are remapped on the host) and so their protection; the
    # absorbed slot loses both.
    prot = table.protected.to(torch.int32).scatter_reduce(
        0, d, (use & table.protected[s]).to(torch.int32), "amax")
    prot = prot.scatter_reduce(0, s, (~use).to(torch.int32), "amin") > 0
    absorbed = torch.zeros_like(table.n_updates).scatter_reduce(
        0, s, use.to(table.n_updates.dtype), "amax") > 0
    return table._replace(xyz_w=xyz, H_acc=H, n_updates=n, last_seen=last,
                          valid=table.valid & ~absorbed, protected=prot)


def merge_landmarks(table: LandmarkTable, allocator, correspondences: np.ndarray):
    """Merge corresponding landmark pairs; returns (table, remap) with
    remap the absorbed slot -> representative dict for the callers that
    hold slot references.  The absorbed slots go back to the allocator."""
    remap = union_find(correspondences)
    if not remap:
        return table, {}
    dev = table.xyz_w.device
    src = torch.tensor(list(remap.keys()), dtype=torch.int32, device=dev)
    dst = torch.tensor(list(remap.values()), dtype=torch.int32, device=dev)
    rounds = max(Counter(remap.values()).values())
    table = _apply_merges(table, src, dst, torch.ones_like(src, dtype=torch.bool), rounds)
    allocator.release(list(remap.keys()))
    return table, remap
