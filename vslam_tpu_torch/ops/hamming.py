"""Packed binary-descriptor algebra (port of vslam_tpu/ops/hamming.py).

Descriptors are 256-bit strings packed as 8 int32 words (the same bits as
the JAX package's uint32 words).  torch has no popcount, so distances use
a SWAR popcount on int32: every mask clears the bits an arithmetic right
shift smears in, so the signed shifts give the unsigned result.
"""

from __future__ import annotations

import torch

DESC_BITS = 256
DESC_WORDS = DESC_BITS // 32
BIG = 1 << 20  # sentinel distance for masked-out pairs
_SENT = 512  # > any Hamming distance: the value of a masked-out pair


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of int32 words (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0, 1} -> (N, 8) int32 words, little-endian bit order per
    word: the JAX package's uint32 words, bit 31 the sign.  The words are
    summed in int64, which shifts on every device, and wrapped to int32."""
    w = bits.to(torch.int64).reshape(bits.shape[0], DESC_WORDS, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (w << shifts).sum(dim=-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def hamming_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance between aligned rows: (N, 8), (N, 8) -> (N,) int32."""
    return popcount32(a ^ b).sum(dim=-1, dtype=torch.int32)


def hamming_matrix(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Full distance matrix (Q, 8) x (D, 8) -> (Q, D) int32."""
    return popcount32(q[:, None, :] ^ db[None, :, :]).sum(dim=-1, dtype=torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) uint8 in {0, 1}, little-endian bit
    order per word."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], DESC_BITS).to(torch.uint8)


def hamming_matrix_bits(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Distance matrix (Q, 8) x (D, 8) -> (Q, D) int32 as a matmul of bit
    matrices: d = popcount(a) + popcount(b) - 2 <bits_a, bits_b> (the
    JAX package's hamming_matrix_mxu).

    The product runs in f32, which is exact here: the operands are 0/1
    and every sum is at most 256 (TF32 is pinned off by the package).
    Memory is O(Q + D) bit rows plus the (Q, D) result, where
    hamming_matrix's broadcast holds (Q, D, 8) words."""
    return hamming_from_bits(*bit_rows(q), *bit_rows(db))


def bit_rows(x: torch.Tensor):
    """(N, 8) words -> ((N, 256) f32 bit rows, (N,) int32 popcounts): one
    side of hamming_matrix_bits, which a caller may reuse across blocks."""
    bits = unpack_bits(x).to(torch.float32)
    return bits, bits.sum(dim=1).to(torch.int32)


def hamming_from_bits(qb, rq, dbb, rdb) -> torch.Tensor:
    """hamming_matrix_bits from both sides' bit_rows."""
    inner = (qb @ dbb.T).to(torch.int32)
    return rq[:, None] + rdb[None, :] - 2 * inner


def _min_first(d: torch.Tensor, dim: int):
    """(min, index of its first occurrence) along `dim`."""
    best = d.amin(dim=dim, keepdim=True)
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.int32, device=d.device).view(shape)
    idx = torch.where(d == best, iota, n).amin(dim=dim)
    return best.squeeze(dim), idx


def _masked(dist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, torch.clamp(dist.to(torch.int32), max=_SENT), _SENT)


def masked_argmin(dist: torch.Tensor, mask: torch.Tensor, max_distance):
    """Per-row best match under a pair mask and a distance gate.

    Returns (best_idx (Q,), best_dist (Q,), valid (Q,)); invalid rows get
    idx 0 and dist BIG.  Ties resolve to the smallest index."""
    best, best_idx = _min_first(_masked(dist, mask), 1)
    valid = best <= max_distance
    return (torch.where(valid, best_idx, 0), torch.where(valid, best, BIG),
            valid)


def mutual_best_match(dist: torch.Tensor, mask: torch.Tensor, max_distance):
    """One-to-one assignment by mutual-best cross-check: q matches d iff
    each is the other's (first) argmin and the distance passes the gate.
    dist and mask broadcast to (..., Q, D) (leading dims: independent
    problems), max_distance a scalar or (..., 1).
    Returns (match_idx (..., Q), valid (..., Q), best_dist (..., Q))."""
    d = _masked(dist, mask)
    best, best_j = _min_first(d, -1)
    _, best_i = _min_first(d, -2)
    q_ids = torch.arange(d.shape[-2], dtype=torch.int32, device=d.device)
    mutual = torch.gather(best_i, -1, best_j.long()) == q_ids
    valid = mutual & (best <= max_distance)
    return best_j, valid, best
