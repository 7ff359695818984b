"""Packed binary-descriptor algebra (port of vslam_tpu/ops/hamming.py).

Descriptors are 256-bit strings packed as 8 int32 words (the same bits as
the JAX package's uint32 words).  torch has no popcount, so distances use
a SWAR popcount on int32: every mask clears the bits an arithmetic right
shift smears in, so the signed shifts give the unsigned result.

`HAMMING_MATCH` is the matching kernel (csrc/hamming_match.cu) that
frontend/matching.py's match_stereo and match_projective launch on CUDA
tensors: popcount distances, the geometric gate, both first-argmins and
the mutual check in two launches a call, bit-equal to hamming_matrix +
mutual_best_match, which CPU tensors run.
"""

from __future__ import annotations

import math
import numbers

import numpy as np
import torch

from vslam_tpu_torch.ops.cuda_build import CudaKernel

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


def _f32(x) -> float:
    """A Python number as torch compares it with an f32 tensor: rounded to
    f32 (inf past its range)."""
    with np.errstate(over="ignore"):
        return float(np.float32(x))


class HammingMatchKernel(CudaKernel):
    """match_stereo / match_projective on the card, csrc/hamming_match.cu:
    a tiles launch and a resolve launch a call.  Gates given as tensors
    (f32; the distance gate int32) hold one value or one a problem and
    are read on the device at each launch, so a captured graph reads them
    at replay; gates given as Python numbers are passed by value."""

    STEREO, PROJECTIVE = 0, 1
    TILE_Q = TILE_D = 64  # csrc/hamming_match.cu's TQ, TD
    MAX_SIDE = 1 << 21  # the index bits of a packed key

    def __init__(self):
        super().__init__("hamming_match", "hamming_match.cu", "hamming_match",
                         "iiiipiipiipipiipip" + "pif" * 4 + "pippp", "i")

    @staticmethod
    def _gate(x, A: int, dev, dtype, name: str):
        """(pointer, stride, value) of a gate: a tensor of `dtype` on `dev`
        with one value, or one for each of the A problems; or a number."""
        if isinstance(x, torch.Tensor):
            if x.device != dev or x.dtype != dtype or x.numel() != A \
                    or (A > 1 and not x.is_contiguous()):
                raise ValueError(f"hamming match: gate {name} must be a number or a "
                                 f"contiguous {dtype} tensor of {A} value(s) on {dev}")
            return x.data_ptr(), 0 if A == 1 else 1, 0.0
        if isinstance(x, bool) or not isinstance(x, numbers.Real):
            raise ValueError(f"hamming match: gate {name} must be a number or a tensor")
        if dtype == torch.int32 and isinstance(x, numbers.Integral):
            x = (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)  # torch's int32 wrap
        return 0, 0, _f32(x)

    def match(self, form: int, q_uv, q_desc, q_mask, d_uv, d_desc, d_mask, gates,
              max_distance):
        """(idx, valid, best) of mutual_best_match over the gated distances
        of q_desc (Q, 8) against d_desc (D, 8) for each of the leading
        problems of q_uv (..., Q, 2); q_mask is (..., Q) or (Q,).  gates:
        (g0, g1, g2), the kernel's float gates for `form`."""
        tensors = (q_uv, q_desc, q_mask, d_uv, d_desc, d_mask)
        dev = q_desc.device
        if dev.type != "cuda" or any(t.device != dev for t in tensors):
            raise ValueError(f"hamming match: every input on one CUDA device, got "
                             f"{[str(t.device) for t in tensors]}")
        return self._match(form, *tensors, gates, max_distance)

    def _match(self, form, q_uv, q_desc, q_mask, d_uv, d_desc, d_mask, gates, max_distance):
        """match() past its device check: the shape, dtype and layout
        checks, the outputs and the launch."""
        lead = tuple(q_uv.shape[:-2])
        A = math.prod(lead)
        Q, D = q_desc.shape[0], d_desc.shape[0]
        dev = q_desc.device
        for desc in (q_desc, d_desc):
            if desc.dtype != torch.int32 or desc.dim() != 2 or desc.shape[1] != DESC_WORDS:
                raise ValueError("hamming match: descriptors must be (N, 8) int32")
        if q_uv.dtype != torch.float32 or d_uv.dtype != torch.float32 \
                or q_uv.shape[-2:] != (Q, 2) or tuple(d_uv.shape) != (D, 2) \
                or q_uv.stride(-1) != 1 or d_uv.stride(-1) != 1:
            raise ValueError("hamming match: uv must be float32 (..., Q, 2) and (D, 2) "
                             "with contiguous (u, v) pairs")
        q_uv = q_uv.reshape((A, Q, 2))  # a view where the leading dims allow one
        if q_mask.shape not in ((Q,), lead + (Q,)) or tuple(d_mask.shape) != (D,):
            raise ValueError("hamming match: masks must be (..., Q) or (Q,), and (D,)")
        for mask in (q_mask, d_mask):
            if mask.dtype != torch.bool or not mask.is_contiguous():
                raise ValueError("hamming match: masks must be contiguous bool")
        if not (1 <= Q <= self.MAX_SIDE and 1 <= D <= self.MAX_SIDE):
            raise ValueError(f"hamming match: {Q} x {D} outside 1 .. {self.MAX_SIDE} a side")
        n_q, n_d = -(-Q // self.TILE_Q), -(-D // self.TILE_D)
        words = A * (n_d * Q + n_q * D)
        if words >= 1 << 31:
            raise ValueError(f"hamming match: {A} x {Q} x {D} over the partial buffer's size")
        g = [self._gate(x, A, dev, torch.float32, f"g{i}") for i, x in enumerate(gates)]
        h = self._gate(max_distance, A, dev, torch.int32, "max_distance")
        partial = torch.empty(words, dtype=torch.int32, device=dev)
        idx = torch.empty(lead + (Q,), dtype=torch.int32, device=dev)
        valid = torch.empty(lead + (Q,), dtype=torch.bool, device=dev)
        best = torch.empty(lead + (Q,), dtype=torch.int32, device=dev)
        self._launch(dev, A, form, A, Q, D, q_desc.data_ptr(), *q_desc.stride(),
                     q_uv.data_ptr(), q_uv.stride(0), q_uv.stride(1), q_mask.data_ptr(),
                     Q if q_mask.dim() > 1 else 0, d_desc.data_ptr(), *d_desc.stride(),
                     d_uv.data_ptr(), d_uv.stride(0), d_mask.data_ptr(),
                     *(v for gate in g for v in gate), *h,
                     partial.data_ptr(), words, idx.data_ptr(), valid.data_ptr(),
                     best.data_ptr())
        return idx, valid, best


HAMMING_MATCH = HammingMatchKernel()
