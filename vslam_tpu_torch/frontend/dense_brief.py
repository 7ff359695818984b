"""Dense BRIEF-256 bit planes: kernels K2, K3 and K4 (one CUDA source,
csrc/dense_brief.cu) and their plain-torch version.

For every pixel x of an already smoothed image S (read as 0.0 outside
its bounds), bit j of word w is [ S(x + o1_b) < S(x + o2_b) ] with
b = 32 w + j; the words are int32 (the bits of the JAX package's uint32
words) in layout (B, 8, H, W).  The offset pairs come from one of 17
pattern tables: TABLES[0] is the upright BRIEF pattern (brief._PAT),
TABLES[1 + k] the pattern rotated into orientation bank k
(brief._ROT_PATS[k]).  The CUDA source reads the tables as compile-time
constants from csrc/brief_patterns.cuh, which `write_pattern_header`
generates from TABLES.

Port of vslam_tpu/frontend/pallas_brief.py.  Three thin wrappers stand
for its three TPU functions and count their own launches:
  dense_bit_planes_batch    K2  (B, H, W) stack, upright pattern
  dense_bit_planes          K3  one (H, W) image, upright pattern
  dense_bit_planes_pattern  K4  one (H, W) image, rotated bank
A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(there is no fallback between the two).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from vslam_tpu_torch.frontend.fast_brief import PATTERN, pack_brief_words
from vslam_tpu_torch.frontend.orb import PATTERN_RADIUS, _make_pattern
from vslam_tpu_torch.ops.cuda_build import CSRC, CudaKernel

N_ROT_BANKS = 16
BAND = 8  # rows per tile on the main path (the TPU kernels' band); all tables
BANDS = (8, 16, 32, 64)  # the row bands the CUDA source is built for (table 0)


def _rotated_int_patterns(n_banks: int = N_ROT_BANKS) -> np.ndarray:
    """(B, 256, 2, 2) integer offsets: the seeded BRIEF pattern rotated by
    each bank angle (the JAX package's brief._rotated_int_patterns)."""
    raw = _make_pattern()  # float (256, 2, 2) [(dr, dc)]
    out = np.zeros((n_banks, 256, 2, 2), np.int32)
    for b in range(n_banks):
        th = 2.0 * np.pi * b / n_banks
        ct, st = np.cos(th), np.sin(th)
        dr, dc = raw[:, :, 0], raw[:, :, 1]
        dr_r = st * dc + ct * dr
        dc_r = ct * dc - st * dr
        out[b] = np.clip(
            np.round(np.stack([dr_r, dc_r], axis=-1)),
            -PATTERN_RADIUS, PATTERN_RADIUS,
        ).astype(np.int32)
    return out


ROT_PATS = _rotated_int_patterns()
TABLES = np.concatenate([PATTERN[None], ROT_PATS])  # (17, 256, 2, 2) int32
HEADER = CSRC / "brief_patterns.cuh"


def bit_order(pattern: np.ndarray) -> list[int]:
    """An order of the 256 compares of `pattern` (256, 2, 2) in which
    compares sharing a tap follow each other: greedily the next compare
    is the one with most taps already loaded and still needed, then the
    one whose taps have no other compare left.  A kernel that loads each
    distinct tap at its first compare then holds few taps at once
    (`live_taps`)."""
    pairs = [tuple(map(tuple, p)) for p in pattern]
    uses: dict = {}
    for b, pq in enumerate(pairs):
        for x in pq:
            uses.setdefault(x, set()).add(b)
    remaining, order, open_taps = set(range(len(pairs))), [], set()

    def rank(b):
        pq = set(pairs[b])
        closing = sum(len(uses[x] & remaining) == 1 for x in pq)
        return (sum(x in open_taps for x in pairs[b]), closing, -b)

    while remaining:
        b = max(remaining, key=rank)
        order.append(b)
        remaining.discard(b)
        for x in pairs[b]:
            (open_taps.add if uses[x] & remaining else open_taps.discard)(x)
    return order


def live_taps(pattern: np.ndarray, order) -> int:
    """The most distinct taps held at once when the compares run in
    `order` and each tap lives from its first compare to its last."""
    first, last = {}, {}
    for k, b in enumerate(order):
        for x in map(tuple, pattern[b]):
            first.setdefault(x, k)
            last[x] = k
    events = np.zeros(len(order) + 1, np.int64)
    for x in first:
        events[first[x]] += 1
        events[last[x] + 1] -= 1
    return int(np.cumsum(events).max())


def pattern_header() -> str:
    """The text of csrc/brief_patterns.cuh: TABLES and each table's
    bit_order as compile-time constants."""
    out = [
        "// BRIEF-256 pattern tables of the port's CUDA kernels as compile-time",
        "// constants.  Generated from vslam_tpu_torch/frontend/dense_brief.py",
        "// (TABLES, bit_order) by dense_brief.write_pattern_header(); do not edit.",
        "//   kBriefPattern[t][b] = {dr1, dc1, dr2, dc2}: bit b (bit b % 32 of word",
        "//     b / 32) compares S(x + (dr1, dc1)) < S(x + (dr2, dc2)).  Table 0 is",
        "//     the upright pattern (brief._PAT), table 1 + k the rotated bank k.",
        "//   kBriefOrder[t][k]: the bit computed k-th, an order in which compares",
        "//     that share a tap follow each other.",
        "#pragma once",
        "",
        "namespace brief {",
        "",
        f"constexpr int kTables = {len(TABLES)};",
        "",
        f"constexpr signed char kBriefPattern[{len(TABLES)}][256][4] = {{",
    ]
    for t, table in enumerate(TABLES):
        out.append(f"  {{  // table {t}")
        quads = [("{%d, %d, %d, %d}" % tuple(q)) for q in table.reshape(256, 4)]
        out += ["    " + ", ".join(quads[i:i + 6]) + "," for i in range(0, 256, 6)]
        out.append("  },")
    out += ["};", "", f"constexpr unsigned char kBriefOrder[{len(TABLES)}][256] = {{"]
    for t, table in enumerate(TABLES):
        order = [str(b) for b in bit_order(table)]
        out.append(f"  {{  // table {t}")
        out += ["    " + ", ".join(order[i:i + 16]) + "," for i in range(0, 256, 16)]
        out.append("  },")
    out += ["};", "", "}  // namespace brief", ""]
    return "\n".join(out)


def write_pattern_header(path=HEADER) -> None:
    """Regenerate csrc/brief_patterns.cuh (after a change to the tables)."""
    Path(path).write_text(pattern_header())


def dense_bit_planes_reference(smooth: torch.Tensor, table: int = 0) -> torch.Tensor:
    """Plain version: (B, H, W) smoothed stack -> (B, 8, H, W) int32 planes
    under pattern table `table`, by 256 shifted compares of the
    zero-padded stack.  A bf16 stack is compared as its f32 values."""
    B, H, W = smooth.shape
    R = PATTERN_RADIUS
    padded = torch.nn.functional.pad(smooth.float(), (R, R, R, R))
    return pack_brief_words(padded, TABLES[table], H, W)


# ---------------------------------------------------------------------------
# CUDA kernel (ops/cuda_build.CudaKernel)
# ---------------------------------------------------------------------------


class DenseBriefKernel(CudaKernel):
    """One entry of csrc/dense_brief.cu; K2, K3 and K4 share its build.

    Every table is built for the main band BAND in float32; the probe's
    other bands and bfloat16 input are built for table 0 only."""

    def __init__(self, name: str):
        super().__init__(name, "dense_brief.cu", "dense_brief", "piiiiiip", "iii")

    @staticmethod
    def sass_name(table: int = 0, band: int = BAND, dtype=torch.float32) -> str:
        """A substring of the mangled name of one instantiation's kernel."""
        t = "f" if dtype == torch.float32 else "13__nv_bfloat16"
        return f"dense_brief_kernelILi{band}E{t}Li{table}EE"

    @staticmethod
    def _check(table: int, band: int, dtype) -> None:
        if dtype not in (torch.float32, torch.bfloat16) or band not in BANDS \
                or not 0 <= table < len(TABLES) \
                or (table != 0 and (band != BAND or dtype != torch.float32)):
            raise ValueError(f"dense BRIEF: no kernel for table {table}, band {band}, "
                             f"{dtype} (every table at band {BAND} in float32; other "
                             "bands and bfloat16 at table 0)")

    def blocks_per_sm(self, device: torch.device, table: int = 0, band: int = BAND,
                      dtype=torch.float32) -> int:
        """Resident blocks of one instantiation on one SM of `device`."""
        self._check(table, band, dtype)
        return super().blocks_per_sm(device, int(dtype == torch.bfloat16), band, table)

    def launch(self, smooth: torch.Tensor, table: int, band: int = BAND) -> torch.Tensor:
        """(B, H, W) contiguous f32 (or bf16) CUDA stack -> (B, 8, H, W) int32."""
        if smooth.dim() != 3 or not smooth.is_contiguous() or min(smooth.shape) == 0:
            raise ValueError("dense BRIEF: smooth must be a non-empty contiguous "
                             "(B, H, W) float32 or bfloat16 tensor")
        self._check(table, band, smooth.dtype)
        dev = smooth.device
        B, H, W = smooth.shape
        planes = torch.empty((B, 8, H, W), dtype=torch.int32, device=dev)
        self._launch(dev, B, smooth.data_ptr(), int(smooth.dtype == torch.bfloat16), B, H, W,
                     table, band, planes.data_ptr())
        return planes


# The three TPU functions each wrapper stands for (module docstring).
K2 = DenseBriefKernel("K2")  # vslam_tpu/frontend/pallas_brief.py:176
K3 = DenseBriefKernel("K3")  # vslam_tpu/frontend/pallas_brief.py:78
K4 = DenseBriefKernel("K4")  # vslam_tpu/frontend/pallas_brief.py:116
# The library's handle for a direct launch at any table and band (the
# probes'); such a launch counts as K2's.
KERNEL = K2


def _planes(entry: DenseBriefKernel, smooth: torch.Tensor, table: int) -> torch.Tensor:
    if smooth.device.type == "cuda":
        return entry.launch(smooth.to(torch.float32).contiguous(), table)
    if smooth.device.type != "cpu":
        raise ValueError(f"dense BRIEF: unsupported device {smooth.device}")
    return dense_bit_planes_reference(smooth.to(torch.float32), table)


def dense_bit_planes_batch(smooth: torch.Tensor) -> torch.Tensor:
    """K2: (B, H, W) smoothed stack -> (B, 8, H, W) int32 upright planes."""
    return _planes(K2, smooth, 0)


def dense_bit_planes(smooth: torch.Tensor) -> torch.Tensor:
    """K3: (H, W) smoothed image -> (8, H, W) int32 upright planes."""
    return _planes(K3, smooth[None], 0)[0]


def dense_bit_planes_pattern(smooth: torch.Tensor, bank: int) -> torch.Tensor:
    """K4: (H, W) smoothed image -> (8, H, W) int32 planes under rotation
    bank `bank` (0..15)."""
    if not 0 <= bank < N_ROT_BANKS:
        raise ValueError(f"rotation bank {bank} outside 0..{N_ROT_BANKS - 1}")
    return _planes(K4, smooth[None], 1 + bank)[0]

