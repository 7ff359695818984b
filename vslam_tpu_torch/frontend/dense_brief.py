"""Dense BRIEF-256 bit planes: kernels K2, K3 and K4 (one CUDA source,
csrc/dense_brief.cu) and their plain-torch version.

For every pixel x of an already smoothed image S (read as 0.0 outside
its bounds), bit j of word w is [ S(x + o1_b) < S(x + o2_b) ] with
b = 32 w + j; the words are int32 (the bits of the JAX package's uint32
words) in layout (B, 8, H, W).  The offset pairs come from one of 17
pattern tables: TABLES[0] is the upright BRIEF pattern (brief._PAT),
TABLES[1 + k] the pattern rotated into orientation bank k
(brief._ROT_PATS[k]).

Port of vslam_tpu/frontend/pallas_brief.py.  Three thin wrappers stand
for its three TPU functions and count their own launches:
  dense_bit_planes_batch    K2  (B, H, W) stack, upright pattern
  dense_bit_planes          K3  one (H, W) image, upright pattern
  dense_bit_planes_pattern  K4  one (H, W) image, rotated bank
A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(there is no fallback between the two).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from vslam_tpu_torch.frontend.cuda_build import CudaLibrary
from vslam_tpu_torch.frontend.fast_brief import PATTERN, pack_brief_words
from vslam_tpu_torch.frontend.orb import PATTERN_RADIUS, _make_pattern

N_ROT_BANKS = 16
BAND = 8  # rows per block on the main path (the TPU kernels' band)
BANDS = (8, 16, 32, 64)  # the row bands the CUDA source is built for


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


def dense_bit_planes_reference(smooth: torch.Tensor, table: int = 0) -> torch.Tensor:
    """Plain version: (B, H, W) smoothed stack -> (B, 8, H, W) int32 planes
    under pattern table `table`, by 256 shifted compares of the
    zero-padded stack.  A bf16 stack is compared as its f32 values."""
    B, H, W = smooth.shape
    R = PATTERN_RADIUS
    padded = torch.nn.functional.pad(smooth.float(), (R, R, R, R))
    return pack_brief_words(padded, TABLES[table], H, W)


# ---------------------------------------------------------------------------
# CUDA kernel: build at first use, bind through ctypes
# ---------------------------------------------------------------------------


@dataclass
class EntryPoint:
    """One wrapper of the kernel: `launches` goes up by one each time the
    wrapper launches the CUDA kernel, and nowhere else."""

    name: str
    replaces: str
    launches: int = 0


K2 = EntryPoint("dense_bit_planes_batch", "vslam_tpu/frontend/pallas_brief.py:176")
K3 = EntryPoint("dense_bit_planes", "vslam_tpu/frontend/pallas_brief.py:78")
K4 = EntryPoint("dense_bit_planes_pattern", "vslam_tpu/frontend/pallas_brief.py:116")


class DenseBriefKernel:
    """The built dense-BRIEF library, shared by K2, K3 and K4."""

    def __init__(self):
        self.library = CudaLibrary("dense_brief.cu")
        self._tables_on = set()  # device indices holding the pattern tables

    def build(self):
        """Compile the kernel with nvcc (once per source version) and load it."""
        lib = self.library.load()
        lib.dense_brief_set_patterns.restype = ctypes.c_int
        lib.dense_brief_set_patterns.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                                 ctypes.c_int]
        lib.dense_brief_launch.restype = ctypes.c_int
        lib.dense_brief_launch.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                                           + [ctypes.c_void_p] * 2 + [ctypes.c_int])
        return lib

    def launch(self, smooth: torch.Tensor, table: int, band: int = BAND) -> torch.Tensor:
        """(B, H, W) contiguous f32 (or bf16) CUDA stack -> (B, 8, H, W) int32."""
        if smooth.dim() != 3 or smooth.dtype not in (torch.float32, torch.bfloat16) \
                or not smooth.is_contiguous() or min(smooth.shape) == 0:
            raise ValueError("dense BRIEF: smooth must be a non-empty contiguous "
                             "(B, H, W) float32 or bfloat16 tensor")
        if not 0 <= table < len(TABLES) or band not in BANDS:
            raise ValueError(f"dense BRIEF: table {table}, band {band}")
        lib = self.build()
        dev = smooth.device
        if dev.index not in self._tables_on:
            host = np.ascontiguousarray(TABLES.reshape(len(TABLES), 256, 4).astype(np.int8))
            err = lib.dense_brief_set_patterns(host.ctypes.data, len(TABLES), dev.index)
            if err != 0:
                raise RuntimeError(f"dense BRIEF pattern upload failed: cudaError {err}")
            self._tables_on.add(dev.index)
        B, H, W = smooth.shape
        planes = torch.empty((B, 8, H, W), dtype=torch.int32, device=dev)
        err = lib.dense_brief_launch(
            smooth.data_ptr(), int(smooth.dtype == torch.bfloat16), B, H, W, table,
            band, planes.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            dev.index,
        )
        if err != 0:
            raise RuntimeError(f"dense BRIEF launch failed: cudaError {err}")
        return planes


KERNEL = DenseBriefKernel()


def _planes(entry: EntryPoint, smooth: torch.Tensor, table: int) -> torch.Tensor:
    if smooth.device.type == "cuda":
        planes = KERNEL.launch(smooth.to(torch.float32).contiguous(), table)
        entry.launches += 1
        return planes
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
