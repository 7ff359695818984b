"""Device times of the port's kernels and the bounds they are held to.

chip_smoke.py times every kernel with these helpers.

Bounds: the least time the card could take is the larger of the bytes
the function must move (each input read once, each output written once)
over the memory rate, and its f32 operations over the f32 rate (NVIDIA
H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s without tensor cores).  The
shared-load floor is the distinct pattern taps a pixel reads from shared
memory at one 32-lane load per SM and clock.
"""

from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations a pixel: 256 BRIEF compares; FAST's 16 ring taps x 8
# (two compares, two differences, two clamps, two sums) + 3; the blur's
# 4 adds, 4 FMAs (2 each) and 2 multiplies; NMS's 9 maxima and a compare.
K1_OPS_PER_PIXEL = 256 + 16 * 8 + 3 + 4 + 8 + 2 + 10
DENSE_OPS_PER_PIXEL = 256
# The staged detector's kernel (csrc/fast_cells.cu): FAST's 16 ring taps
# x 8 and NMS's 8 compares a pixel; its shared loads a pixel: the ring and
# the centre, and the 3x3 window.
FAST_CELLS_OPS_PER_PIXEL = 16 * 8 + 8
FAST_CELLS_TAPS = 17 + 9


def box_blur_work(B: int, H: int, W: int, radius: int) -> tuple[int, int]:
    """(bytes, f32 operations) the box blur kernel (csrc/box_blur.cu)
    needs for a (B, H, W) stack at `radius`: each f32 pixel read once and
    written once (8 bytes), 3k operations at k = 2r + 1 (k - 1 adds, k
    FMAs, one multiply)."""
    px = B * H * W
    return 8 * px, 3 * (2 * radius + 1) * px


def box_blur_taps(radius: int) -> float:
    """Shared loads an output pixel of the box blur kernel's design at
    `radius`, for its shared-load floor: the vertical pass sums k words
    for each of a 128-column tile's 128 + 2r halo-wide columns, and the
    FMA chain reads k."""
    k = 2 * radius + 1
    return k * (128 + 2 * radius) / 128 + k


# Integer popcounts (__popc) an SM issues a clock on sm_90 (the CUDA C++
# Programming Guide's arithmetic instruction throughput).
POPC_PER_SM_CLOCK = 16


def hamming_match_work(Q: int, D: int, A: int = 1) -> tuple[int, int]:
    """(bytes, popcounts) one call of the matching kernel
    (csrc/hamming_match.cu) needs for Q query rows against D database
    columns, A problems: both descriptor sets (32 bytes a row), uv (8) and
    masks (1) read once, each problem's query uv and mask too, and the
    three outputs (9 bytes a row a problem) written once; 8 popcounts a
    pair, computed once for every problem."""
    return 41 * (Q + D) + 9 * (A - 1) * Q + 9 * A * Q, 8 * Q * D


def hamming_match_bound(Q: int, D: int, A: int = 1, sms: int = 132,
                        clock_hz: float = 1.98e9) -> tuple[float, str]:
    """(least time in ms, "bytes" or "popcounts": which sets it) of one
    matching call: its bytes over the memory rate, or its popcounts at
    POPC_PER_SM_CLOCK on each of `sms` SMs at `clock_hz`."""
    nbytes, popc = hamming_match_work(Q, D, A)
    t_bytes, t_popc = nbytes / HBM_BYTES_PER_S, popc / (POPC_PER_SM_CLOCK * sms * clock_hz)
    return 1e3 * max(t_bytes, t_popc), "bytes" if t_bytes >= t_popc else "popcounts"


def cuda_ms(fn, runs: int = 20, setup=None) -> float:
    """Median device time of fn() in ms, after a warm-up: CUDA events
    around fn alone.  Before each timed call the card spins for ~0.1 ms,
    so fn's kernels are queued before its start event fires and the time
    is the card's, not the host's enqueue; `setup` runs before the spin
    (an L2 flush)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if setup is not None:
            setup()
        torch.cuda._sleep(200_000)  # GPU clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def l2_flush(device, mib: int = 128):
    """A callable that writes `mib` MiB (over twice the H100's 50 MB L2),
    so the next kernel finds its inputs in HBM."""
    scratch = torch.empty(mib << 18, dtype=torch.float32, device=device)
    return lambda: scratch.fill_(1.0)


def k1_work(B: int, H: int, W: int) -> tuple[int, int]:
    """(bytes, f32 operations) K1 needs for a (B, H, W) stack."""
    n_bands, Wo = -(-H // 16), -(-W // 128) * 128
    px = B * H * W
    nbytes = 4 * px + 4 + 4 * 8 * px + 4 * px + 2 * 4 * B * n_bands * Wo
    return nbytes, K1_OPS_PER_PIXEL * px


def dense_work(B: int, H: int, W: int, itemsize: int = 4) -> tuple[int, int]:
    """(bytes, f32 operations) the dense kernel needs for a (B, H, W) stack."""
    px = B * H * W
    return itemsize * px + 4 * 8 * px, DENSE_OPS_PER_PIXEL * px


def fast_cells_work(B: int, H: int, W: int, bin_size: int) -> tuple[int, int]:
    """(bytes, f32 operations) the staged detector's kernel needs for a
    (B, H, W) stack: each pixel read once, each cell's score and index
    written once."""
    px = B * H * W
    return 4 * px + 8 * B * (H // bin_size) * (W // bin_size), FAST_CELLS_OPS_PER_PIXEL * px


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations": which sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def distinct_taps(pattern: np.ndarray) -> int:
    """Distinct (dr, dc) points of a (256, 2, 2) pattern."""
    return len({tuple(p) for p in np.asarray(pattern).reshape(-1, 2)})


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def smem_floor_ms(pixels: int, taps: int, device=0) -> float:
    """Shared-load floor: `taps` 4-byte loads a pixel at 32 lanes per SM
    and clock on every SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 1e3 * pixels * taps / (sms * 32 * sm_clock_hz())
