"""The staged front end's FAST detector kernel
(vslam_tpu_torch/csrc/fast_cells.cu, fast_cells_kernel): for every image
of a (B, H, W) f32 stack at one pyramid level, the FAST score, 3x3 NMS,
the border mask and the per-cell (max, first index) over a bin_size grid.
The staged front end launches it once a pyramid level over a stereo
frame's pair (mapping/frame.py: a level is the 2x2 average of the one
above, (H // 2, W // 2)).

Bytes: each input read once, each output written once -- the f32 pixel
(4) and the cell's f32 score and int32 index (8).  f32 operations a
pixel: the 16 ring taps x 8 (two compares, two differences, two clamps,
two sums) and NMS's 8 compares.  The operations bound it: 1.89 us at
(2, 376, 1241), 0.47 us at (2, 188, 620).
"""

from perfbench import peaks

SYMBOL = "fast_cells_kernel"
OPS_PER_PIXEL = 16 * 8 + 8
# The configuration's key that holds the cell size.
BIN_KEY = "base_framepoint_generation.bin_size_pixels"


def work(B: int, H: int, W: int, bin_size: int) -> tuple[int, int]:
    """(bytes, f32 operations) one launch over a (B, H, W) stack needs."""
    px = B * H * W
    cells = B * (H // bin_size) * (W // bin_size)
    return 4 * px + 8 * cells, OPS_PER_PIXEL * px


def least_seconds(B: int, H: int, W: int, bin_size: int) -> float:
    nbytes, ops = work(B, H, W, bin_size)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_OPS_PER_S)


def frame_launches(H: int, W: int, octaves: int) -> list[tuple[int, int, int]]:
    """The (B, H, W) of each launch a stereo frame makes on the staged
    route at `octaves` pyramid levels: one over the pair a level."""
    out, h, w = [], H, W
    for _ in range(octaves):
        out.append((2, h, w))
        h, w = h // 2, w // 2
    return out
