"""The dense BRIEF kernel (vslam_tpu_torch/csrc/dense_brief.cu,
dense_brief_kernel): the 8 int32 BRIEF-256 bit planes of every pixel of
a blurred (B, H, W) f32 stack.  The staged front end launches it as K2
over a frame's stereo pair at full size and as K3 over each image of
every pyramid level below (mapping/frame.py: a level is the 2x2 average
of the one above, (H // 2, W // 2)).  Frozen from the port's
frontend/kernel_timing.dense_work.

Bytes: each input read once, each output written once -- the f32 pixel
(4) and its 8 int32 planes (32).  f32 operations a pixel: the 256
compares.  The bytes bound it: 0.0100 ms for K2 at (2, 376, 1241),
0.00125 ms for K3 at (1, 188, 620).
"""

from perfbench import peaks

SYMBOL = "dense_brief_kernel"
OPS_PER_PIXEL = 256


def work(B: int, H: int, W: int) -> tuple[int, int]:
    """(bytes, f32 operations) one launch over a (B, H, W) stack needs."""
    px = B * H * W
    return (4 + 4 * 8) * px, OPS_PER_PIXEL * px


def least_seconds(B: int, H: int, W: int) -> float:
    nbytes, ops = work(B, H, W)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_OPS_PER_S)


def frame_launches(H: int, W: int, octaves: int) -> list[tuple[int, int, int]]:
    """The (B, H, W) of each launch a stereo frame makes on the staged
    route at `octaves` pyramid levels: K2 over the pair, then K3 over the
    left and the right image of each level below."""
    out = [(2, H, W)]
    h, w = H, W
    for _ in range(1, octaves):
        h, w = h // 2, w // 2
        out += [(1, h, w), (1, h, w)]
    return out
