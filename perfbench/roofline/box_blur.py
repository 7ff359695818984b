"""The box blur kernel (vslam_tpu_torch/csrc/box_blur.cu, box_blur_kernel):
the separable (2r+1)^2 box blur, edge-replicated and normalized, of every
image of a (B, H, W) f32 stack, in XLA-CPU's FMA chain.  The staged front
end launches it (frontend/brief.py, mapping/frame.py; a pyramid level is
the 2x2 average of the one above, (H // 2, W // 2)):
  BRIEF256  at radius 2 over the frame's pair at level 0 (K2's input),
            then over each image of every level below (K3's);
  BRIEF256R at radius 2 over the pair (recovery's K2 planes), then for
            each image at radius 2 over the image (the rotated banks'
            input) and at radius 7 over its two gradients (the
            orientation map).

Bytes: each input read once, each output written once -- the f32 pixel
in and the f32 pixel out (8).  f32 operations a pixel: 3k at k = 2r + 1
(k - 1 adds, k FMAs of two, one multiply).  The bytes bound it at every
radius it runs: 1.72 us for a (2, 480, 752) launch, 2.79 us a KITTI frame,
6.90 us a EuRoC frame.
"""

from perfbench import peaks

SYMBOL = "box_blur_kernel"
BYTES_PER_PIXEL = 8
# The configuration's key that names the descriptor.
DESCRIPTOR_KEY = "base_framepoint_generation.descriptor_type"


def ops_per_pixel(radius: int) -> int:
    return 3 * (2 * radius + 1)


def work(B: int, H: int, W: int, radius: int) -> tuple[int, int]:
    """(bytes, f32 operations) one launch over a (B, H, W) stack needs."""
    px = B * H * W
    return BYTES_PER_PIXEL * px, ops_per_pixel(radius) * px


def least_seconds(B: int, H: int, W: int, radius: int) -> float:
    nbytes, ops = work(B, H, W, radius)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_OPS_PER_S)


def frame_launches(H: int, W: int, octaves: int,
                   descriptor: str) -> list[tuple[int, int, int, int]]:
    """The (B, H, W, radius) of each launch a stereo frame makes on the
    staged route with `descriptor` at `octaves` pyramid levels, or [] for
    a descriptor whose route is not counted here."""
    if descriptor == "BRIEF256":
        out, h, w = [(2, H, W, 2)], H, W
        for _ in range(1, octaves):
            h, w = h // 2, w // 2
            out += [(1, h, w, 2), (1, h, w, 2)]
        return out
    if descriptor == "BRIEF256R":
        return [(2, H, W, 2)] + [(1, H, W, 2), (2, H, W, 7)] * 2
    return []
