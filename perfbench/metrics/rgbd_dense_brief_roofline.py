"""The dense BRIEF kernel's share of its roofline on the RGB-D front end
(K3 over the frame's one intensity image, frontend/depth.py's route): the
least time the traced slice's frames' launches can take on the card
(perfbench/roofline/dense_brief.py at (1, H, W) a frame; the peaks in
perfbench/peaks.py) over the summed durations of the dense_brief_kernel
launches the profiler saw in the slice.  Nothing is read where the slice
holds another number of them than 1 a frame, or any at a turned pattern's
table (K4, told apart as perfbench/roofline/rotated_brief.py does): the
launches would then not be the ones the bound counts."""

from perfbench.roofline import dense_brief, rotated_brief


def read(w):
    t = w.trace
    if t is None or t.frames <= 0:
        return None
    launches = [(name, d) for name, _, d in t.kernels if dense_brief.SYMBOL in name]
    if (len(launches) != t.frames
            or any(rotated_brief.is_rotated(name) for name, _ in launches)):
        return None
    H, W = w.shape
    least = t.frames * dense_brief.least_seconds(1, H, W)
    return 100.0 * least / (1e-9 * sum(d for _, d in launches))
