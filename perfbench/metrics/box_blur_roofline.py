"""The box blur kernel's share of its roofline: the least time the
launches of the traced slice's frames can take on the card
(perfbench/roofline/box_blur.py, on the route of the cell configuration's
descriptor; the peaks in perfbench/peaks.py) over the summed durations of
the box_blur_kernel launches the profiler saw in the slice.  Nothing is
read where the slice holds another number of launches than its frames
make on that route (3 a frame on the staged BRIEF256 route at 2 octaves,
5 on BRIEF256R's), as in a program without the kernel: the launches would
then not be the ones the bound counts."""

from perfbench import spec, window
from perfbench.roofline import box_blur


def read(w):
    t = w.trace
    if t is None or t.frames <= 0:
        return None
    durs = [d for name, _, d in t.kernels if box_blur.SYMBOL in name]
    if not durs:
        return None
    bench = spec.load()
    config = window.load_config(spec.config_path(bench, spec.cell(bench, w.cell)["config"]))
    H, W = w.shape
    launches = box_blur.frame_launches(H, W, w.octaves,
                                       str(config.settings[box_blur.DESCRIPTOR_KEY]))
    if not launches or len(durs) != t.frames * len(launches):
        return None
    least = t.frames * sum(box_blur.least_seconds(*shape) for shape in launches)
    return 100.0 * least / (1e-9 * sum(durs))
