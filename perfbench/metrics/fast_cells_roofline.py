"""The staged FAST detector kernel's share of its roofline: the least
time the launches of the traced slice's frames can take on the card
(perfbench/roofline/fast_cells.py, at the cell configuration's bin size;
the peaks in perfbench/peaks.py) over the summed durations of the
fast_cells_kernel launches the profiler saw in the slice.  Nothing is
read where the slice holds another number of launches than its frames
make on the staged route (one a pyramid level), as in a program without
the kernel: the launches would then not be the ones the bound counts."""

from perfbench import spec, window
from perfbench.roofline import fast_cells


def read(w):
    t = w.trace
    if t is None or t.frames <= 0:
        return None
    durs = [d for name, _, d in t.kernels if fast_cells.SYMBOL in name]
    H, W = w.shape
    launches = fast_cells.frame_launches(H, W, w.octaves)
    if not durs or len(durs) != t.frames * len(launches):
        return None
    bench = spec.load()
    config = window.load_config(spec.config_path(bench, spec.cell(bench, w.cell)["config"]))
    bin_size = int(config.settings[fast_cells.BIN_KEY])
    least = t.frames * sum(fast_cells.least_seconds(*shape, bin_size) for shape in launches)
    return 100.0 * least / (1e-9 * sum(durs))
