"""The dense BRIEF kernel's share of its roofline (K2 and K3 together):
the least time the launches of the traced slice's frames can take on the
card (perfbench/roofline/dense_brief.py, the peaks in perfbench/peaks.py)
over the summed durations of the dense_brief_kernel launches the
profiler saw in the slice.  Nothing is read where the slice holds
another number of launches than its frames make on the staged route:
the launches would then not be the ones the bound counts."""

from perfbench.roofline import dense_brief


def read(w):
    t = w.trace
    if t is None or t.frames <= 0:
        return None
    durs = [d for name, _, d in t.kernels if dense_brief.SYMBOL in name]
    H, W = w.shape
    launches = dense_brief.frame_launches(H, W, w.octaves)
    if not durs or len(durs) != t.frames * len(launches):
        return None
    least = t.frames * sum(dense_brief.least_seconds(*shape) for shape in launches)
    return 100.0 * least / (1e-9 * sum(durs))
