"""Share of the traced slice (torch.profiler, a few handles or frames of
the first timed episode) in which no device activity ran."""


def read(w):
    t = w.trace
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
