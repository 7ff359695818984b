"""CUDA kernels the profiler saw in the traced slice (graph replays'
kernels included), over the frames completed in it."""


def read(w):
    t = w.trace
    if t is None or not t.kernels or t.frames <= 0:
        return None
    return len(t.kernels) / t.frames
