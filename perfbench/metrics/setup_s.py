"""Seconds from the start of the run's process to the first timed frame:
imports, CUDA start, the world and frames, the warm-ups and the warm
episode (and, in a checkout's first run, the nvcc builds)."""


def read(w):
    return w.setup_s if w.setup_s > 0 else None
