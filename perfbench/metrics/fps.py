"""Frames whose poses reached the host in the window, over the window's
seconds (engine construction, every handle or frame, the flushes)."""


def read(w):
    return w.frames / w.seconds if w.frames and w.seconds > 0 else None
