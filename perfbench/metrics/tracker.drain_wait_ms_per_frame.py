"""The fused tracker's `tracker_drain_wait` chronometer (host clock: the
drain's read of the result ring, blocked until the card has run every
replay queued before it), over the window's frames."""


def read(w):
    s = w.chrono.get("tracker_drain_wait")
    return 1e3 * s[0] / w.frames if s and w.frames else None
