"""The fused tracker's `tracker_host_gap` chronometer (host clock: from a
drain's ring read to the same tracker's next replay, when the card holds
no tracker work: the drain's parse and keyframe harvest, the engine's
keyframe events, the caller between handles), over the window's frames."""


def read(w):
    s = w.chrono.get("tracker_host_gap")
    return 1e3 * s[0] / w.frames if s and w.frames else None
