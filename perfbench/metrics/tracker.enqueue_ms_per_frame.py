"""The fused tracker's `tracker_enqueue` chronometer (host clock: queueing
the frames' replays, the frame copies into the program's buffers
included), over the window's frames."""


def read(w):
    s = w.chrono.get("tracker_enqueue")
    return 1e3 * s[0] / w.frames if s and w.frames else None
