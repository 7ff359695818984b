"""The engine's `relocalization` chronometer (host clock: staging,
dispatching and resolving the DB query, the vote and the ICP), over the
window's frames."""


def read(w):
    s = w.chrono.get("relocalization")
    return 1e3 * s[0] / w.frames if s and w.frames else None
