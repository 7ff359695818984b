"""The pose graph's `pg_wait` chronometer (host clock: its junction
solve's and distribution's result reads, blocked on the card: the work
queued ahead of them, such as the ICP batch just dispatched, and the two
programs' own device time), over the window's frames."""


def read(w):
    s = w.chrono.get("pg_wait")
    return 1e3 * s[0] / w.frames if s and w.frames else None
