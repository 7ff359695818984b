"""Eager runs and captures of every program of the port (the tracker's,
the modular tracker's, the closure ICP's, the DB query's, the pose
graph's and BA's EVENTS counters) inside the window: one-time costs on
the clock.  0 when every program replays."""


def read(w):
    return float(sum(v for k, v in w.events.items()
                     if k.split()[-1] in ("eager", "capture")))
