"""Closures over ICP jobs in the window (the relocalizer's `icp closures`
and `icp candidates` counters): the share of the closure ICP's work that
passed its gates and became a closure."""


def read(w):
    n = w.events.get("icp candidates", 0)
    return 100.0 * w.events.get("icp closures", 0) / n if n else None
