"""The engine's `pose_graph_optimization` chronometer (host clock: the
junction graph's assembly, solve and distribution, and the propagation
of the corrections, with the wait for frames queued before its read),
over the window's frames."""


def read(w):
    s = w.chrono.get("pose_graph_optimization")
    return 1e3 * s[0] / w.frames if s and w.frames else None
