"""Share of the traced slice's idle time (the gaps between device
activities, from the first to the last) in which the host was inside the
engine's keyframe events (`vslam.keyframe_events` ranges on the
profiler's host timeline: keyframe registration, closure resolve, pose
graph, merging and query submission)."""

SPAN = "vslam.keyframe_events"


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(w):
    t = w.trace
    if t is None or not t.device_ops:
        return None
    spans = _union((s, e) for name, s, e in t.cpu if name == SPAN)
    if not spans:
        return None
    gaps, end = [], None
    for _, s, d in sorted(t.device_ops, key=lambda r: r[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = s + d if end is None else max(end, s + d)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    covered, j = 0, 0
    for a, b in gaps:  # both sorted, each disjoint
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            covered += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return 100.0 * covered / idle
