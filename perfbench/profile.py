"""The --trace 1 slice: torch.profiler (CPU and CUDA activities) over a
few frames of the first timed episode, reduced to what the per-layer
readers and the result's `breakdown` take.

busy_s is the union of the device's activity intervals (kernels,
copies, sets) inside the slice; window_s the slice's host time, from a
synchronize before it to one after it.  The raw kineto records are
read (building prof.events() for ~10^5 kernels costs the host minutes).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

TOP = 10


@dataclass
class Slice:
    frames: int
    window_s: float
    busy_s: float
    kernels: list  # (name, start_ns, dur_ns) of every CUDA kernel
    device_ops: list  # (name, start_ns, dur_ns) of every device activity
    cpu: list  # (name, start_ns, end_ns) of every host event


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(1000 * getattr(e, f"{what}_us")())


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


class Profile:
    def __init__(self, frame_idx: int):
        from torch.profiler import ProfilerActivity, profile

        self.first = frame_idx
        self.frames = 0
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.active = True
        self.t0 = time.perf_counter()
        self.window_s = 0.0

    def stop(self, frame_idx: int) -> None:
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.active = False
        self.frames = frame_idx - self.first

    def reduce(self) -> Slice | None:
        if self.active or self.frames <= 0:
            return None
        dev, cpu = [], []
        for e in self.prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            dur = _ns(e, "duration")
            name = e.name()
            # The harness's spans are mirrored on the device's timeline as
            # annotations; they are not device activity.
            annotation = name.startswith("perfbench.") or (
                hasattr(e, "is_user_annotation") and e.is_user_annotation())
            if e.device_type() == torch.autograd.DeviceType.CUDA and not annotation:
                dev.append((name, start, dur))
            elif e.device_type() != torch.autograd.DeviceType.CUDA:
                cpu.append((name, start, start + dur))
        dev.sort(key=lambda r: r[1])
        busy, end = 0, None
        for _, s, d in dev:
            e = s + d
            if end is None or s >= end:
                busy += d
                end = e
            elif e > end:
                busy += e - end
                end = e
        return Slice(frames=self.frames, window_s=self.window_s, busy_s=busy * 1e-9,
                     kernels=[r for r in dev if _is_kernel(r[0])], device_ops=dev, cpu=cpu)


def start(frame_idx: int) -> Profile:
    return Profile(frame_idx)


def span(prof: Profile | None, name: str):
    """A host span named for the harness's call into the port, recorded
    only while the slice is profiled."""
    if prof is None or not prof.active:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def breakdown(sl: Slice) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between device activity, each named by what the host was doing
    at its middle: the harness's span and the innermost host event."""
    by_name = defaultdict(int)
    for name, _, d in sl.device_ops:
        by_name[name] += d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps, end = [], None
    for _, s, d in sl.device_ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = s + d if end is None else max(end, s + d)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    out_gaps = []
    for a, b in gaps:
        mid = (a + b) // 2
        over = [(n, s, e) for n, s, e in sl.cpu if s <= mid <= e]
        outer = [o for o in over if o[0].startswith("perfbench.")]
        inner = [o for o in over if not o[0].startswith("perfbench.")]
        label = outer[0][0] if outer else "outside the harness's calls"
        if inner:
            label += " > " + min(inner, key=lambda o: o[2] - o[1])[0]
        else:
            label += " > python"
        out_gaps.append([label[:160], (b - a) * 1e-9])
    return {"device_ops": [[n[:160], d * 1e-9] for n, d in ops], "idle_gaps": out_gaps}
