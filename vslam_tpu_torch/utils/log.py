"""Logging and chronometers (port of vslam_tpu/utils/log.py, without its
jax.profiler hook).

  * leveled, timestamped stderr logging — the reference's LOG_* macros
    (src/types/definitions.h:163-192), level from $VSLAM_LOG_LEVEL;
  * chronometers — wall seconds per named stage as a context manager and
    a global registry, feeding the report's stage table
    (slam_assembly.cpp:705-742).  While a torch.profiler session records,
    each stage is also a `vslam.<stage>` range on the profiler's host
    timeline, on the clock of the device activity it traces.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict

import torch

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARNING": 30, "ERROR": 40}
_level = _LEVELS.get(os.environ.get("VSLAM_LOG_LEVEL", "INFO").upper(), 20)


def _emit(level: str, msg: str):
    if _LEVELS[level] >= _level:
        print(f"[{time.strftime('%H:%M:%S')}|{level}] {msg}", file=sys.stderr)


def debug(msg: str):
    _emit("DEBUG", msg)


def warning(msg: str):
    _emit("WARNING", msg)


class ChronometerRegistry:
    """Accumulates wall seconds per named stage (reference chronometers).

    seconds[stage] is the inclusive time of the stage's blocks and
    calls[stage] their count; self_seconds[stage] leaves out the time of
    the stages opened inside them, so self seconds over every stage add
    up to the time spent in any stage.  Stages nest on one stack: measure
    them from one thread."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.self_seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        # Per open stage: the inclusive seconds of the stages closed inside it.
        self._inner: list[float] = []
        # Inclusive seconds of the stages closed while no other was open.
        self.outer_seconds = 0.0

    @contextlib.contextmanager
    def measure(self, stage: str):
        rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            rf = torch.profiler.record_function("vslam." + stage)
            rf.__enter__()
        self._inner.append(0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            inner = self._inner.pop()
            self.seconds[stage] += dt
            self.self_seconds[stage] += dt - inner
            self.calls[stage] += 1
            if self._inner:
                self._inner[-1] += dt
            else:
                self.outer_seconds += dt
            if rf is not None:
                rf.__exit__(None, None, None)

    def add(self, stage: str, seconds: float, enclosed: float = 0.0):
        """Record one interval that is not a `with` block: `seconds` long,
        of which `enclosed` went to stages measured inside it (the growth
        of outer_seconds over the interval).  It counts toward no open
        stage."""
        self.seconds[stage] += seconds
        self.self_seconds[stage] += seconds - enclosed
        self.calls[stage] += 1

    def report(self) -> dict:
        """Relative/absolute table (slam_assembly.cpp:705-742); `relative`
        is each stage's share of the summed self seconds (unrounded: the
        column sums to 1)."""
        total = sum(self.self_seconds.values()) or 1.0
        return {
            stage: {"seconds": round(s, 4), "self_seconds": round(self.self_seconds[stage], 4),
                    "relative": self.self_seconds[stage] / total,
                    "calls": self.calls[stage]}
            for stage, s in sorted(self.seconds.items(), key=lambda kv: -kv[1])
        }

    def clear(self):
        self.seconds.clear()
        self.self_seconds.clear()
        self.calls.clear()
        self.outer_seconds = 0.0


# Global registry (one process = one SLAM run, as in the reference).
chronometers = ChronometerRegistry()
measure = chronometers.measure
