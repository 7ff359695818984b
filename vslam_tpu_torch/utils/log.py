"""Logging and chronometers (port of vslam_tpu/utils/log.py, without its
jax.profiler hook).

  * leveled, timestamped stderr logging — the reference's LOG_* macros
    (src/types/definitions.h:163-192), level from $VSLAM_LOG_LEVEL;
  * chronometers — wall seconds per named stage as a context manager and
    a global registry, feeding the report's stage table
    (slam_assembly.cpp:705-742).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict

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
    """Accumulates wall seconds per named stage (reference chronometers)."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[stage] += time.perf_counter() - t0
            self.calls[stage] += 1

    def report(self) -> dict:
        """Relative/absolute table (slam_assembly.cpp:705-742)."""
        total = sum(self.seconds.values()) or 1.0
        return {
            stage: {"seconds": round(s, 4), "relative": round(s / total, 3),
                    "calls": self.calls[stage]}
            for stage, s in sorted(self.seconds.items(), key=lambda kv: -kv[1])
        }

    def clear(self):
        self.seconds.clear()
        self.calls.clear()


# Global registry (one process = one SLAM run, as in the reference).
chronometers = ChronometerRegistry()
measure = chronometers.measure
