"""Faults planted in the timed path, and the readings of the correctness
numbers with and without them, for setting and proving the limits of
perfbench/limits/ (PERF.md section 2).  The benchmark's own runs plant
nothing; the CPU tests (tests/test_perfbench_run.py) and this script do.

    python3 perfbench/faults.py --workload <cell> --fault <name> --seconds <s> \\
        --seeds <n> [<n> ...]

runs the cell once a seed in one process (the programs the first seed
captured serve the next) with the fault planted ("none" plants nothing),
and prints one JSON line a seed: correct, the numbers, the checks.

Faults (each wraps a SlamEngine method; `orig` is the method):
  stuck            a step that returns its state unchanged: every pose
                   of the call stays the last one before it
  half             half of each handle left out
  altered          an answer altered where it is produced: the third
                   frame's pose moved 0.5 m
  pose_graph_off   the pose graph's corrections dropped: every solve
                   returns at once
  closure_shifted  every closure's relative pose moved 0.5 m along x
                   where the relocalizer hands it to the engine
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _stuck(orig):
    def step(self, *args):
        n0 = len(self.tracker.trajectory)
        last = self.tracker.trajectory[-1].copy() if n0 else np.eye(4, dtype=np.float32)
        res = orig(self, *args)
        self.tracker.trajectory[n0:] = [last.copy() for _ in self.tracker.trajectory[n0:]]
        return res
    return step


def _half(orig):
    def step(self, staged):
        return orig(self, staged[:max(len(staged) // 2, 1)] if len(staged) > 1 else staged[:0])
    return step


def _altered(orig):
    def step(self, *args):
        n0 = len(self.tracker.trajectory)
        res = orig(self, *args)
        if n0 < 3 <= len(self.tracker.trajectory):
            T = self.tracker.trajectory[2].copy()
            T[0, 3] += 0.5
            self.tracker.trajectory[2] = T
        return res
    return step


def _pose_graph_off(orig):
    def solve(self):
        return None
    return solve


def _closure_shifted(orig):
    def record(self, closure):
        T = np.array(closure.T_ref_query, dtype=np.float32, copy=True)
        T[0, 3] += 0.5
        closure.T_ref_query = T
        return orig(self, closure)
    return record


# name -> (SlamEngine method, or None for the cell's hand-off method; wrapper)
FAULTS = {
    "stuck": (None, _stuck),
    "half": ("process_prestaged", _half),
    "altered": (None, _altered),
    "pose_graph_off": ("_optimize_pose_graph", _pose_graph_off),
    "closure_shifted": ("_record_closure", _closure_shifted),
}


def plant(name: str, handoff_method: str, setattr_=setattr) -> None:
    """Wrap the SlamEngine method the fault breaks (`handoff_method` is
    the call a cell hands its frames to: process_prestaged or process)."""
    from vslam_tpu_torch.system.engine import SlamEngine

    method, wrap = FAULTS[name]
    method = method or handoff_method
    setattr_(SlamEngine, method, wrap(getattr(SlamEngine, method)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=["none", *FAULTS])
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    from perfbench import generator, run, spec, window

    bench = spec.load()
    w = spec.cell(bench, args.workload)
    config = window.load_config(spec.config_path(bench, w["config"]))
    traffic = generator.load_traffic(spec.traffic_path(w["traffic"]))
    if args.fault != "none":
        plant(args.fault, generator.handoff(traffic).METHOD)
    for seed in args.seeds:
        out = run.result(args.workload, config, traffic, spec.limits(args.workload), {}, seed,
                         args.seconds, False)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "failed": out["failed"], "numbers": out["_numbers"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
