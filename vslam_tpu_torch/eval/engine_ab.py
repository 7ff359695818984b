"""Engine ms/frame of an earlier checkout beside this one, on one card.

    python -m vslam_tpu_torch.eval.engine_ab --earlier DIR [--frames 64] [--out FILE]

Runs chip_smoke.py's k1-slice (its bench settings, open loop, on the
first N frames of its 128-frame circle) in a fresh process for each tree
in turns: earlier, this, this, earlier, and prints each run's ms/frame
over the run and its median after the first 8 frames.  DIR is an
unpacked earlier commit (`git archive <commit> | tar -x -C DIR`) that
has chip_smoke.py.  Host time spreads widely between calls, so two
checkouts are compared only inside one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = """
import json, statistics, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke
from vslam_tpu_torch.system.engine import SlamEngine

n = {frames}
cam, cfg, world, frames = chip_smoke.bench_setup()
engine = SlamEngine(cam, cfg, landmark_capacity=65536, device="cuda")
times = []
t0 = time.perf_counter()
for left, right in frames[:n]:
    t1 = time.perf_counter()
    engine.process(left, right)
    times.append(time.perf_counter() - t1)
engine.trajectory
torch.cuda.synchronize()
print(json.dumps({{"ms_frame": 1e3 * (time.perf_counter() - t0) / n,
                  "median_ms": 1e3 * statistics.median(times[8:])}}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True, help="unpacked earlier checkout")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--out", default="build/engine_ab.json")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    runs = []
    for label, tree in (("earlier", args.earlier), ("this", here), ("this", here),
                        ("earlier", args.earlier)):
        proc = subprocess.run([sys.executable, "-c", _RUN.format(frames=args.frames)],
                              cwd=tree, capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise SystemExit(f"{label} run failed:\n{proc.stderr[-4000:]}")
        runs.append({"tree": label, **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)


if __name__ == "__main__":
    main()
