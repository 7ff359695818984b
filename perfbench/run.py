"""Run one cell of the benchmark of vslam_tpu_torch once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (window.py), measures it for --seconds, checks the
answers against the plain reference (reference.py), and prints one JSON
line last on standard output: correct, attempted (frames handed to the
engine in the window), failed (frames whose registration failed),
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device, with --trace 1 breakdown, and checks (each compared
number beside its limit, also the last lines on standard error).

Exits non-zero and prints no result when there is no card, or fewer than
the cell asks for, and when jax, jaxlib, flax or vslam_tpu (by whole
top-level module name) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Libraries that would load JAX on their own stay off it.
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "vslam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: vslam_tpu_torch is not vslam_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float | None = None) -> dict:
    """Set up, measure and check one run of a cell of BENCHMARK.json;
    returns the result line as a dict."""
    from perfbench import generator, spec, window

    bench = spec.load()
    w = spec.cell(bench, workload)
    config = window.load_config(spec.config_path(bench, w["config"]))
    traffic = generator.load_traffic(spec.traffic_path(w["traffic"]))
    metrics = {m["name"]: m["unit"] for m in spec.metrics_for(bench, workload, trace)}
    return result(workload, config, traffic, spec.limits(workload), metrics, seed, seconds,
                  trace, t_start=t_start)


def result(workload: str, config, traffic, limits: dict, metrics: dict, seed: int,
           seconds: float, trace: bool, device: str = "cuda",
           t_start: float | None = None) -> dict:
    """One run of the given configuration and traffic: the window, the
    metrics (name -> unit) its readers find, and the check against
    `limits`."""
    import torch

    from perfbench import profile, reference, spec, window

    win, gt = window.run_cell(workload, config, traffic, seed, seconds, trace,
                              device=device, t_start=t_start)
    numbers = reference.compare(win.episodes, gt)
    correct, rows = reference.decide(numbers, limits)
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": win.peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    read = {}
    for name, unit in metrics.items():
        val = spec.reader(name)(win)
        if val is not None:
            read[name] = {"value": float(val), "unit": unit}
    out = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
           "metrics": read, "device": info}
    if trace and win.trace is not None:
        info["busy_s"] = win.trace.busy_s
        info["window_s"] = win.trace.window_s
        out["breakdown"] = profile.breakdown(win.trace)
    out["checks"] = {name: {"value": val, "limit": lim} for name, val, lim in rows}
    out["_numbers"] = numbers
    out["_warm_episodes"] = win.warm_episodes
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from perfbench import spec

    chips = spec.cell(spec.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    numbers = out.pop("_numbers")
    print(f"perfbench: set-up ran {out.pop('_warm_episodes')} warm episode(s)", file=sys.stderr)
    print("perfbench: numbers " + json.dumps(numbers), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
