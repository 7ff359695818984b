"""The control of the correctness check: the reference put in the
program's place and computed in the nearest precision below the one the
configurations state (float32 with TF32 off -> bfloat16; TF32 would
leave these element-wise poses unchanged).  The rendered poses, held in
bfloat16, are handed to reference.compare as if the engine had returned
them, with keyframes where the configuration's local-map trigger
(world_map.minimum_distance_traveled_for_local_map, ..._number_of_frames_...)
fires on the true path, and closures where the true path comes back
within CLOSURE_RADIUS_M of a keyframe at least the configuration's
query interspace before, their relative poses worked out in bfloat16.
It has to come out as not correct.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: the numbers, the limits, correct.  It runs
on the host only and needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import generator, reference, spec, window  # noqa: E402

# How near (m) the true path has to come back to a keyframe for the
# control to close a loop there.
CLOSURE_RADIUS_M = 1.5


def keyframes(gt: np.ndarray, settings: dict) -> list[int]:
    """Frames where the local-map trigger fires on the true path."""
    dist = settings.get("world_map.minimum_distance_traveled_for_local_map", 0.5)
    frames = settings.get("world_map.minimum_number_of_frames_for_local_map", 4)
    out, last = [], 0
    for f in range(1, len(gt)):
        if (np.linalg.norm(gt[f, :3, 3] - gt[last, :3, 3]) > dist and f - last >= frames):
            out.append(f)
            last = f
    return out


def _inv_bf16(T: torch.Tensor) -> torch.Tensor:
    """The rigid inverse of bfloat16 poses, in bfloat16."""
    out = torch.zeros_like(T)
    Rt = T[..., :3, :3].transpose(-1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3:])[..., 0]
    out[..., 3, 3] = 1
    return out


def closures(gt: np.ndarray, kf: list[int], settings: dict) -> list:
    """(query keyframe, reference keyframe) where the true path returns to
    a place: the nearest earlier keyframe, at least the query interspace
    before, within CLOSURE_RADIUS_M."""
    gap = int(settings.get("relocalization.preliminary_minimum_interspace_queries", 10))
    pos = gt[kf, :3, 3]
    out = []
    for q in range(len(kf)):
        if q - gap < 0:
            continue
        d = np.linalg.norm(pos[:q - gap + 1] - pos[q], axis=1)
        r = int(np.argmin(d))
        if d[r] < CLOSURE_RADIUS_M:
            out.append((q, r))
    return out


def control_episode(gt: np.ndarray, settings: dict) -> window.Episode:
    low = torch.from_numpy(gt).to(torch.bfloat16)
    kf = keyframes(gt, settings)
    pairs = closures(gt, kf, settings)
    rel = []
    if pairs:
        q = torch.tensor([kf[a] for a, _ in pairs])
        r = torch.tensor([kf[b] for _, b in pairs])
        rel = (_inv_bf16(low[r]) @ low[q]).to(torch.float64).numpy()
    return window.Episode(frames=len(gt), trajectory=low.to(torch.float64).numpy(),
                          kf_frames=kf,
                          closures=[(a, b, T) for (a, b), T in zip(pairs, rel)], breaks=0)


def control_run(config: window.Config, traffic: generator.Traffic, seed: int,
                limits: dict) -> dict:
    world = generator.make_world(traffic, config.camera, seed)
    gt = world.poses[:traffic.episode_frames].astype(np.float64)
    numbers = reference.compare([control_episode(gt, config.settings)], gt)
    correct, rows = reference.decide(numbers, limits)
    return {"seed": seed, "correct": correct, "numbers": numbers,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in rows}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = spec.load()
    w = spec.cell(bench, args.workload)
    config = window.load_config(spec.config_path(bench, w["config"]))
    traffic = generator.load_traffic(spec.traffic_path(w["traffic"]))
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **control_run(config, traffic, seed, spec.limits(args.workload))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
