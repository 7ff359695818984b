"""Set-up and the measured window of one cell of the benchmark.

Set-up (setup_s): the world and the episode's frames from the seed
(generator.py), the configuration, the port's warm-ups (pose-graph
buckets, ICP buckets, windowed BA where the configuration runs it), one
whole warm episode, the query programs at every prefix that episode
reached, and one more episode
while a program has run eagerly but is not captured yet.  Every program
the window uses is then built and captured.

The window: episodes back to back until `seconds` have passed, each a
fresh SlamEngine over the same frames (its construction, and the
collection of the one before, inside the window), handed over by the traffic's hand-off module
(perfbench/handoffs/<handoff>.py: prestaged handles, or host frames one
at a time).  The window ends with the first handle
or frame that completes at or after `seconds`; every frame completed up
to then counts, and the engine of the episode that was cut is flushed
after the window, off the clock, for the correctness check.

With trace, the frames trace_start .. trace_start + trace_frames of the
first timed episode run under torch.profiler (profile.py); the rest of
the window is timed as without it.
"""

from __future__ import annotations

import copy
import gc
import json
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perfbench import generator, profile, synthetic_np

# Warm episodes in set-up at most: the first captures every program it
# runs twice, the next those it ran once.
WARM_EPISODES_MAX = 3


@dataclass
class Config:
    name: str
    camera: synthetic_np.Camera
    landmark_capacity: int
    settings: dict  # "group.key" -> value, the source's groups' names
    raw: dict


def load_config(path: Path) -> Config:
    """A configuration file: the source's settings (`proslam`, its YAML's
    groups as they are written there) and the port's own keys (`port`,
    "group.key")."""
    d = json.loads(Path(path).read_text())
    settings = {f"{grp}.{key}": val for grp, keys in d["proslam"].items()
                for key, val in keys.items()}
    settings.update(d.get("port", {}))
    return Config(name=Path(path).stem, camera=synthetic_np.Camera(**d["camera"]),
                  landmark_capacity=int(d["landmark_capacity"]), settings=settings, raw=d)


def parameter_collection(config: Config):
    """The port's ParameterCollection, loaded as the port loads a YAML of
    these settings (its group and key aliases); every key must land."""
    import contextlib
    import io

    from vslam_tpu_torch.io.config import load_config as port_load_config

    with contextlib.redirect_stdout(io.StringIO()) as said:
        cfg = port_load_config(overrides=config.settings)
    if len(cfg.explicit_keys) != len(config.settings) or "ignoring" in said.getvalue():
        raise KeyError(f"configuration {config.name}: settings the port does not know: "
                       f"{said.getvalue().strip()}")
    return cfg


@dataclass
class Episode:
    """What one engine returned: every completed frame's pose after the
    final flush, the keyframes' frames, the closures, the breaks."""
    frames: int  # frames whose poses reached the host in the window
    trajectory: np.ndarray  # (n, 4, 4)
    kf_frames: list
    closures: list  # (query map id, reference map id, T_ref_query)
    breaks: int


@dataclass
class Window:
    cell: str
    shape: tuple  # (rows, cols) of the images
    octaves: int = 1  # the front end's pyramid levels
    seconds: float = 0.0
    frames: int = 0
    attempted: int = 0
    failed: int = 0
    handle_s: list = field(default_factory=list)
    frame_s: list = field(default_factory=list)
    setup_s: float = 0.0
    warm_episodes: int = 0
    peak_bytes: int = 0
    events: Counter = field(default_factory=Counter)
    chrono: dict = field(default_factory=dict)  # stage -> (seconds, calls)
    stage_seconds: Counter = field(default_factory=Counter)
    episodes: list = field(default_factory=list)
    trace: profile.Slice | None = None


def program_events() -> Counter:
    """The port's program counters so far: eager runs, captures and
    replays of the tracker's, the closure ICP's, the DB query's, the pose
    graph's, BA's and the modular tracker's programs."""
    from vslam_tpu_torch.backend import ba
    from vslam_tpu_torch.backend import pose_graph as pg
    from vslam_tpu_torch.loop import relocalizer as rl
    from vslam_tpu_torch.tracking import fused, modular

    out = Counter(fused.EVENTS)
    for prefix, events in (("icp", rl.EVENTS), ("query", rl.QUERY_EVENTS),
                           ("pose graph", pg.EVENTS), ("ba", ba.EVENTS),
                           ("modular", modular.EVENTS)):
        out.update({f"{prefix} {k}": v for k, v in events.items()})
    return out


def _uncaptured(events: Counter) -> list[str]:
    """Programs (by counter prefix) that ran eagerly more often than they
    were captured: their next run captures."""
    return [k for k in events if k.endswith("eager")
            and events[k] > events[k[:-len("eager")] + "capture"]]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Runner:
    """One cell's engines over its frames."""

    def __init__(self, config: Config, traffic: generator.Traffic, seed: int, device):
        from vslam_tpu_torch.ops import camera as cam_ops

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.cfg = parameter_collection(config)
        c = config.camera
        self.cam = cam_ops.make_camera(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
                                       baseline_m=c.baseline_m, rows=c.rows, cols=c.cols,
                                       device="cpu")
        world = generator.make_world(traffic, c, seed)
        self.gt = world.poses[:traffic.episode_frames].astype(np.float64)
        self.handoff = generator.handoff(traffic)
        self.prof = None
        self.frames = self.handoff.prepare(self, world)

    def engine(self):
        from vslam_tpu_torch.system.engine import SlamEngine

        return SlamEngine(self.cam, copy.deepcopy(self.cfg),
                          landmark_capacity=self.config.landmark_capacity, device=self.device)

    def traced(self, frame_idx: int, trace_episode: bool, start: bool):
        """Start the profiled slice before trace_start, stop it after
        trace_start + trace_frames (hand-offs call this around each call)."""
        t = self.traffic
        if not trace_episode:
            return
        if start and frame_idx == t.trace_start:
            _sync(self.device)
            self.prof = profile.start(frame_idx)
        elif not start and self.prof is not None and frame_idx == t.trace_start + t.trace_frames:
            _sync(self.device)
            self.prof.stop(frame_idx)

    def episode(self, deadline: float | None, win: Window | None, trace_episode=False):
        """One engine over the episode's frames, handed over by the
        traffic's hand-off; returns (engine, frames completed, cut)."""
        eng = self.engine()
        done, cut = self.handoff.run(self, eng, self.frames, deadline, win, trace_episode)
        return eng, done, cut

    def warm_up(self) -> int:
        """The port's warm-ups (BA's only where the configuration runs BA),
        one whole episode, the query programs up to
        the prefix that episode reached (each runs until its program is
        captured), and more episodes while a program is left uncaptured;
        returns the episodes run."""
        from vslam_tpu_torch.backend import pose_graph as pg
        from vslam_tpu_torch.loop import relocalizer as rl
        from vslam_tpu_torch.system import ba_runner

        dev = self.device
        if dev.type == "cuda":
            pg.warm_hierarchical_buckets(device=dev)
            rl.warm_icp_batches(self.cfg.relocalization, device=dev)
            if self.cfg.graph_optimization.enable_full_bundle_adjustment:
                eng = self.engine()
                ba_runner.warm_windowed_ba(eng)
                del eng
        eng, _, _ = self.episode(None, None)
        episodes = 1
        if dev.type == "cuda" and not self.cfg.command_line.option_disable_relocalization:
            reloc = eng.relocalizer
            rl.warm_query_programs(self.cfg.relocalization, reloc.QUERY_CAP,
                                   reloc._active_prefix(), reloc.capacity, dev)
        del eng
        gc.collect()
        # A program that has run once, eagerly, captures at its next run:
        # one more episode while any such program is left.
        for _ in range(WARM_EPISODES_MAX - 1):
            if not _uncaptured(program_events()):
                break
            eng, _, _ = self.episode(None, None)
            del eng
            gc.collect()
            episodes += 1
        gc.collect()
        _sync(dev)
        return episodes


def _collect(eng, frames: int) -> Episode:
    traj = np.stack(eng.tracker.trajectory) if eng.tracker.trajectory else np.zeros((0, 4, 4))
    return Episode(
        frames=frames,
        trajectory=traj.astype(np.float64),
        kf_frames=list(eng.kf_frame_indices),
        closures=[(c.query_id, c.reference_id, np.asarray(c.T_ref_query, np.float64))
                  for c in eng.world_map.closures],
        breaks=int(eng.tracker.stats.n_breaks),
    )


def _stage_seconds(eng) -> Counter:
    return Counter(dict(eng.tracker.stats.stage_seconds))


def run_cell(cell: str, config: Config, traffic: generator.Traffic, seed: int,
             seconds: float, trace: bool, device="cuda",
             t_start: float | None = None) -> tuple[Window, np.ndarray]:
    """Set up, run the window, and return (the window's record, the
    episode's ground-truth poses)."""
    from vslam_tpu_torch.utils import log

    t_start = time.perf_counter() if t_start is None else t_start
    run = _Runner(config, traffic, seed, device)
    dev = run.device
    win = Window(cell=cell, shape=(config.camera.rows, config.camera.cols),
                 octaves=int(run.cfg.framepoint_generation.detector_number_of_octaves),
                 warm_episodes=run.warm_up())

    # What set-up made stays out of the collector's passes in the window,
    # and the window runs on one intra-op thread: the engine's host work is
    # many small operations, and a pool of threads only adds to their spread.
    gc.collect()
    gc.freeze()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log.chronometers.clear()
    events0 = program_events()
    t0 = time.perf_counter()
    win.setup_s = t0 - t_start
    deadline = t0 + seconds
    first = True
    while True:
        eng, n, cut = run.episode(deadline, win, trace_episode=trace and first)
        first = False
        win.frames += n
        win.stage_seconds.update(_stage_seconds(eng))
        end = time.perf_counter()
        if cut or end >= deadline:
            break
        win.episodes.append(_collect(eng, n))
        # An engine holds reference cycles: freed now, its device memory
        # serves the next engine, instead of whenever the collector's
        # thresholds happen to fall.
        del eng
        gc.collect()
    win.seconds = end - t0
    torch.set_num_threads(threads)
    _sync(dev)
    win.events = program_events() - events0
    win.chrono = {k: (log.chronometers.seconds[k], log.chronometers.calls[k])
                  for k in log.chronometers.seconds}
    if dev.type == "cuda":
        win.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    win.attempted = win.frames
    # The last episode's poses after its flush, off the clock.
    if cut:
        eng.trajectory  # noqa: B018
    win.episodes.append(_collect(eng, n))
    del eng
    gc.unfreeze()
    gc.collect()
    win.failed = sum(e.breaks for e in win.episodes)
    if run.prof is not None:
        win.trace = run.prof.reduce()
    return win, run.gt
