"""Prestaged playback: the episode's frames are rendered onto the card
in set-up as uint8 stereo pairs (as the fused tracker's prestage casts
them) and handed to each engine in handles of
parallelism.frames_per_chunk frames (SlamEngine.process_prestaged; the
poses of a handle's frames are on the host when the call returns), then
the engine is flushed (SlamEngine.trajectory).  The window records each
handle's seconds.

A hand-off module has METHOD (the SlamEngine method the frames go to),
prepare(runner, world) -> the frames as the hand-off keeps them, and
run(runner, eng, frames, deadline, win, trace_episode) -> (frames
completed, cut), which stops after the first handle or frame that ends
at or after `deadline`."""

import time

import torch

from perfbench import generator, profile

METHOD = "process_prestaged"


def prepare(runner, world):
    if not runner.cfg.tracking.use_fused_tracker:
        raise ValueError(f"traffic {runner.traffic.name}: prestaged frames need the fused "
                         "tracker")
    t = runner.traffic
    frames = generator.render_frames(world, t.episode_frames, runner.device, torch.uint8)
    C = max(int(runner.cfg.parallelism.frames_per_chunk), 1)
    if t.trace_start % C or t.trace_frames % C:
        raise ValueError(f"traffic {t.name}: traced frames must be whole handles of {C}")
    return [frames[i:i + C] for i in range(0, t.episode_frames, C)]


def run(runner, eng, handles, deadline, win, trace_episode):
    done = 0
    for h in handles:
        runner.traced(done, trace_episode, True)
        with profile.span(runner.prof, "perfbench.process_prestaged"):
            a = time.perf_counter()
            eng.process_prestaged(h)
            b = time.perf_counter()
        done += len(h)
        runner.traced(done, trace_episode, False)
        if win is not None:
            win.handle_s.append(b - a)
        if deadline is not None and b >= deadline:
            return done, True
    with profile.span(runner.prof, "perfbench.flush"):
        eng.trajectory  # noqa: B018 -- flushes the closure pipeline
    return done, False
