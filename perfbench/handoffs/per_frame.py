"""Frame by frame from host memory: the episode's frames are rendered in
set-up and kept on the host as f32 stereo pairs, and handed to each
engine one at a time (SlamEngine.process; the pose is exact when the
call returns), as a robot that needs a pose after every frame consumes
them.  The window records each frame's seconds.  The interface is
prestaged.py's."""

import time

import torch

from perfbench import generator, profile

METHOD = "process"


def prepare(runner, world):
    frames = generator.render_frames(world, runner.traffic.episode_frames, runner.device,
                                     torch.float32)
    return [(f[0].numpy(), f[1].numpy()) for f in frames.cpu()]


def run(runner, eng, frames, deadline, win, trace_episode):
    done = 0
    for img_l, img_r in frames:
        runner.traced(done, trace_episode, True)
        with profile.span(runner.prof, "perfbench.process"):
            a = time.perf_counter()
            eng.process(img_l, img_r)
            b = time.perf_counter()
        done += 1
        runner.traced(done, trace_episode, False)
        if win is not None:
            win.frame_s.append(b - a)
        if deadline is not None and b >= deadline:
            return done, True
    return done, False
