"""Prestaged RGB-D playback: the episode's frames are rendered onto the
card in set-up as f32 (intensity, depth in meters) pairs, as the fused
tracker's prestage keeps RGB-D frames, and handed to each engine in
handles of parallelism.frames_per_chunk frames with prestaged.py's
hand-over (SlamEngine.process_prestaged, then the flush).

The intensity is generator._render_batch's left image.  The depth is the
camera-frame z of the splat that won each pixel in that same render, and
0 on the background: the same render with each point's patch painted in
its own z over a background of 0, so the far-first order that picks the
winner is the intensity's and the two planes never disagree about which
point a pixel shows.  A sensor aligned with the intensity camera
(TUM's registered depth) gives depth this way; points beyond the
configuration's maximum depth keep their z, which the front end's
validity window leaves out.

render_frame is the frozen numpy copy of one frame (synthetic_np's
render with the same two paintings); render_frames the card's renderer,
generator.RENDER_BATCH frames a call.  Tests hold the two against each
other at a small size."""

import dataclasses

import numpy as np
import torch

from perfbench import generator, synthetic_np
from perfbench.handoffs import prestaged

METHOD = prestaged.METHOD
run = prestaged.run


def render_frame(world: synthetic_np.World, t: int) -> tuple[np.ndarray, np.ndarray]:
    """The frozen numpy copy: frame t's (intensity, depth_m) f32 pair."""
    z = synthetic_np.camera_points(world, t)[:, 2]
    M, P, _ = world.textures.shape
    depth_world = dataclasses.replace(
        world, textures=np.broadcast_to(z[:, None, None], (M, P, P)),
        background=np.zeros_like(world.background))
    return synthetic_np.render_frame(world, t)[0], synthetic_np.render_frame(depth_world, t)[0]


def render_frames(world: synthetic_np.World, n_frames: int, device) -> torch.Tensor:
    """The first n_frames (intensity, depth) pairs, (n, 2, H, W) f32 on
    `device`.  The depth of a batch of F frames is one render of F x M
    points: frame f's own M (block f, painted in their z in that frame)
    and the other frames' blocks at z = 0, behind the camera, which no
    splat shows.  The visible points keep their order, so the depth order
    and every pixel's winner are those of the intensity's render."""
    dev = torch.device(device)
    M = len(world.points_w)
    P = world.patch
    tex = torch.from_numpy(world.textures).to(dev)
    bg = torch.from_numpy(world.background).to(dev)
    H, W = world.background.shape
    zero_bg = torch.zeros_like(bg)
    out = torch.empty((n_frames, 2, H, W), dtype=torch.float32, device=dev)
    for s in range(0, n_frames, generator.RENDER_BATCH):
        idx = range(s, min(s + generator.RENDER_BATCH, n_frames))
        F = len(idx)
        p = torch.from_numpy(np.stack([synthetic_np.camera_points(world, t)
                                       for t in idx])).to(dev)
        out[s:s + F, 0] = generator._render_batch(world, p, tex, bg, False)
        blocks = torch.zeros((F, F * M, 3), dtype=torch.float32, device=dev)
        for f in range(F):
            blocks[f, f * M:(f + 1) * M] = p[f]
        z_tex = p[..., 2].reshape(F * M, 1, 1).expand(F * M, P, P)
        out[s:s + F, 1] = generator._render_batch(world, blocks, z_tex, zero_bg, False)
    return out


def prepare(runner, world):
    if not runner.cfg.tracking.use_fused_tracker:
        raise ValueError(f"traffic {runner.traffic.name}: prestaged frames need the fused "
                         "tracker")
    if runner.cfg.command_line.tracker_mode != "RGB_DEPTH":
        raise ValueError(f"traffic {runner.traffic.name}: RGB-D frames need tracker_mode "
                         "RGB_DEPTH")
    t = runner.traffic
    frames = render_frames(world, t.episode_frames, runner.device)
    C = max(int(runner.cfg.parallelism.frames_per_chunk), 1)
    if t.trace_start % C or t.trace_frames % C:
        raise ValueError(f"traffic {t.name}: traced frames must be whole handles of {C}")
    return [frames[i:i + C] for i in range(0, t.episode_frames, C)]
