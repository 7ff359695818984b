"""The traffic generator: a traffic file (perfbench/traffic/<mix>.json)
and a configuration's camera give the world, the ground-truth poses and
the frames of one episode, made from the seed.

A traffic file holds only parameters.  Every traffic has

    world                           the module that builds the world and
                                    its true poses from the file's other
                                    parameters: perfbench/worlds/<world>.py,
                                    make_world(traffic, cam, seed) ->
                                    synthetic_np.World
    handoff                         the module that hands the episode's
                                    frames to the engine:
                                    perfbench/handoffs/<handoff>.py
                                    (prepare, run; see prestaged.py)
    episode_frames                  the frames of the world one episode
                                    plays
    trace_start, trace_frames       the frames of the first timed
                                    episode that a --trace 1 run profiles

and the parameters its world and hand-off read (worlds/circle.py: the
circle, the points, the scene seed).  A traffic that needs another kind
of world or hand-off (RGB-D frames, images read from disk, frames due
at a camera's rate) is a new module in worlds/ or handoffs/ and a new
data file; no file here changes.

render_frames renders synthetic_np.render_frame's stereo pairs on the
device: the projection in the same f32 operations, the splats far-first
with the nearest winning each pixel (a max over the depth order instead
of numpy's last write).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perfbench import synthetic_np

# Frames rendered per batch on the device (bounds the splat buffers).
RENDER_BATCH = 8


HERE = Path(__file__).resolve().parent


@dataclass
class Traffic:
    name: str
    world: str
    handoff: str
    episode_frames: int
    trace_start: int
    trace_frames: int
    params: dict = field(default_factory=dict)  # the whole file


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind[:-1]} {name!r} ({path} is missing)")
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def traffic(name: str, params: dict) -> Traffic:
    t = Traffic(name=name, params=dict(params), **{k: params[k] for k in (
        "world", "handoff", "episode_frames", "trace_start", "trace_frames")})
    world_module(t)
    handoff(t)
    if t.episode_frames <= 0:
        raise ValueError(f"traffic {t.name}: episode_frames out of range")
    if t.trace_start + t.trace_frames > t.episode_frames:
        raise ValueError(f"traffic {t.name}: the traced frames lie past the episode")
    return t


def load_traffic(path: Path) -> Traffic:
    return traffic(Path(path).stem, json.loads(Path(path).read_text()))


def world_module(t: Traffic):
    return _module("worlds", t.world)


def handoff(t: Traffic):
    return _module("handoffs", t.handoff)


def make_world(t: Traffic, cam: synthetic_np.Camera, seed: int) -> synthetic_np.World:
    world = world_module(t).make_world(t, cam, seed)
    if len(world.poses) < t.episode_frames:
        raise ValueError(f"traffic {t.name}: the world has {len(world.poses)} poses, "
                         f"the episode {t.episode_frames} frames")
    return world


def _render_batch(world, p_cams: torch.Tensor, tex: torch.Tensor, bg: torch.Tensor,
                  shift_baseline: bool) -> torch.Tensor:
    """synthetic_np.render_frame's render() for a batch of frames on the
    device: p_cams (F, M, 3) f32 -> (F, H, W) f32."""
    cam = world.cam
    fx, fy, cx, cy = float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)
    fxb = fx * float(cam.baseline_m)  # numpy: fx * b in f64, cast once
    F, M, _ = p_cams.shape
    H, W = bg.shape
    r = world.patch // 2
    P = world.patch
    dev = p_cams.device
    z = p_cams[..., 2]
    vis = z > 0.5
    zs = torch.where(vis, z, torch.ones_like(z))
    u = fx * p_cams[..., 0] / zs + cx
    if shift_baseline:
        u = u - torch.tensor(fxb, dtype=torch.float32, device=dev) / zs
    v = fy * p_cams[..., 1] / zs + cy
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    ok = vis & (ui >= r) & (ui < W - r) & (vi >= r) & (vi < H - r)
    # Depth order far first (stable, as the numpy copy sorts): a splat's
    # rank is its position in that order, and the highest rank at a pixel
    # is the nearest, numpy's last write.
    order = torch.sort(torch.where(ok, -z, torch.full_like(z, float("inf"))), dim=1,
                       stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(M, device=dev).expand(F, M))
    f_idx, m_idx = torch.nonzero(ok, as_tuple=True)
    d = torch.arange(-r, r + 1, device=dev)
    rows = vi[f_idx, m_idx][:, None, None] + d[None, :, None]
    cols = ui[f_idx, m_idx][:, None, None] + d[None, None, :]
    pix = (f_idx[:, None, None] * (H * W) + rows * W + cols).reshape(-1)
    key = rank[f_idx, m_idx][:, None, None].expand(-1, P, P).reshape(-1)
    win = torch.full((F * H * W,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, pix, key, reduce="amax")
    top = win[pix] == key
    img = bg.expand(F, H, W).reshape(-1).clone()
    img[pix[top]] = tex[m_idx].reshape(-1)[top]
    return img.view(F, H, W)


def render_frames(world: synthetic_np.World, n_frames: int, device,
                  dtype=torch.uint8) -> torch.Tensor:
    """The first n_frames stereo pairs, (n, 2, H, W) on `device`: uint8 as
    the fused tracker's prestage casts them (numpy's astype truncates, so
    does torch's), or f32."""
    dev = torch.device(device)
    tex = torch.from_numpy(world.textures).to(dev)
    bg = torch.from_numpy(world.background).to(dev)
    H, W = world.background.shape
    out = torch.empty((n_frames, 2, H, W), dtype=dtype, device=dev)
    for s in range(0, n_frames, RENDER_BATCH):
        idx = range(s, min(s + RENDER_BATCH, n_frames))
        p = torch.from_numpy(np.stack([synthetic_np.camera_points(world, t)
                                       for t in idx])).to(dev)
        for side in (0, 1):
            out[s:s + len(idx), side] = _render_batch(world, p, tex, bg, side == 1).to(dtype)
    return out
