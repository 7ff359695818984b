"""The generator: the card's renderer against the frozen numpy copy, and
the same inputs from the same seed."""

from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import generator, synthetic_np
from perfbench.tests import tiny

SEEDS = [0, 2**31 + 12345, 3_000_000_017]


@pytest.mark.parametrize("seed", SEEDS)
def test_device_render_matches_numpy(seed):
    world = generator.make_world(tiny.traffic(True), tiny.config(True).camera, seed)
    frames = generator.render_frames(world, 5, "cpu", torch.float32)
    for t in range(5):
        left, right = synthetic_np.render_frame(world, t)
        assert np.array_equal(frames[t, 0].numpy(), left)
        assert np.array_equal(frames[t, 1].numpy(), right)
    u8 = generator.render_frames(world, 2, "cpu")
    assert np.array_equal(u8[1, 1].numpy(), synthetic_np.render_frame(world, 1)[1].astype(np.uint8))


def test_same_seed_same_inputs_and_the_scene_fixed():
    cam = tiny.config(True).camera
    tr = tiny.traffic(True)
    a = generator.render_frames(generator.make_world(tr, cam, 7), 3, "cpu")
    b = generator.render_frames(generator.make_world(tr, cam, 7), 3, "cpu")
    c = generator.render_frames(generator.make_world(tr, cam, 8), 3, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    wa, wc = generator.make_world(tr, cam, 7), generator.make_world(tr, cam, 8)
    assert np.array_equal(wa.points_w, wc.points_w)
    assert not np.array_equal(wa.textures, wc.textures)


@pytest.mark.parametrize("name", ["loop1024", "firstlap256"])
def test_traffic_files_load(name):
    t = generator.load_traffic(Path(__file__).parents[1] / "traffic" / f"{name}.json")
    assert t.trace_start + t.trace_frames <= t.episode_frames
    assert generator.handoff(t).METHOD == "process_prestaged"
    assert generator.world_module(t).make_world


@pytest.mark.parametrize("key,value", [("world", "spiral"), ("handoff", "png_playback"),
                                       ("trace_start", 7)])
def test_traffic_naming_what_is_not_there_is_refused(key, value):
    params = dict(tiny.traffic(True).params, **{key: value})
    with pytest.raises(ValueError):
        generator.traffic("bad", params)
