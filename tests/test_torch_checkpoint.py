"""Checkpoint / resume of the port's engine (port of tests/test_checkpoint.py
at 192 x 512 and 256 keypoints), and checkpoints crossing between the
JAX package and the port, on the CPU.

Limits, as in the JAX test: the resumed trajectory within 0.2 m of the
uninterrupted one at every frame (the first frame after the resume
re-seeds tracking), ATE < 0.1 m.  A checkpoint whose landmark capacity
differs from the engine's is refused.
"""

import os

import numpy as np
import pytest
import torch

from vslam_tpu.io import checkpoint as jckpt
from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.ops import camera as jcam
from vslam_tpu.system.engine import SlamEngine as JEngine
from vslam_tpu_torch.eval import trajectory as traj_eval
from vslam_tpu_torch.io import checkpoint, synthetic
from vslam_tpu_torch.io.config import ParameterCollection
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.system.engine import SlamEngine

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAM_ARGS = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4, rows=192, cols=512)
CAM = cam_ops.make_camera(**CAM_ARGS, device="cpu")
N_FRAMES, RESUME_AT, CAPACITY = 16, 8, 8192
BETWEEN_DRAINS = 7  # three frames after a drain at a harvest every 4; frame 6 makes a keyframe


def make_cfg(cls=ParameterCollection):
    cfg = cls()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.framepoint_generation.border_pixels = 12  # the staged front-end in both packages
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.6
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.command_line.option_disable_relocalization = True
    if cls is JConfig:
        cfg.parallelism.shard_descriptor_db = False
        cfg.parallelism.shard_landmarks = False
    return cfg


@pytest.fixture(scope="module")
def sequence():
    world = synthetic.make_world(CAM, n_frames=N_FRAMES, n_points=1500, seed=51, step=0.3)
    return world, [synthetic.render_frame(world, t)[:2] for t in range(N_FRAMES)]


@pytest.fixture(scope="module")
def uninterrupted(sequence):
    _, frames = sequence
    eng = SlamEngine(CAM, make_cfg(), landmark_capacity=CAPACITY, device="cpu")
    for f in frames:
        eng.process(*f)
    return eng.trajectory


def _check_resumed(resumed, frames, sequence, uninterrupted, resume_at=RESUME_AT):
    world, _ = sequence
    for f in frames[resume_at:]:
        resumed.process(*f)
    est = resumed.trajectory
    assert est.shape == (N_FRAMES, 4, 4)
    err = np.linalg.norm(est[:, :3, 3] - uninterrupted[:, :3, 3], axis=1)
    assert err.max() < 0.2, err
    rmse, _, _ = traj_eval.ate_rmse(est, world.poses)
    assert rmse < 0.1


def test_checkpoint_resume(sequence, uninterrupted, tmp_path):
    _, frames = sequence
    first = SlamEngine(CAM, make_cfg(), landmark_capacity=CAPACITY, device="cpu")
    for f in frames[:RESUME_AT]:
        first.process(*f)
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(first, ckpt)

    resumed = SlamEngine(CAM, make_cfg(), landmark_capacity=CAPACITY, device="cpu")
    checkpoint.load_checkpoint(resumed, ckpt)
    st, st0 = resumed.tracker.state, first.tracker.state
    assert int(st.frame_idx) == RESUME_AT and resumed.tracker.stats.n_frames == RESUME_AT
    assert resumed.tracker.allocator.num_allocated == first.tracker.allocator.num_allocated
    assert torch.equal(st.T_world_cam, st0.T_world_cam)
    for name in ("xyz_w", "desc", "valid", "origin_kf", "last_seen"):
        assert torch.equal(getattr(st.table, name), getattr(st0.table, name)), name
    assert len(resumed.world_map) == len(first.world_map) >= 2
    assert resumed.relocalizer.n_rows == first.relocalizer.n_rows > 0
    assert torch.equal(resumed.relocalizer.db_desc, first.relocalizer.db_desc)
    _check_resumed(resumed, frames, sequence, uninterrupted)
    assert len(resumed.world_map) > len(first.world_map)


def test_checkpoint_capacity_mismatch(sequence, tmp_path):
    _, frames = sequence
    eng = SlamEngine(CAM, make_cfg(), landmark_capacity=CAPACITY, device="cpu")
    for f in frames[:3]:
        eng.process(*f)
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(eng, ckpt)
    other = SlamEngine(CAM, make_cfg(), landmark_capacity=CAPACITY // 2, device="cpu")
    with pytest.raises(ValueError, match="capacity mismatch"):
        checkpoint.load_checkpoint(other, ckpt)


def test_jax_checkpoint_resumes_in_the_port(sequence, uninterrupted, tmp_path):
    """The JAX engine saves after 8 frames; the port loads the file and
    runs the 8 frames after it."""
    _, frames = sequence
    jeng = JEngine(jcam.make_camera(**CAM_ARGS), make_cfg(JConfig), landmark_capacity=CAPACITY)
    for f in frames[:RESUME_AT]:
        jeng.process(*f)
    ckpt = str(tmp_path / "jax_state.npz")
    jckpt.save_checkpoint(jeng, ckpt)
    resumed = SlamEngine(CAM, make_cfg(), landmark_capacity=CAPACITY, device="cpu")
    checkpoint.load_checkpoint(resumed, ckpt)
    assert int(resumed.tracker.state.frame_idx) == RESUME_AT
    assert len(resumed.world_map) == len(jeng.world_map) >= 2
    np.testing.assert_array_equal(resumed.tracker.state.table.desc.numpy(),
                                  np.asarray(jeng.tracker.table.desc).view(np.int32))
    _check_resumed(resumed, frames, sequence, uninterrupted)


def test_port_checkpoint_resumes_in_jax(sequence, uninterrupted, tmp_path):
    """The port saves after 8 frames; the JAX engine loads the file and
    runs the 8 frames after it."""
    _, frames = sequence
    eng = SlamEngine(CAM, make_cfg(), landmark_capacity=CAPACITY, device="cpu")
    for f in frames[:RESUME_AT]:
        eng.process(*f)
    ckpt = str(tmp_path / "port_state.npz")
    checkpoint.save_checkpoint(eng, ckpt)
    jeng = JEngine(jcam.make_camera(**CAM_ARGS), make_cfg(JConfig), landmark_capacity=CAPACITY)
    jckpt.load_checkpoint(jeng, ckpt)
    assert jeng.tracker.frame_idx == RESUME_AT
    assert np.asarray(jeng.tracker.table.desc).dtype == np.uint32
    _check_resumed(jeng, frames, sequence, uninterrupted)


def test_checkpoint_between_drains(sequence, uninterrupted, tmp_path):
    """The card harvests every frames_per_chunk frames: a checkpoint saved
    between two drains must register the keyframes its own flush
    harvests, so the file holds a local map for every keyframe the device
    made and no landmark names a missing one."""
    _, frames = sequence
    first = SlamEngine(CAM, make_cfg(), landmark_capacity=CAPACITY, device="cpu")
    first.tracker.harvest_every = 4
    for f in frames[:BETWEEN_DRAINS]:
        first.process(*f)
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(first, ckpt)
    assert len(first.world_map) == int(first.tracker.state.kf_count) >= 2

    resumed = SlamEngine(CAM, make_cfg(), landmark_capacity=CAPACITY, device="cpu")
    resumed.tracker.harvest_every = 4
    checkpoint.load_checkpoint(resumed, ckpt)
    table = resumed.tracker.state.table
    assert len(resumed.world_map) == int(resumed.tracker.state.kf_count) == len(first.world_map)
    assert int(table.origin_kf[table.valid].max()) < len(resumed.world_map)
    _check_resumed(resumed, frames, sequence, uninterrupted, BETWEEN_DRAINS)
