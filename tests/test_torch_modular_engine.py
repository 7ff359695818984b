"""SlamEngine with the modular PoseTracker (tracking.use_fused_tracker:
false): the synchronous keyframe and closure path against the JAX
package's modular engine on the CPU.

  * closed loop, tests/test_torch_closed_loop.py's 48-frame circle at
    192 x 512: at border 12 (the staged front-end in both packages) the
    local maps, closures with their (query, reference) ids, pose-graph
    optimizations, merged landmarks, breaks and landmarks equal JAX's,
    every position within 1e-3 m of JAX's (measured 1.2e-4 m); at border
    20 the port takes K1's plain version, whose intra-bin tie order may
    differ from JAX's staged path: the same event counts, ATE within
    0.02 m of JAX's (measured: counts equal, ATE 0.1752 m both);
  * with BA, tests/test_torch_ba_engine.py's 36-frame corridor at border
    12: the same BA runs and local maps, positions within 1e-3 m;
  * checkpoints: the port's modular checkpoint loads into JAX's modular
    engine and JAX's into the port's, with the same table, allocator,
    tracker scalars and local maps;
  * process_prestaged refuses the modular tracker.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ba_engine import CAM_ARGS as BA_CAM_ARGS
from test_torch_ba_engine import make_cfg as ba_cfg
from test_torch_closed_loop import CAM_ARGS, N_FRAMES, closed_loop_config
from vslam_tpu.eval import trajectory as jtraj
from vslam_tpu.io import checkpoint as jckpt
from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.ops import camera as jcam
from vslam_tpu.system.engine import SlamEngine as JEngine
from vslam_tpu_torch.eval import trajectory as ttraj
from vslam_tpu_torch.io import checkpoint as tckpt
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.system.engine import SlamEngine as TEngine
from vslam_tpu_torch.tracking.tracker import PoseTracker

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

EVENTS = ("n_local_maps", "n_closures", "n_optimizations", "n_merged_landmarks",
          "n_track_breaks", "n_landmarks", "n_ba_runs")


def modular(cfg):
    cfg.tracking.use_fused_tracker = False
    # One device, as the port (the harness gives JAX 8 virtual devices).
    cfg.parallelism.shard_descriptor_db = False
    cfg.parallelism.shard_landmarks = False
    return cfg


def _run(eng, frames, ate_rmse, poses):
    for left, right in frames:
        eng.process(left, right)
    traj = np.asarray(eng.trajectory)
    return dict(rep=eng.report(), traj=traj, ate=float(ate_rmse(traj, poses)[0]),
                closures=[(c.query_id, c.reference_id) for c in eng.world_map.closures])


@pytest.fixture(scope="module")
def circle():
    poses = tsyn.circle_trajectory(N_FRAMES, radius=7.0)
    w = tsyn.make_world(tcam.make_camera(**CAM_ARGS, device="cpu"), n_points=1500, seed=21,
                        poses=poses)
    return w, [tsyn.render_frame(w, t)[:2] for t in range(N_FRAMES)]


@pytest.mark.parametrize("border", [12, 20])
def test_modular_closed_loop_matches_jax(circle, border):
    w, frames = circle
    jeng = JEngine(jcam.make_camera(**CAM_ARGS), modular(closed_loop_config(JConfig, border)),
                   landmark_capacity=8192)
    teng = TEngine(tcam.make_camera(**CAM_ARGS, device="cpu"),
                   modular(closed_loop_config(TConfig, border)), landmark_capacity=8192,
                   device="cpu")
    assert isinstance(teng.tracker, PoseTracker) and teng.relocalizer.ring_provider is None
    j = _run(jeng, frames, jtraj.ate_rmse, w.poses)
    t = _run(teng, frames, ttraj.ate_rmse, w.poses)
    for k in EVENTS:
        assert t["rep"][k] == j["rep"][k], k
    assert t["closures"] == j["closures"] and len(t["closures"]) >= 1
    assert t["rep"]["n_optimizations"] >= 1 and t["rep"]["n_merged_landmarks"] > 0
    assert t["rep"]["n_track_breaks"] == 0
    if border == 12:
        assert np.abs(t["traj"][:, :3, 3] - j["traj"][:, :3, 3]).max() <= 1e-3
    assert abs(t["ate"] - j["ate"]) <= 0.02, (t["ate"], j["ate"])


@pytest.fixture(scope="module")
def ba_engines():
    w = tsyn.make_world(tcam.make_camera(**BA_CAM_ARGS, device="cpu"), n_frames=36,
                        n_points=2500, seed=8, step=0.4, turn_rate=0.004)
    frames = [tsyn.render_frame(w, t)[:2] for t in range(36)]

    def cfg(cls):
        c = modular(ba_cfg(cls, True))
        c.framepoint_generation.border_pixels = 12
        return c

    jeng = JEngine(jcam.make_camera(**BA_CAM_ARGS), cfg(JConfig), landmark_capacity=16384)
    teng = TEngine(tcam.make_camera(**BA_CAM_ARGS, device="cpu"), cfg(TConfig),
                   landmark_capacity=16384, device="cpu")
    return (w, _run(jeng, frames, jtraj.ate_rmse, w.poses),
            _run(teng, frames, ttraj.ate_rmse, w.poses), jeng, teng, cfg)


def test_modular_engine_with_ba_matches_jax(ba_engines):
    _, j, t, _, _, _ = ba_engines
    assert t["rep"]["n_ba_runs"] == j["rep"]["n_ba_runs"] >= 2
    assert t["rep"]["n_local_maps"] == j["rep"]["n_local_maps"]
    assert t["rep"]["stage_table"]["bundle_adjustment"]["calls"] >= 1
    assert np.abs(t["traj"][:, :3, 3] - j["traj"][:, :3, 3]).max() <= 1e-3
    assert t["ate"] <= 0.05 and abs(t["ate"] - j["ate"]) <= 1e-3, (t["ate"], j["ate"])


def _same_state(a, b):
    """Two engines' (either package) map state: table, allocator, tracker
    scalars, local maps."""
    ta, tb = a.tracker, b.tracker
    for k in ("xyz_w", "n_updates", "last_seen", "valid", "origin_kf"):
        np.testing.assert_array_equal(np.asarray(getattr(ta.table, k)),
                                      np.asarray(getattr(tb.table, k)), k)
    np.testing.assert_array_equal(np.asarray(ta.table.desc).view(np.int32),
                                  np.asarray(tb.table.desc).view(np.int32))
    assert ta.allocator._next == tb.allocator._next
    assert list(ta.allocator._free) == list(tb.allocator._free)
    assert ta.controller.threshold == tb.controller.threshold
    assert (ta.radius_px, ta.desc_gate, ta.frame_idx, ta.kf_count) == \
        (tb.radius_px, tb.desc_gate, tb.frame_idx, tb.kf_count)
    np.testing.assert_array_equal(ta.T_world_cam, tb.T_world_cam)
    assert len(a.world_map.local_maps) == len(b.world_map.local_maps)
    for ma, mb in zip(a.world_map.local_maps, b.world_map.local_maps):
        np.testing.assert_array_equal(ma.landmark_slots, mb.landmark_slots)
        np.testing.assert_array_equal(np.asarray(ma.desc).view(np.int32),
                                      np.asarray(mb.desc).view(np.int32))


def test_modular_checkpoints_load_across_packages(ba_engines, tmp_path):
    _, _, _, jeng, teng, cfg = ba_engines
    teng.tracker.allocator.release([3, 5])  # a non-empty free list rides along
    jeng.tracker.allocator.release([3, 5])
    tckpt.save_checkpoint(teng, str(tmp_path / "port.npz"))
    jckpt.save_checkpoint(jeng, str(tmp_path / "jax.npz"))
    j_from_port = JEngine(jcam.make_camera(**BA_CAM_ARGS), cfg(JConfig), landmark_capacity=16384)
    jckpt.load_checkpoint(j_from_port, str(tmp_path / "port.npz"))
    t_from_jax = TEngine(tcam.make_camera(**BA_CAM_ARGS, device="cpu"), cfg(TConfig),
                         landmark_capacity=16384, device="cpu")
    tckpt.load_checkpoint(t_from_jax, str(tmp_path / "jax.npz"))
    _same_state(j_from_port, teng)
    _same_state(t_from_jax, jeng)
    assert t_from_jax.tracker.prev_frame is None  # the next frame re-seeds tracking
    assert t_from_jax.relocalizer.n_rows == jeng.relocalizer.n_rows


def test_process_prestaged_refuses_the_modular_tracker():
    eng = TEngine(tcam.make_camera(**CAM_ARGS, device="cpu"), modular(TConfig()),
                  landmark_capacity=1024, device="cpu")
    with pytest.raises(ValueError, match="fused tracker"):
        eng.process_prestaged(None)
