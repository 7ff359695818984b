"""Port parity for the slice as a whole: the open-loop tracker step on
state carried across from the JAX tracker, and the two open-loop
SlamEngines on one synthetic sequence (192 x 512, 16 frames).

Tolerances:
  (a) one step on carried state: integer state (slots, next_slot,
      free_count, kf_count, valid masks) exact; pose to atol=1e-4 (the
      pose solve sums in another order).
  (b) whole engines: JAX on the CPU takes its staged front-end, whose
      intra-bin tie order differs from K1's, so keypoints — and bits —
      differ; the runs are held to the same event counts (local maps,
      breaks), ATE <= 0.05 m each, and positions within 5 cm per frame.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.eval import trajectory as jtraj
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.mapping import frame as jframe
from vslam_tpu.ops import camera as jcam
from vslam_tpu.system.engine import SlamEngine as JEngine
from vslam_tpu.tracking import fused as jfused
from vslam_tpu.tracking.tracker import FusedPoseTracker as JTracker
from vslam_tpu_torch.eval import trajectory as ttraj
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.system.engine import SlamEngine as TEngine
from vslam_tpu_torch.tracking import fused as tfused
from vslam_tpu_torch.tracking import tracker as ttracker

# Under pytest-xdist each core runs a worker process; torch's own intra-op
# threads on top of that oversubscribe the CPU and slow these tests ~30x.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAM_ARGS = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                rows=192, cols=512)
N_FRAMES = 16


def _config(cls):
    cfg = cls()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.command_line.option_disable_relocalization = True
    return cfg


@pytest.fixture(scope="module")
def sequence():
    jc = jcam.make_camera(**CAM_ARGS)
    world = jsyn.make_world(jc, n_frames=N_FRAMES, n_points=1500, seed=42, step=0.45)
    frames = [jsyn.render_frame(world, t)[:2] for t in range(N_FRAMES)]
    tc = from_jax.camera_from_numpy(np.asarray(jc.K), np.asarray(jc.baseline_m),
                                    jc.rows, jc.cols)
    return jc, tc, world, frames


def _np_state(state):
    out = {k: np.asarray(v) for k, v in state._asdict().items()
           if k not in ("prev", "table")}
    out["prev"] = {k: np.asarray(v) for k, v in state.prev._asdict().items()}
    out["table"] = {k: np.asarray(v) for k, v in state.table._asdict().items()}
    return out


def test_step_tail_on_carried_state_matches_jax(sequence):
    jc, tc, _, frames = sequence
    cfg = _config(JConfig)
    jt = JTracker(jc, cfg, landmark_capacity=4096)
    for t in range(6):
        jt.compute(*frames[t])
    state = jt.state
    pair = np.stack(frames[6]).astype(np.uint8).astype(np.float32)
    img_l, img_r = jnp.asarray(pair[0]), jnp.asarray(pair[1])
    params = jt.params
    cur, n_kp, n_fp, planes = jax.jit(
        lambda s, l, r: jfused._front_end(jc, params, s, l, r))(state, img_l, img_r)
    eye = jnp.eye(4)

    @jax.jit
    def jax_tail(s, c, nk, nf, pl):
        return jfused._step_tail(jc, params, jframe.track_and_align, s, c, nk, nf,
                                 pl, img_l, img_r, jnp.asarray(True), eye,
                                 jnp.asarray(False))[0]

    tparams = ttracker.params_from_config(tc, _config(TConfig), torch.device("cpu"))
    tstate = from_jax.tracker_state_from_numpy(_np_state(state))
    tcur = from_jax.frame_state_from_numpy({k: np.asarray(v) for k, v in cur._asdict().items()})
    tout = tfused._step_tail(
        tc, tparams, tstate, tcur, torch.tensor(int(n_kp), dtype=torch.int32),
        torch.tensor(int(n_fp), dtype=torch.int32),
        torch.from_numpy(np.asarray(planes).view(np.int32).copy()),
        torch.from_numpy(pair[0]), torch.from_numpy(pair[1]), True)
    jout = _np_state(jax_tail(state, cur, n_kp, n_fp, planes))
    got = from_jax.tracker_state_to_numpy(tout)

    assert int(got["next_slot"]) > 0  # landmarks exist: a real mid-run step
    for name in ("next_slot", "free_count", "kf_count", "frame_idx", "has_prev",
                 "localizing", "frames_since_kf", "kf_n", "kf_slots", "free_list"):
        np.testing.assert_array_equal(got[name], jout[name], err_msg=name)
    for name in ("valid", "landmark_slot", "track_len", "reliable", "desc"):
        np.testing.assert_array_equal(got["prev"][name], jout["prev"][name], err_msg=name)
    for name in ("valid", "n_updates", "last_seen", "origin_kf", "protected", "desc"):
        np.testing.assert_array_equal(got["table"][name], jout["table"][name],
                                      err_msg=name)
    np.testing.assert_allclose(got["T_world_cam"], jout["T_world_cam"], atol=1e-4)
    np.testing.assert_allclose(got["table"]["xyz_w"], jout["table"]["xyz_w"], atol=1e-3)
    for name in ("threshold", "radius_px", "desc_gate"):
        np.testing.assert_allclose(got[name], jout[name], rtol=1e-6, err_msg=name)


def test_open_loop_engines_agree(sequence):
    jc, tc, world, frames = sequence
    jeng = JEngine(jc, _config(JConfig), landmark_capacity=4096)
    teng = TEngine(tc, _config(TConfig), landmark_capacity=4096, device="cpu")
    for left, right in frames:
        jeng.process(left, right)
        teng.process(left, right)
    jtr, ttr = jeng.trajectory, teng.trajectory
    jrep, trep = jeng.report(), teng.report()
    j_ate = jtraj.ate_rmse(jtr, world.poses)[0]
    t_ate = ttraj.ate_rmse(ttr, world.poses)[0]
    assert trep["n_local_maps"] == jrep["n_local_maps"] >= 2
    assert trep["n_track_breaks"] == jrep["n_track_breaks"] == 0
    assert j_ate <= 0.05 and t_ate <= 0.05, (j_ate, t_ate)
    assert np.abs(ttr[:, :3, 3] - jtr[:, :3, 3]).max() <= 0.05


def test_synthetic_sequence_and_ate_match_jax(sequence, tmp_path):
    """The port's own copies of the sequence generator and the evaluator
    reproduce the JAX package's exactly."""
    jc, _, world, frames = sequence
    tworld = tsyn.make_world(tcam.make_camera(**CAM_ARGS, device="cpu"), n_frames=N_FRAMES,
                             n_points=1500, seed=42, step=0.45)
    np.testing.assert_array_equal(tworld.poses, world.poses)
    np.testing.assert_array_equal(tworld.points_w, world.points_w)
    for t in (0, N_FRAMES - 1):
        for a, b in zip(tsyn.render_frame(tworld, t)[:2], frames[t]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsyn.circle_trajectory(12, radius=13.0),
                                  jsyn.circle_trajectory(12, radius=13.0))
    est = world.poses.copy()
    est[:, :3, 3] += np.random.default_rng(1).normal(0, 0.05, (N_FRAMES, 3))
    for align in (True, False):
        t_out = ttraj.ate_rmse(est, world.poses, align=align)
        j_out = jtraj.ate_rmse(est, world.poses, align=align)
        np.testing.assert_allclose(t_out[0], j_out[0], rtol=1e-12)
        np.testing.assert_allclose(t_out[1], j_out[1], rtol=1e-12)
    ttraj.write_kitti(str(tmp_path / "t.txt"), est)
    jtraj.write_kitti(str(tmp_path / "j.txt"), est)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
