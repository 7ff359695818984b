"""The closed-loop SlamEngine (relocalization, closure ICP, pose graph,
landmark merging; BA off) against the JAX engine on the CPU.

The sequence is a 48-frame circle of radius 7 m at 192 x 512, which
closes its loop twice in both packages.  Both drain every frame on the
CPU, so closure work resolves at the same frames.

  * border 12: both packages take the staged front-end, which the port
    reproduces bit for bit, so keyframes and closure candidates start
    from the same bits.  Held to JAX's event counts (local maps,
    closures with their (query, reference) ids, pose-graph optimizations,
    breaks), merged landmarks within 20% of JAX's, ATE <= 0.10 m and
    within 0.02 m of JAX's, closure transforms within 1e-3 and every
    frame's position within 1e-3 m of JAX's (f32 sums in another order;
    measured: 7e-5 and 8e-5).
  * border 20: the port takes K1's plain version, whose intra-bin tie
    order differs from JAX's staged path; held to JAX's event counts and
    ATE <= 0.10 m.
  * the card's drain cadence on the CPU: the port harvests every 8
    frames through prestage + process_prestaged, so closures resolve
    later and their corrections reach frames and snapshots still in
    flight (applied at harvest).  Held to JAX's local-map count, >= 1
    closure and optimization, 0 breaks and ATE <= 0.10 m.
"""

import os

import numpy as np
import pytest
import torch

from vslam_tpu.eval import trajectory as jtraj
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.io.config import ParameterCollection as JConfig
from vslam_tpu.ops import camera as jcam
from vslam_tpu.system.engine import SlamEngine as JEngine
from vslam_tpu_torch.eval import trajectory as ttraj
from vslam_tpu_torch.io import synthetic as tsyn
from vslam_tpu_torch.io.config import ParameterCollection as TConfig
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.system.engine import SlamEngine as TEngine
from vslam_tpu_torch.utils import log

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAM_ARGS = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4, rows=192, cols=512)
N_FRAMES = 48
EVENTS = ("n_local_maps", "n_closures", "n_optimizations", "n_track_breaks")
CLOSURE_STAGES = ("relocalization", "reloc_vote_icp", "pose_graph_optimization",
                  "pg_assembly", "pg_junction_solve", "pg_distribution", "pg_propagate",
                  "landmark_merging")


def closed_loop_config(cls, border):
    cfg = cls()
    cfg.framepoint_generation.capacity = 256
    cfg.framepoint_generation.bin_size_pixels = 16
    cfg.framepoint_generation.border_pixels = border
    cfg.world_map.minimum_distance_traveled_for_local_map = 0.8
    cfg.world_map.minimum_number_of_frames_for_local_map = 2
    cfg.relocalization.preliminary_minimum_interspace_queries = 6
    cfg.relocalization.preliminary_minimum_matching_ratio = 0.08
    cfg.relocalization.icp_minimum_number_of_inliers = 8
    cfg.relocalization.icp_minimum_inlier_ratio = 0.3
    return cfg


@pytest.fixture(scope="module")
def world():
    poses = tsyn.circle_trajectory(N_FRAMES, radius=7.0)
    w = tsyn.make_world(tcam.make_camera(**CAM_ARGS, device="cpu"), n_points=1500, seed=21, poses=poses)
    frames = [tsyn.render_frame(w, t)[:2] for t in range(N_FRAMES)]
    return w, frames


def _summary(eng, traj, world, ate_rmse):
    rep = eng.report()
    return dict(rep=rep, lite=eng.report_lite(), traj=traj,
                ate=float(ate_rmse(traj, world.poses)[0]),
                closures=[(c.query_id, c.reference_id) for c in eng.world_map.closures],
                T=[np.asarray(c.T_ref_query) for c in eng.world_map.closures])


@pytest.fixture(scope="module")
def runs(world):
    """JAX and port engines, frame by frame, at borders 12 and 20."""
    w, frames = world
    jc = jcam.make_camera(**CAM_ARGS)
    out = {}
    for border in (12, 20):
        jcfg = closed_loop_config(JConfig, border)
        # One device, as the port: the harness gives JAX 8 virtual CPU
        # devices, on which its engine would shard the database search.
        jcfg.parallelism.shard_descriptor_db = False
        jcfg.parallelism.shard_landmarks = False
        jeng = JEngine(jc, jcfg, landmark_capacity=8192)
        log.chronometers.clear()
        teng = TEngine(tcam.make_camera(**CAM_ARGS, device="cpu"), closed_loop_config(TConfig, border),
                       landmark_capacity=8192, device="cpu")
        for left, right in frames:
            jeng.process(left, right)
        for left, right in frames:
            teng.process(left, right)
        out[border] = (_summary(jeng, np.asarray(jeng.trajectory), w, jtraj.ate_rmse),
                       _summary(teng, teng.trajectory, w, ttraj.ate_rmse))
    jsyn_poses = jsyn.circle_trajectory(N_FRAMES, radius=7.0)
    np.testing.assert_array_equal(jsyn_poses, w.poses)  # one sequence for both
    return out


def test_closed_loop_engines_agree_on_the_staged_front_end(runs):
    j, t = runs[12]
    for k in EVENTS:
        assert t["rep"][k] == j["rep"][k], k
    assert j["rep"]["n_closures"] >= 2 and j["rep"]["n_track_breaks"] == 0
    assert t["closures"] == j["closures"]
    for a, b in zip(t["T"], j["T"]):
        np.testing.assert_allclose(a, b, atol=1e-3)
    nj, nt = j["rep"]["n_merged_landmarks"], t["rep"]["n_merged_landmarks"]
    assert nj > 0 and abs(nt - nj) <= 0.2 * nj, (nt, nj)
    assert t["ate"] <= 0.10 and abs(t["ate"] - j["ate"]) <= 0.02, (t["ate"], j["ate"])
    assert np.abs(t["traj"][:, :3, 3] - j["traj"][:, :3, 3]).max() <= 1e-3


def test_closed_loop_engines_agree_on_k1(runs):
    j, t = runs[20]
    for k in EVENTS:
        assert t["rep"][k] == j["rep"][k], k
    assert t["rep"]["n_closures"] >= 1 and t["rep"]["n_merged_landmarks"] > 0
    assert t["ate"] <= 0.10 and j["ate"] <= 0.10, (t["ate"], j["ate"])


def test_closed_loop_report_carries_the_closure_stages(runs):
    _, t = runs[20]
    rep = t["rep"]
    for stage in CLOSURE_STAGES:
        assert rep["stage_table"][stage]["calls"] >= 1, stage
    assert rep["n_ba_runs"] == 0
    for k in EVENTS:
        assert t["lite"][k] == rep[k], k


def test_card_drain_cadence_on_the_cpu(world, runs):
    """Harvest every 8 frames, as on the card (every frames_per_chunk):
    the pose graph's corrections then land while frames are in flight."""
    w, frames = world
    eng = TEngine(tcam.make_camera(**CAM_ARGS, device="cpu"), closed_loop_config(TConfig, 12),
                  landmark_capacity=8192, device="cpu")
    eng.tracker.harvest_every = 8
    handles = eng.tracker.prestage(frames)
    assert [len(h) for h in handles] == [8] * (N_FRAMES // 8)
    for h in handles:
        eng.process_prestaged(h)
    traj = eng.trajectory
    rep = eng.report()
    ate = ttraj.ate_rmse(traj, w.poses)[0]
    assert traj.shape == (N_FRAMES, 4, 4) and np.all(np.isfinite(traj))
    assert rep["n_local_maps"] == runs[12][0]["rep"]["n_local_maps"]
    assert rep["n_closures"] >= 1 and rep["n_optimizations"] >= 1
    assert rep["n_track_breaks"] == 0 and ate <= 0.10, ate
