"""The KITTI-00-scale run (vslam_tpu_torch/eval/scale_run.py) against the
JAX package's scripts/scale_run.py on the CPU.

  * configuration: run_scale builds the JAX script's configuration field
    for field, with its engine arguments and camera (each script's
    SlamEngine replaced by one that records them and stops the run).
  * events: the same circuit cut to a small size (a 10 m circle through
    4,000 points, interspace 6) through both scripts: the local maps,
    closures, pose-graph optimizations, tracking breaks and merged
    landmarks.  The port takes K1's plain version at KITTI's border of
    20, whose tie order within a bin differs from the JAX package's
    staged front-end on the CPU (ROADMAP, Queue 3): merged landmarks are
    held within 20% and the ATE to the run's own limit (ate_ok) and
    within 0.02 m of JAX's.  At the card's drain cadence (harvest every
    8 frames) closures resolve later: held to JAX's local maps, its
    closure and optimization counts as lower bounds of 1, 0 breaks and
    ate_ok.  The 64-frame pair takes minutes (JAX at 376 x 1241 on the
    CPU), so it is marked slow; a 16-frame pair stays in tier 1.

The JAX script's warm-ups are replaced by no-ops (on the CPU they only
compile), and both scripts run on one device (the harness gives JAX 8
virtual devices, on which its engine would shard the database search).
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from vslam_tpu.backend import pose_graph as jpg
from vslam_tpu.loop import relocalizer as jrl
from vslam_tpu.system import ba_runner as jba_runner
from vslam_tpu.system import engine as jengine
from vslam_tpu_torch.eval import scale_run
from vslam_tpu_torch.loop import relocalizer as trl
from vslam_tpu_torch.system import engine as tengine
from vslam_tpu_torch.tracking import fused as tfused

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_DEVICE = {"parallelism.shard_descriptor_db": False,
              "parallelism.shard_landmarks": False}
SMALL = dict(radius=10.0, n_points=4000, block=16,
             config_overrides={"relocalization.preliminary_minimum_interspace_queries": 6,
                               **ONE_DEVICE})


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_scale_run", os.path.join(REPO, "scripts", "scale_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Built(Exception):
    pass


@pytest.mark.parametrize("kwargs", [
    {}, {"enable_ba": False, "landmark_capacity": 32768},
    {"config_overrides": {"relocalization.preliminary_minimum_interspace_queries": 6,
                          "tracking.batch_frontend": True}},
], ids=["default", "no-ba", "overrides"])
def test_configuration_matches_the_jax_script(kwargs, monkeypatch):
    built = {}

    def recorder(name):
        def engine(cam, cfg, landmark_capacity=65536, **_):
            built[name] = (cam, cfg, landmark_capacity)
            raise _Built
        return engine

    monkeypatch.setattr(jengine, "SlamEngine", recorder("jax"))
    monkeypatch.setattr(tengine, "SlamEngine", recorder("port"))
    for run in (_jax_script().run_scale, scale_run.run_scale):
        with pytest.raises(_Built):
            run(n_frames=8, n_points=100, **kwargs)
    (jcam, jcfg, jcap), (tcam, tcfg, tcap) = built["jax"], built["port"]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcap == jcap
    np.testing.assert_array_equal(tcam.K.numpy(), np.asarray(jcam.K))
    assert float(tcam.baseline_m) == float(jcam.baseline_m)
    assert (tcam.rows, tcam.cols) == (jcam.rows, jcam.cols)


def _no_jax_warm_ups(monkeypatch):
    for mod, name in ((jpg, "warm_hierarchical_buckets"), (jba_runner, "warm_windowed_ba"),
                      (jrl, "warm_icp_batches")):
        monkeypatch.setattr(mod, name, lambda *a, **k: None)


def _port_at_harvest(harvest, monkeypatch):
    class Engine(tengine.SlamEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.tracker.harvest_every = harvest

    monkeypatch.setattr(tengine, "SlamEngine", Engine)


def _runs(n_frames, harvests, monkeypatch):
    kwargs = dict(n_frames=n_frames, laps=n_frames / 64, **SMALL)
    _no_jax_warm_ups(monkeypatch)
    jax_out = _jax_script().run_scale(**kwargs)
    port = {}
    for harvest in harvests:
        tfused.clear_programs()
        trl.clear_icp_programs()
        _port_at_harvest(harvest, monkeypatch)
        port[harvest] = scale_run.run_scale(**kwargs, device="cpu")
    return jax_out, port


EVENTS = ("n_local_maps", "n_closures", "n_pose_graph_optimizations", "tracking_breaks")


def _hold(jax_out, port, harvest):
    assert set(port) == set(jax_out)
    assert port["tracking_breaks"] == 0 and port["ate_ok"], port
    if harvest == 1:
        assert {k: port[k] for k in EVENTS} == {k: jax_out[k] for k in EVENTS}
        assert abs(port["n_merged_landmarks"] - jax_out["n_merged_landmarks"]) <= (
            0.2 * jax_out["n_merged_landmarks"])
        assert abs(port["ate_rmse_m"] - jax_out["ate_rmse_m"]) <= 0.02
    else:
        assert port["n_local_maps"] == jax_out["n_local_maps"]
        assert port["n_closures"] >= min(jax_out["n_closures"], 1)
        assert port["n_pose_graph_optimizations"] >= min(
            jax_out["n_pose_graph_optimizations"], 1)


def test_small_scale_run_matches_the_jax_script(monkeypatch):
    jax_out, port = _runs(16, (1,), monkeypatch)
    assert jax_out["n_frames"] == 16 and jax_out["n_local_maps"] >= 3
    _hold(jax_out, port[1], 1)


@pytest.mark.slow
def test_scale_run_closes_its_loop_as_the_jax_script(monkeypatch):
    jax_out, port = _runs(64, (1, 8), monkeypatch)
    assert jax_out["n_closures"] >= 1 and jax_out["n_merged_landmarks"] > 0
    for harvest, out in port.items():
        _hold(jax_out, out, harvest)
