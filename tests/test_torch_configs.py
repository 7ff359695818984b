"""Port parity for the shipped stereo configurations: the open-loop
SlamEngine of each package loads configurations/configuration_kitti.yaml
(FAST + BRIEF256 over 2 octaves), configuration_euroc.yaml (FAST +
BRIEF256R over 2 octaves) and configuration_kitti_fast.yaml (one octave,
bin 24) through its own load_config, with relocalization off, and runs
one synthetic sequence (192 x 512).

JAX on the CPU takes its staged front-end, and so does the port for the
first two (for kitti_fast the port runs K1, whose keypoints and
descriptors equal the staged ones >= 16 px from the edge), so the
keypoints are identical.  The pose solve sums in another order, so the
runs are held to: the same local-map and break counts, ATE <= 0.05 m
each, the first 4 positions within 1e-3 m and every position within
5 cm.
"""

import os

import numpy as np
import pytest
import torch

from vslam_tpu.eval import trajectory as jtraj
from vslam_tpu.frontend import brief as jbrief
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.io.config import load_config as jload
from vslam_tpu.ops import camera as jcam
from vslam_tpu.system.engine import SlamEngine as JEngine
from vslam_tpu_torch.eval import trajectory as ttraj
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.io.config import load_config as tload
from vslam_tpu_torch.system.engine import SlamEngine as TEngine

# Under pytest-xdist each core runs a worker process; torch's own intra-op
# threads on top of that oversubscribe the CPU and slow these tests ~30x.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_ARGS = dict(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                rows=192, cols=512)


@pytest.fixture(scope="module")
def sequence():
    jc = jcam.make_camera(**CAM_ARGS)
    world = jsyn.make_world(jc, n_frames=16, n_points=1500, seed=42, step=0.45)
    frames = [jsyn.render_frame(world, t)[:2] for t in range(16)]
    tc = from_jax.camera_from_numpy(np.asarray(jc.K), np.asarray(jc.baseline_m),
                                    jc.rows, jc.cols)
    return jc, tc, world, frames


def _open_loop(load, name):
    cfg = load(os.path.join(REPO, "configurations", f"configuration_{name}.yaml"))
    cfg.command_line.option_disable_relocalization = True
    return cfg


@pytest.mark.parametrize("name,n_frames", [("kitti", 16), ("euroc", 8), ("kitti_fast", 8)])
def test_shipped_configuration_engines_agree(sequence, monkeypatch, name, n_frames):
    monkeypatch.setattr(jbrief, "_ROT_FILTERS_CACHE", {})
    jc, tc, world, frames = sequence
    jcfg, tcfg = _open_loop(jload, name), _open_loop(tload, name)
    fp = tcfg.framepoint_generation
    assert (fp.detector_number_of_octaves, fp.descriptor_type, fp.bin_size_pixels) == {
        "kitti": (2, "BRIEF256", 16), "euroc": (2, "BRIEF256R", 16),
        "kitti_fast": (1, "BRIEF256", 24)}[name]
    jeng = JEngine(jc, jcfg, landmark_capacity=4096)
    teng = TEngine(tc, tcfg, landmark_capacity=4096, device="cpu")
    for left, right in frames[:n_frames]:
        jeng.process(left, right)
        teng.process(left, right)
    jtr, ttr = jeng.trajectory, teng.trajectory
    jrep, trep = jeng.report(), teng.report()
    poses = world.poses[:n_frames]
    j_ate = jtraj.ate_rmse(jtr, poses)[0]
    t_ate = ttraj.ate_rmse(ttr, poses)[0]
    assert trep["n_local_maps"] == jrep["n_local_maps"] >= 1
    assert trep["n_track_breaks"] == jrep["n_track_breaks"] == 0
    assert j_ate <= 0.05 and t_ate <= 0.05, (j_ate, t_ate)
    assert np.abs(ttr[:4, :3, 3] - jtr[:4, :3, 3]).max() <= 1e-3
    assert np.abs(ttr[:, :3, 3] - jtr[:, :3, 3]).max() <= 0.05

