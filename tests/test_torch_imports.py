"""The port's boundaries: no jax import, no silent fallback, and explicit
configurations an earlier slice refused now run."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vslam_tpu_torch.io import config as tconfig
from vslam_tpu_torch.io import from_jax
from vslam_tpu_torch.ops import camera as tcam
from vslam_tpu_torch.system.engine import SlamEngine
from vslam_tpu_torch.tracking.tracker import FusedPoseTracker, PoseTracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = tcam.make_camera(fx=300, fy=300, cx=256, cy=96, baseline_m=0.4, rows=192, cols=512,
                       device="cpu")


def _open_loop():
    cfg = tconfig.ParameterCollection()
    cfg.command_line.option_disable_relocalization = True
    return cfg


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import vslam_tpu_torch.system.engine, vslam_tpu_torch.io.from_jax\n"
        "import vslam_tpu_torch.loop.relocalizer, vslam_tpu_torch.backend.pose_graph\n"
        "import vslam_tpu_torch.mapping.merging, vslam_tpu_torch.utils.log\n"
        "import vslam_tpu_torch.io.synthetic, vslam_tpu_torch.eval.trajectory\n"
        "import vslam_tpu_torch.system.cli, vslam_tpu_torch.io.datasets\n"
        "import vslam_tpu_torch.io.checkpoint, vslam_tpu_torch.viz.plots\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'vslam_tpu.'))\n"
        "       or m in ('vslam_tpu', 'cv2', 'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env,
                   timeout=120)


def test_every_port_module_imports_with_jax_blocked():
    """Every module of vslam_tpu_torch imports in a process where importing
    jax, vslam_tpu, cv2 or matplotlib raises (cv2 and matplotlib are
    optional: no module imports them at module level)."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'vslam_tpu', 'cv2',\n"
        "                                  'matplotlib'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import vslam_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vslam_tpu_torch.__path__,\n"
        "                                               'vslam_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert {'vslam_tpu_torch.backend.ba', 'vslam_tpu_torch.system.ba_runner',\n"
        "        'vslam_tpu_torch.frontend.depth', 'vslam_tpu_torch.frontend.orb',\n"
        "        'vslam_tpu_torch.frontend.detect', 'vslam_tpu_torch.io.image',\n"
        "        'vslam_tpu_torch.io.datasets', 'vslam_tpu_torch.io.rectification',\n"
        "        'vslam_tpu_torch.io.g2o_io', 'vslam_tpu_torch.io.checkpoint',\n"
        "        'vslam_tpu_torch.system.cli', 'vslam_tpu_torch.viz.plots',\n"
        "        'vslam_tpu_torch.eval.workloads'} <= set(names), names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env,
                         timeout=120, capture_output=True, text=True)
    assert int(out.stdout.split()[-1]) >= 30


def _imported_modules(path) -> set:
    """Every module an import statement of a file names, at any depth
    (an `from a import b` names both a and a.b)."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def test_ops_imports_nothing_of_the_front_end():
    """ops/ is the bottom layer: it builds, launches, counts and captures
    device work, and no module of it imports vslam_tpu_torch.frontend."""
    paths = glob.glob(os.path.join(REPO, "vslam_tpu_torch", "ops", "*.py"))
    assert any(p.endswith("cuda_build.py") for p in paths)
    bad = {os.path.basename(p): sorted(m for m in _imported_modules(p)
                                       if m.startswith("vslam_tpu_torch.frontend"))
           for p in paths}
    assert not any(bad.values()), bad


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamEngine(CAM, _open_loop(), landmark_capacity=1024, device="cuda")


def _default_device_calls():
    from vslam_tpu_torch.backend import pose_graph
    from vslam_tpu_torch.loop.relocalizer import Relocalizer
    from vslam_tpu_torch.mapping import frame, landmarks

    eye = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    ba, rgbd = _open_loop(), _open_loop()
    ba.graph_optimization.enable_full_bundle_adjustment = True
    rgbd.command_line.tracker_mode = "RGB_DEPTH"
    return {
        "SlamEngine": lambda: SlamEngine(CAM, _open_loop(), landmark_capacity=1024).device,
        "SlamEngine with BA": lambda: SlamEngine(CAM, ba, landmark_capacity=1024).device,
        "SlamEngine RGB-D": lambda: SlamEngine(CAM, rgbd, landmark_capacity=1024).device,
        "FusedPoseTracker": lambda: FusedPoseTracker(CAM, _open_loop(), 1024).device,
        "Relocalizer": lambda: Relocalizer(tconfig.ParameterCollection().relocalization,
                                           capacity=256).device,
        "make_camera": lambda: tcam.make_camera(fx=300, fy=300, cx=256, cy=96,
                                                baseline_m=0.4, rows=192, cols=512).device,
        "empty_table": lambda: landmarks.empty_table(16).xyz_w.device,
        "empty_frame": lambda: frame.empty_frame(16).uv4.device,
        "optimize_pose_graph_hierarchical": lambda: pose_graph.optimize_pose_graph_hierarchical(
            eye, eye[:2], np.ones(2, np.float32), [])[0].shape,
    }


@pytest.mark.parametrize("name", ["SlamEngine", "SlamEngine with BA", "SlamEngine RGB-D",
                                  "FusedPoseTracker", "Relocalizer",
                                  "make_camera", "empty_table", "empty_frame",
                                  "optimize_pose_graph_hierarchical"])
def test_entry_points_run_on_the_card_by_default(name):
    """Called without `device`, each entry point builds on the card; on a
    machine without one it raises RuntimeError naming CUDA (no fallback)."""
    call = _default_device_calls()[name]
    if torch.cuda.is_available():
        got = call()  # the pose graph returns host arrays: it only has to run
        assert not isinstance(got, torch.device) or got.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# Configurations an earlier slice refused, ported since (FAST-ICP, ROADMAP
# item 16; the modular tracker, item 19), with what shows the engine took it.
_TAKEN = {
    "aligner_type": lambda eng: eng.relocalizer.params.aligner_type == "FAST-ICP",
    "use_fused_tracker": lambda eng: isinstance(eng.tracker, PoseTracker),
}


@pytest.mark.parametrize("group,key,value", [
    ("relocalization", "aligner_type", "FAST-ICP"),
    ("tracking", "use_fused_tracker", False),
])
def test_unported_engine_configurations_raise(group, key, value):
    """No configuration of this list raises any more: the engine constructs
    with it and steps one frame."""
    cfg = tconfig.ParameterCollection()  # closed loop: ported
    setattr(getattr(cfg, group), key, value)
    eng = SlamEngine(CAM, cfg, landmark_capacity=1024, device="cpu")
    assert _TAKEN[key](eng)
    img = np.random.default_rng(0).uniform(0, 255, (192, 512)).astype(np.float32)
    T = eng.process(img, img)
    assert T.shape == (4, 4) and np.isfinite(T).all()
    assert eng.report()["total_frames"] == 1


def test_closed_loop_engine_constructs():
    eng = SlamEngine(CAM, tconfig.ParameterCollection(), landmark_capacity=1024,
                     device="cpu")
    assert not eng.open_loop
    assert eng.relocalizer.QUERY_CAP == eng.tracker.state.kf_desc.shape[1]


@pytest.mark.parametrize("name", ["tum", "icl", "xtion"])
def test_shipped_rgbd_configurations_construct(name):
    """configuration_tum.yaml, configuration_icl.yaml (BRIEF256) and
    configuration_xtion.yaml (ORB256, bilateral depth) build an RGB-D
    engine."""
    cfg = tconfig.load_config(os.path.join(REPO, "configurations", f"configuration_{name}.yaml"))
    eng = SlamEngine(CAM, cfg, landmark_capacity=1024, device="cpu")
    assert eng.tracker.mode == "depth" and eng.tracker.params.min_depth == 0.3
    assert eng.tracker.params.bilateral_depth == (name == "xtion")


def test_ba_and_rgbd_engines_construct():
    ba = tconfig.ParameterCollection()
    ba.graph_optimization.enable_full_bundle_adjustment = True
    assert SlamEngine(CAM, ba, landmark_capacity=1024, device="cpu").n_ba_runs == 0
    both = tconfig.ParameterCollection()
    both.graph_optimization.enable_full_bundle_adjustment = True
    both.command_line.tracker_mode = "RGB_DEPTH"
    with pytest.raises(ValueError, match="bundle adjustment"):
        SlamEngine(CAM, both, landmark_capacity=1024, device="cpu")


@pytest.mark.parametrize("group,key,value", [
    ("tracking", "batch_frontend", True),
])
def test_unported_tracker_modes_raise(group, key, value):
    """No tracker mode is left unported: the split front-end (ROADMAP item
    15) builds a tracker that buffers its frames into chunks."""
    cfg = _open_loop()
    setattr(getattr(cfg, group), key, value)
    tracker = FusedPoseTracker(CAM, cfg, landmark_capacity=1024, device="cpu")
    assert tracker.split and tracker.n_frames_in == 0


def test_reference_configurations_load():
    for name in sorted(os.listdir(os.path.join(REPO, "configurations"))):
        cfg = tconfig.load_config(os.path.join(REPO, "configurations", name))
        assert cfg.framepoint_generation.capacity > 0


def test_cpu_kernel_wrapper_runs_plain_version_and_counts_no_launch():
    from vslam_tpu_torch.frontend import fast_brief as fb

    before = fb.K1.launches
    imgs = torch.zeros((2, 48, 64))
    planes, score, rowmax, rowarg = fb.fast_brief_frontend_pair(imgs, torch.tensor(10.0))
    assert planes.shape == (2, 8, 48, 64) and planes.dtype == torch.int32
    assert score.shape == (2, 48, 64) and rowmax.shape == (2, 3, 128)
    assert rowarg.dtype == torch.int32
    assert fb.K1.launches == before


def test_state_converters_round_trip():
    rng = np.random.default_rng(0)
    frame = {
        "uv4": rng.normal(size=(8, 4)).astype(np.float32),
        "desc": rng.integers(0, 2**32, (8, 8), dtype=np.uint32),
        "p_cam": rng.normal(size=(8, 3)).astype(np.float32),
        "valid": rng.uniform(size=8) < 0.5,
        "track_len": rng.integers(0, 5, 8).astype(np.int32),
        "landmark_slot": rng.integers(-1, 9, 8).astype(np.int32),
        "reliable": rng.uniform(size=8) < 0.5,
    }
    back = from_jax.frame_state_to_numpy(from_jax.frame_state_from_numpy(frame))
    for k, v in frame.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
