"""`python -m vslam_tpu_torch` (run, eval, convert, bench) against the JAX
package's CLI on the CPU, on a KITTI directory written to tmp_path.

Both CLIs run in this process (`main([...])`) on a 10-frame straight
sequence at 192 x 512 with a configuration whose border (12) sends both
packages through the staged front-end, which the port reproduces bit for
bit.  Tolerances: estimated positions within 1e-4 m of JAX's (f32 sums
in another order), the keyframe count exact, the `eval` JSON within
1e-4 (one unit of its 4th decimal), `convert`'s files byte-identical to
JAX's for the same input.
"""

import functools
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from vslam_tpu.system import cli as jcli
from vslam_tpu_torch.eval import trajectory as ttraj
from vslam_tpu_torch.io import synthetic
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.system import cli as tcli

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 10
CONFIG = """\
framepoint_generation:
  capacity: 256
  bin_size_pixels: 16
  border_pixels: 12
world_map:
  minimum_distance_traveled_for_local_map: 0.6
  minimum_number_of_frames_for_local_map: 2
parallelism:
  shard_descriptor_db: false
  shard_landmarks: false
"""


@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_cli")
    for d in ("image_0", "image_1"):
        (root / d).mkdir()
    cam = cam_ops.make_camera(fx=300.0, fy=300.0, cx=256.0, cy=96.0, baseline_m=0.4,
                              rows=192, cols=512, device="cpu")
    world = synthetic.make_world(cam, n_frames=N_FRAMES, n_points=1500, seed=40, step=0.3)
    for t in range(N_FRAMES):
        il, ir, _ = synthetic.render_frame(world, t)
        cv2.imwrite(str(root / "image_0" / f"{t:06d}.png"), np.clip(il, 0, 255).astype(np.uint8))
        cv2.imwrite(str(root / "image_1" / f"{t:06d}.png"), np.clip(ir, 0, 255).astype(np.uint8))
    np.savetxt(root / "times.txt", np.arange(N_FRAMES) * 0.1)
    with open(root / "calib.txt", "w") as f:
        f.write("P0: 300 0 256 0 0 300 96 0 0 0 1 0\n")
        f.write(f"P1: 300 0 256 {-300 * 0.4} 0 300 96 0 0 0 1 0\n")
    ttraj.write_kitti(str(root / "gt.txt"), world.poses.astype(np.float64))
    ttraj.write_tum(str(root / "gt_tum.txt"), world.poses.astype(np.float64),
                    np.arange(N_FRAMES) * 0.1)
    (root / "config.yaml").write_text(CONFIG)
    return root


def _run(main, root, out, extra=()):
    out.mkdir()
    main(["run", "--dataset", str(root), "--format", "kitti", "-c", str(root / "config.yaml"),
          "--open-loop", "--output-kitti", str(out / "est.txt"),
          "--output-tum", str(out / "est_tum.txt"),
          "--save-pose-graph", str(out / "graph.g2o"),
          "--save-factor-graph", str(out / "factors.g2o"),
          "--timing-output", str(out / "timing.json"), *extra])
    return json.loads((out / "timing.json").read_text())


@pytest.fixture(scope="module")
def runs(kitti_seq, tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_runs")
    port = _run(tcli.main, kitti_seq, base / "port", ("--device", "cpu"))
    ref = _run(jcli.main, kitti_seq, base / "jax")
    return base, port, ref


def test_cli_run_matches_jax(runs):
    base, port, ref = runs
    est = ttraj.read_kitti(str(base / "port" / "est.txt"))
    est_j = ttraj.read_kitti(str(base / "jax" / "est.txt"))
    assert est.shape == est_j.shape == (N_FRAMES, 4, 4)
    assert np.abs(est[:, :3, 3] - est_j[:, :3, 3]).max() <= 1e-4
    assert port["n_local_maps"] == ref["n_local_maps"] >= 3
    assert port["n_track_breaks"] == ref["n_track_breaks"] == 0
    assert port["run"]["frames"] == N_FRAMES and port["run"]["device"] == "cpu"
    assert port["run"]["kernel_launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    assert 0 < port["run"]["first_frame_seconds"] <= port["run"]["seconds"]
    ts, tum = ttraj.read_tum(str(base / "port" / "est_tum.txt"))
    np.testing.assert_allclose(ts, np.arange(N_FRAMES) * 0.1)
    assert np.abs(tum[:, :3, 3] - est[:, :3, 3]).max() <= 1e-6
    for name in ("graph.g2o", "factors.g2o"):
        kinds = [[line.split()[0] for line in open(base / side / name)] for side in ("port", "jax")]
        assert sorted(set(kinds[0])) == sorted(set(kinds[1]))
        assert kinds[0].count("VERTEX_SE3:QUAT") == kinds[1].count("VERTEX_SE3:QUAT") \
            == port["n_local_maps"]


@pytest.mark.parametrize("fmt", ["kitti", "tum"])
def test_cli_eval_matches_jax(runs, kitti_seq, capsys, fmt):
    base, _, _ = runs
    name, gt = ("est.txt", "gt.txt") if fmt == "kitti" else ("est_tum.txt", "gt_tum.txt")
    out = {}
    for side, main in (("port", tcli.main), ("jax", jcli.main)):
        for est_side in ("port", "jax"):
            main(["eval", "--format", fmt, "--estimate", str(base / est_side / name),
                  "--ground-truth", str(kitti_seq / gt)])
            out[side, est_side] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["port", "port"]["n_poses"] == N_FRAMES
    assert out["port", "port"]["ate_rmse_m"] < 0.05
    assert out["port", "jax"] == out["jax", "jax"]  # the same file, the same digits
    # The JSON rounds to 4 decimals: values this close may print one
    # digit apart.
    for k, v in out["jax", "jax"].items():
        assert abs(out["port", "port"][k] - v) <= 1e-4 + 1e-12, k


@pytest.mark.parametrize("src_fmt,src,dst_fmt", [("tum", "est_tum.txt", "kitti"),
                                                  ("kitti", "est.txt", "tum"),
                                                  ("g2o", "graph.g2o", "kitti")])
def test_cli_convert_is_byte_identical_to_jax(runs, tmp_path, capsys, src_fmt, src, dst_fmt):
    base, _, _ = runs
    for side, main in (("port", tcli.main), ("jax", jcli.main)):
        main(["convert", "--input", str(base / "port" / src), "--input-format", src_fmt,
              "--output", str(tmp_path / f"{side}.txt"), "--output-format", dst_fmt])
    assert capsys.readouterr().out.count("converted") == 2
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_cli_run_defaults_to_the_card(kitti_seq, tmp_path):
    """Without --device the run asks for CUDA; with no card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (tests/test_torch_cuda.py runs the CLI there)")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["run", "--dataset", str(kitti_seq), "--max-frames", "1",
                   "--output-kitti", str(tmp_path / "est.txt"),
                   "--timing-output", str(tmp_path / "timing.json")])


def test_cli_run_trace_and_dump(kitti_seq, tmp_path):
    """--trace-dir writes a torch.profiler Chrome trace; --dump writes the
    keyframe overlays and the map plot (matplotlib)."""
    pytest.importorskip("matplotlib")
    out = tmp_path / "run"
    rep = _run(tcli.main, kitti_seq, out,
               ("--device", "cpu", "--max-frames", "4", "--trace-dir", str(tmp_path / "trace"),
                "--dump", str(tmp_path / "viz")))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 100
    overlays = sorted(p for p in os.listdir(tmp_path / "viz") if p.startswith("overlay_"))
    assert len(overlays) == rep["n_local_maps"] >= 1
    assert os.path.getsize(tmp_path / "viz" / "map_topdown.png") > 5000


def test_cli_dump_without_matplotlib_fails_before_the_run(kitti_seq, tmp_path):
    """A blocked matplotlib import: --dump raises ImportError naming
    matplotlib, and no trajectory is written."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'matplotlib':\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from vslam_tpu_torch.system import cli\n"
        "try:\n"
        f"    cli.main(['run', '--dataset', {str(kitti_seq)!r}, '--device', 'cpu', '--dump',\n"
        f"              '--output-kitti', {str(tmp_path / 'est.txt')!r}])\n"
        "except ImportError as e:\n"
        "    assert 'matplotlib' in str(e), e\n"
        "    print('refused')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "refused"
    assert not (tmp_path / "est.txt").exists()


# The keys of bench.py's JSON line and of its "extra" (bench.py:248-283).
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "extra")
BENCH_EXTRA_KEYS = (
    "ate_rmse_m", "ba_enabled", "fps_with_ba", "ate_rmse_m_with_ba", "n_ba_runs",
    "loop_length_m", "n_frames", "resolution", "backend", "n_local_maps", "n_closures",
    "n_pose_graph_optimizations", "n_recovered_landmarks", "tracking_breaks",
    "tracker_only_fps", "tracker_split_frontend_fps", "device_compute_fps",
    "device_ms_per_frame", "stage_ms_per_frame", "kitti00_scale_run")
# scripts/scale_run.py's keys, without the stage table bench.py drops.
SCALE_KEYS = (
    "n_frames", "ate_ok", "fps", "render_s", "process_s", "ate_rmse_m", "path_length_m",
    "n_local_maps", "n_closures", "n_pose_graph_optimizations", "n_ba_runs",
    "n_merged_landmarks", "reloc_db_rows", "landmark_table_live_rows", "landmarks_spawned",
    "tracking_breaks", "closures_after_map_150")


def test_cli_bench_runs_the_workload(capsys, monkeypatch):
    """`bench` prints bench.py's one JSON line from the port's runs: the
    warmed closed loop and its BA-enabled variant, the tracker-only and
    device-only rates, the stage ms/frame and the scale run, here on the
    first 4 frames (the scale run on 6 frames of a small circle) on the
    CPU."""
    from vslam_tpu_torch.eval import scale_run, workloads

    monkeypatch.setattr(workloads, "run_bench",
                        functools.partial(workloads.run_bench, n_frames=4))
    monkeypatch.setattr(workloads, "SCALE_FRAMES", 6)
    monkeypatch.setattr(scale_run, "run_scale", functools.partial(
        scale_run.run_scale, radius=13.0, laps=0.05, n_points=3000, block=4))
    tcli.main(["bench", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(BENCH_KEYS) <= set(line) and line["metric"] == "closed_loop_frames_per_second"
    extra = line["extra"]
    assert set(BENCH_EXTRA_KEYS) <= set(extra)
    assert extra["backend"] == "cpu" and extra["card"] is None and extra["n_frames"] == 4
    assert line["value"] > 0 and line["vs_baseline"] == round(line["value"] / 40.0, 3)
    for k in ("fps_with_ba", "tracker_only_fps", "tracker_split_frontend_fps",
              "device_compute_fps", "device_ms_per_frame", "ms_per_frame", "warmup_s",
              "first_chunk_ms_per_frame", "ms_per_frame_with_ba"):
        assert np.isfinite(extra[k]) and extra[k] > 0, k
    assert extra["tracking_breaks"] == 0 and extra["ate_rmse_m"] < 0.05
    assert extra["tracking_breaks_with_ba"] == 0 and extra["ate_rmse_m_with_ba"] < 0.05
    assert extra["n_ba_runs"] == 0 and extra["n_local_maps_with_ba"] >= 1
    assert extra["n_local_maps"] >= 1 and "frame_step_dispatch" in extra["stage_ms_per_frame"]
    scale = extra["kitti00_scale_run"]
    assert set(scale) == set(SCALE_KEYS), scale
    assert scale["n_frames"] == 6 and scale["tracking_breaks"] == 0 and scale["ate_ok"]
