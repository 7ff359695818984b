"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

import json
import re
from collections import Counter
from pathlib import Path

import numpy as np

import pytest

from perfbench import generator, reference, spec, window
from perfbench.tests import tiny

BENCH = spec.load()
ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _cells_reporting(metric: dict) -> list[str]:
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert len(BENCH["command"]) <= 32
    assert all(p == "perfbench" or p.startswith("perfbench/") for p in BENCH["command"][1:2])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in E2E and "bound" not in m
        assert set(_cells_reporting(m)) <= set(_cells_reporting(E2E[m["moves"]]))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    w = spec.cell(BENCH, cell)
    assert w["chips"] == 1
    config = window.load_config(spec.config_path(BENCH, w["config"]))
    traffic = generator.load_traffic(spec.traffic_path(w["traffic"]))
    limits = spec.limits(cell)
    gt = traffic_gt(traffic, config)
    numbers = reference.compare([_truth_episode(gt, traffic)], gt)
    assert set(limits) <= set(numbers)
    # The cell reports setup_s, another end-to-end metric and a per-layer one.
    e2e = [m["name"] for m in spec.metrics_for(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(BENCH, cell, True)


def traffic_gt(traffic, config):
    return generator.make_world(traffic, config.camera, 0).poses[:traffic.episode_frames]


def _truth_episode(gt, traffic):
    """The true poses with keyframes every 4 frames and, where the loop
    comes back to a place, closures: each number a cell compares can be
    read from such an episode."""
    kf = list(range(3, len(gt), 4))
    pos = gt[kf, :3, 3]
    clo = []
    for q in range(len(kf)):
        d = np.linalg.norm(pos[:max(q - 10, 0)] - pos[q], axis=1)
        if len(d) and d.min() < 1.5:
            r = int(np.argmin(d))
            clo.append((q, r, np.linalg.inv(gt[kf[r]]) @ gt[kf[q]]))
    return window.Episode(frames=len(gt), trajectory=gt.astype(np.float64), kf_frames=kf,
                          closures=clo, breaks=0)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_applies_to_the_port(config):
    """Every setting lands on the port's ParameterCollection, as the port
    loads a YAML of them, and nothing is reduced that is not listed."""
    c = window.load_config(spec.config_path(BENCH, config))
    entry = next(e for e in BENCH["configs"] if e["name"] == config)
    assert set(entry["reduced"]) <= set(c.raw.get("reduced", {}))
    cfg = window.parameter_collection(c)
    assert len(cfg.explicit_keys) == len(c.settings)


def test_proslam_kitti_is_the_source_yaml_whole():
    """proslam-kitti holds configurations/configuration_kitti.yaml's
    settings, every group and key, unchanged; the port runs them on its
    fused tracker, staged front end at 2 octaves."""
    yaml = pytest.importorskip("yaml")
    src = ROOT / "configurations" / "configuration_kitti.yaml"
    if not src.is_file():
        pytest.skip("the source YAML is not in this checkout")
    c = window.load_config(spec.config_path(BENCH, "proslam-kitti"))
    assert c.raw["proslam"] == yaml.safe_load(src.read_text())
    cfg = window.parameter_collection(c)
    assert cfg.framepoint_generation.detector_number_of_octaves == 2
    assert cfg.tracking.use_fused_tracker and not cfg.graph_optimization.enable_full_bundle_adjustment
    assert cfg.relocalization.preliminary_minimum_interspace_queries == 10


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_finds_nothing_in_an_empty_window(metric):
    read = spec.reader(metric)
    empty = window.Window(cell="none", shape=(376, 1241), octaves=2)
    val = read(empty)
    # A count may read 0; a share or a time finds nothing to read.
    assert val is None or (metric.startswith("programs.uncached_runs") and val == 0.0)


def test_tiny_cell_uses_reported_metrics():
    assert set(tiny.METRICS) <= set(E2E) | {m["name"] for m in BENCH["per_layer"]}


def test_programs_left_uncaptured_after_set_up():
    events = Counter({"eager": 1, "capture": 1, "replay": 30, "query eager": 3,
                      "query capture": 2, "modular track eager": 1})
    assert sorted(window._uncaptured(events)) == ["modular track eager", "query eager"]
    assert window._uncaptured(Counter()) == []
