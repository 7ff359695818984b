"""BENCHMARK.json and the files it names, found by name:

    configs[].file                     a configuration (window.load_config)
    perfbench/traffic/<traffic>.json   a traffic mix (generator.load_traffic),
                                       which names its world
                                       (perfbench/worlds/<world>.py) and its
                                       hand-off (perfbench/handoffs/<name>.py)
    perfbench/limits/<cell>.json       the numbers a cell compares and their
                                       limits (reference.decide)
    perfbench/metrics/<metric>.py      one reader a metric: read(window) ->
                                       float, or None where it finds nothing

A later cell, configuration or metric is a new entry and new files.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_path(spec: dict, config: str, root: Path = ROOT) -> Path:
    for c in spec["configs"]:
        if c["name"] == config:
            return root / c["file"]
    raise KeyError(f"no configuration {config!r} in BENCHMARK.json")


def traffic_path(traffic: str) -> Path:
    return HERE / "traffic" / f"{traffic}.json"


def limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())


def metrics_for(spec: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (trace
    on): those with no `workloads` key, or that list the cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
