"""A whole run of the harness at a tiny size on the CPU (the look for a
card skipped): correct when the timed path is sound, not correct when
it is broken underneath; and on the card, a short run of each cell."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import faults, run
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def _run(fused: bool, seconds: float = 2.0) -> dict:
    out = run.result("tiny", tiny.config(fused), tiny.traffic(fused), tiny.LIMITS,
                     tiny.METRICS, 2**31 + 77, seconds, False, device="cpu")
    out.pop("_numbers")
    assert out.pop("_warm_episodes") >= 1
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fused", [True, False], ids=["prestaged", "per_frame"])
def test_sound_run_is_correct(fused):
    out = _run(fused)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and "fps" in out["metrics"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault,fused", [
    ("stuck", True), ("half", True), ("altered", True), ("stuck", False), ("altered", False),
], ids=["stuck-prestaged", "half-prestaged", "altered-prestaged", "stuck-per_frame",
        "altered-per_frame"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, fused):
    faults.plant(fault, "process_prestaged" if fused else "process", monkeypatch.setattr)
    out = _run(fused)
    assert not out["correct"], out["checks"]


def test_no_jax_in_the_process():
    code = ("import sys; sys.path.insert(0, '.');"
            "from perfbench import run; from perfbench.tests import tiny;"
            "run.result('tiny', tiny.config(True), tiny.traffic(True, 4), tiny.LIMITS, {},"
            " 1, 0.5, False, device='cpu');"
            "print(run.forbidden_modules(), 'vslam_tpu_torch' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vslam_tpu_torchx", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vslam_tpu.frontend", sys)
    assert run.forbidden_modules() == ["vslam_tpu"]


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "proslam-kitti.firstlap256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["proslam-kitti.firstlap256"])
def test_cell_runs_correct_on_the_card(card, cell):
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "5", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
