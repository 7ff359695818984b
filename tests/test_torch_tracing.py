"""The port's spans and counters, and the benchmark's readers of them.

  * utils/log.ChronometerRegistry: inclusive and self seconds of nested
    stages, intervals recorded with add(), the report's self-time
    column, and the `vslam.<stage>` ranges it opens only while a
    torch.profiler session records;
  * a fused closed-loop run at perfbench's tiny size (CPU): the tracker's
    enqueue / drain-wait / host-gap stages, the engine's keyframe events,
    the pose graph's wait, the relocalizer's ICP counters;
  * the per-layer readers in perfbench/metrics on hand-built windows and
    traced slices.
"""

import os
import time
from collections import Counter

import pytest
import torch

from perfbench import profile, spec, window
from perfbench.tests import tiny
from vslam_tpu_torch.loop import relocalizer as trl
from vslam_tpu_torch.tracking import fused as tfused
from vslam_tpu_torch.tracking.tracker import FusedPoseTracker
from vslam_tpu_torch.utils import log

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _spin(seconds: float) -> None:
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


# --- the registry -----------------------------------------------------------


def test_nested_stages_split_into_self_seconds():
    reg = log.ChronometerRegistry()
    with reg.measure("outer"):
        _spin(0.002)
        with reg.measure("inner"):
            _spin(0.003)
            with reg.measure("leaf"):
                _spin(0.001)
        with reg.measure("inner"):
            _spin(0.001)
    assert reg.calls == {"outer": 1, "inner": 2, "leaf": 1}
    assert sum(reg.self_seconds.values()) == pytest.approx(reg.seconds["outer"], abs=1e-9)
    assert reg.self_seconds["inner"] == pytest.approx(
        reg.seconds["inner"] - reg.seconds["leaf"], abs=1e-9)
    assert reg.self_seconds["leaf"] == reg.seconds["leaf"]
    assert reg.outer_seconds == reg.seconds["outer"]
    rep = reg.report()
    assert sum(r["relative"] for r in rep.values()) == pytest.approx(1.0, abs=1e-6)
    assert all("self_seconds" in r for r in rep.values())
    assert list(rep) == ["outer", "inner", "leaf"]  # by inclusive seconds
    reg.clear()
    assert not reg.seconds and not reg.self_seconds and not reg.calls
    assert reg.outer_seconds == 0.0


def test_add_counts_one_call_and_leaves_out_what_it_enclosed():
    reg = log.ChronometerRegistry()
    reg.add("gap", 0.5)
    assert reg.calls["gap"] == 1 and reg.seconds["gap"] == 0.5
    assert reg.self_seconds["gap"] == 0.5
    with reg.measure("open"):
        reg.add("gap", 0.25, enclosed=0.125)
    assert reg.calls["gap"] == 2 and reg.seconds["gap"] == 0.75
    assert reg.self_seconds["gap"] == 0.625
    # An added interval counts toward no open stage.
    assert reg.self_seconds["open"] == pytest.approx(reg.seconds["open"])
    assert sum(r["relative"] for r in reg.report().values()) == pytest.approx(1.0, abs=1e-6)


def _annotations(prof) -> list[str]:
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def test_stages_are_profiler_ranges_while_a_session_records():
    reg = log.ChronometerRegistry()
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.measure("outer"):
            with reg.measure("inner"):
                torch.ones(4).sum()
    names = _annotations(prof)
    assert names.count("vslam.outer") == 1 and names.count("vslam.inner") == 1
    assert reg.calls == {"outer": 1, "inner": 1}


def test_no_profiler_range_without_a_session(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    reg = log.ChronometerRegistry()
    for _ in range(3):
        with reg.measure("stage"):
            pass
    assert made == [] and reg.calls["stage"] == 3
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        with reg.measure("stage"):
            pass
    assert made == ["vslam.stage"]


def test_program_ranges_reach_the_harness_slice():
    """The harness's profiled slice (perfbench/profile.py) keeps the
    program's ranges among its host events, inside the harness's own."""
    reg = log.ChronometerRegistry()
    prof = profile.start(0)
    with profile.span(prof, "perfbench.process_prestaged"):
        with reg.measure("keyframe_events"):
            torch.ones(8).sum()
    prof.stop(2)
    sl = prof.reduce()
    spans = {n: (s, e) for n, s, e in sl.cpu
             if n in ("vslam.keyframe_events", "perfbench.process_prestaged")}
    assert set(spans) == {"vslam.keyframe_events", "perfbench.process_prestaged"}
    (ks, ke), (ps, pe) = spans["vslam.keyframe_events"], spans["perfbench.process_prestaged"]
    assert ps <= ks <= ke <= pe


# --- a fused closed-loop run (perfbench's tiny size, CPU) ------------------


@pytest.fixture(scope="module")
def closed_loop():
    """One 48-frame lap (handles of 2 frames) through the prestaged
    hand-off, recording every replay enqueue and drain of each tracker."""
    tfused.clear_programs()
    trl.clear_icp_programs()
    order = []
    real_enqueuing, real_drain = FusedPoseTracker._enqueuing, FusedPoseTracker._drain

    def enqueuing(self):
        order.append(("enqueue", id(self)))
        return real_enqueuing(self)

    def drain(self):
        if self._dispatched != self._harvested:
            order.append(("drain", id(self)))
        return real_drain(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(FusedPoseTracker, "_enqueuing", enqueuing)
    mp.setattr(FusedPoseTracker, "_drain", drain)
    try:
        runner = window._Runner(tiny.config(True), tiny.traffic(True, 48), 2**31 + 5, "cpu")
        log.chronometers.clear()
        events0 = window.program_events()
        eng, done, cut = runner.episode(None, None)
        events = window.program_events() - events0
        chrono = {k: (log.chronometers.seconds[k], log.chronometers.calls[k])
                  for k in log.chronometers.seconds}
        rep = eng.report()
    finally:
        mp.undo()
        tfused.clear_programs()
        trl.clear_icp_programs()
    return dict(order=order, chrono=chrono, events=events, report=rep, frames=done, cut=cut)


def test_closed_loop_records_the_tracker_and_closure_stages(closed_loop):
    c = closed_loop["chrono"]
    assert closed_loop["frames"] == 48 and not closed_loop["cut"]
    for stage in ("tracker_enqueue", "tracker_drain_wait", "tracker_host_gap",
                  "keyframe_events", "relocalization"):
        assert c[stage][1] >= 1 and c[stage][0] > 0.0, stage
    order = closed_loop["order"]
    assert c["tracker_enqueue"][1] == sum(k == "enqueue" for k, _ in order)
    assert c["tracker_drain_wait"][1] == sum(k == "drain" for k, _ in order)
    # One host gap for each drain that a later replay of the same tracker followed.
    pending, gaps = set(), 0
    for kind, who in order:
        if kind == "drain":
            pending.add(who)
        elif who in pending:
            pending.discard(who)
            gaps += 1
    assert gaps >= 1 and c["tracker_host_gap"][1] == gaps


def test_closed_loop_counts_icp_yield(closed_loop):
    ev = closed_loop["events"]
    assert ev["icp candidates"] >= 1
    assert 0 <= ev["icp closures"] <= ev["icp candidates"]
    assert closed_loop["report"]["n_closures"] >= ev["icp closures"] >= 1


def test_closed_loop_pose_graph_wait_inside_its_stage(closed_loop):
    c = closed_loop["chrono"]
    assert c["pg_wait"][1] == 2 * c["pg_junction_solve"][1] >= 2
    assert c["pg_wait"][0] <= c["pose_graph_optimization"][0]


def test_stage_table_has_self_seconds(closed_loop):
    table = closed_loop["report"]["stage_table"]
    assert sum(r["relative"] for r in table.values()) == pytest.approx(1.0, abs=1e-6)
    for r in table.values():
        assert r["self_seconds"] <= r["seconds"] + 1e-4
    kf = table["keyframe_events"]
    assert kf["self_seconds"] < kf["seconds"]  # relocalization is inside it


# --- the readers ------------------------------------------------------------


def _window(**kw) -> window.Window:
    return window.Window(cell="tiny", shape=(192, 512), **kw)


def _slice(device_ops, cpu) -> profile.Slice:
    return profile.Slice(frames=2, window_s=1.0, busy_s=0.5, kernels=list(device_ops),
                         device_ops=list(device_ops), cpu=list(cpu))


@pytest.mark.parametrize("metric,stage", [
    ("tracker.enqueue_ms_per_frame", "tracker_enqueue"),
    ("tracker.drain_wait_ms_per_frame", "tracker_drain_wait"),
    ("tracker.host_gap_ms_per_frame", "tracker_host_gap"),
    ("backend.pose_graph_wait_ms_per_frame", "pg_wait"),
])
def test_span_readers(metric, stage):
    read = spec.reader(metric)
    assert read(_window(frames=40, chrono={stage: (0.2, 7)})) == pytest.approx(5.0)
    assert read(_window(frames=40, chrono={"relocalization": (0.2, 7)})) is None
    assert read(_window(frames=0, chrono={stage: (0.2, 7)})) is None


def test_icp_yield_reader():
    read = spec.reader("loop.icp_yield_pct")
    assert read(_window(events=Counter({"icp candidates": 8, "icp closures": 6}))) == 75.0
    assert read(_window(events=Counter({"icp candidates": 8}))) == 0.0
    assert read(_window(events=Counter({"icp replay": 3}))) is None


KF = "vslam.keyframe_events"


@pytest.mark.parametrize("cpu,want", [
    # the gap 100..200 half covered
    ([(KF, 150, 260)], 50.0),
    # a range outside every gap
    ([(KF, 0, 90), (KF, 210, 300)], 0.0),
    # the range nested inside the harness's span
    ([("perfbench.process_prestaged", 0, 400), (KF, 100, 200)], 100.0),
    # overlapping ranges count once
    ([(KF, 100, 160), (KF, 120, 150), (KF, 140, 175)], 75.0),
    # no such range
    ([("perfbench.process_prestaged", 0, 400), ("vslam.relocalization", 100, 200)], None),
], ids=["half", "outside", "nested", "overlapping", "no-range"])
def test_idle_in_closure_path_reader(cpu, want):
    read = spec.reader("device.idle_in_closure_path_pct")
    # device ops 0..100 and 200..300, overlapping ops inside: one gap 100..200
    ops = [("k", 0, 60), ("k", 40, 60), ("k", 200, 50), ("k", 250, 50)]
    got = read(_window(trace=_slice(ops, cpu)))
    assert got == (None if want is None else pytest.approx(want))


def test_idle_in_closure_path_reader_needs_a_slice():
    read = spec.reader("device.idle_in_closure_path_pct")
    assert read(_window()) is None
    assert read(_window(trace=_slice([], [(KF, 0, 10)]))) is None
    # device ops with no gap between them
    assert read(_window(trace=_slice([("k", 0, 10), ("k", 10, 10)], [(KF, 0, 20)]))) is None


def test_uncached_runs_ignores_the_icp_counters():
    read = spec.reader("programs.uncached_runs")
    ev = Counter({"icp candidates": 9, "icp closures": 4, "replay": 30, "icp replay": 2})
    assert read(_window(events=ev)) == 0.0
    assert read(_window(events=ev + Counter({"icp eager": 1, "capture": 1}))) == 2.0
    assert window._uncaptured(ev) == []
