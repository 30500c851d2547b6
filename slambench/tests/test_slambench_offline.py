"""CPU tests of the offline cell, ``kitti04-12.offline-pipelined.cruise``:
its four readers on a canned record and against the nesting of the
program's own spans, its schedule's windows, and a run at a small size
(512x160, 1000 features, 15-frame sessions) through ``run.measure``,
sound and under the control."""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

import control  # noqa: E402
import harness  # noqa: E402
import run  # noqa: E402
import world  # noqa: E402

torch.set_num_threads(2)

CELL = "kitti04-12.offline-pipelined.cruise"
METRICS = ("scan_ms.offline", "commit_ms.offline", "retrack_ms.offline",
           "mapping_ms.offline")
SEED = 3_000_000_019
FX = 0.58 * 512
SMALL = dict(overrides=dict(camera=dict(width=512, height=160, fx=FX, fy=FX, cx=256.0,
                                        cy=70.0, bf=FX * 0.54),
                            orb=dict(n_features=1000)),
             session_frames=15, tex_size=1024)


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def reader(name):
    return harness.load_module("metrics", name).read


def test_the_cell_and_its_metrics(bench):
    cell = harness.resolve_cell(bench, CELL)
    assert sorted(cell.metrics) == sorted(METRICS)
    assert cell.entry["window"] == 3 and cell.entry["schedule"] == "offline_pipelined"
    assert (harness.slam_config(cell).camera.width,
            harness.slam_config(cell).camera.height) == (1226, 370)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    assert chips[CELL] == 1
    for m in bench["per_layer"]:
        assert (m["workloads"] == [CELL]) == (m["name"] in METRICS), m["name"]


CANNED = {"window.dispatch": 6.0, "window.commit_total": 9.0, "window.read": 0.5,
          "window.retrack": 2.0, "window.commit_kf": 3.0, "kf.insert_total": 2.5,
          "kf.snapshot_read": 0.5, "kf.maintain_dispatch": 4.0, "kf.ba_apply": 1.0,
          "keyframe_side": 8.0, "perframe.track": 0.3}


@pytest.mark.parametrize("name,expected", [
    ("scan_ms.offline", 60.0),
    # 9.0 - 2.0 (re-tracks) - 3.0 (keyframe stages inside the commits)
    ("commit_ms.offline", 40.0),
    ("retrack_ms.offline", 20.0),
    ("mapping_ms.offline", 80.0),
])
def test_readers_on_a_canned_record(name, expected):
    record = dict(times=dict(CANNED), times_frames=100, cfg=None, trace=None)
    assert reader(name)(record) == pytest.approx(expected, rel=1e-12)
    assert reader(name)(dict(times={}, times_frames=0, cfg=None, trace=None)) is None
    # a program without the windowed path's clocks (the live schedule's)
    live = dict(times={"async.dispatch": 3.0, "kf.insert_total": 1.0},
                times_frames=100, cfg=None, trace=None)
    assert reader(name)(live) is None


def test_readers_of_a_program_without_the_sums():
    """A program that keeps the stage clocks but not the keyframe side's
    sums (the parent of the change that added them): the two readers that
    need them read nothing, and raise nothing."""
    times = {k: v for k, v in CANNED.items() if k not in ("window.commit_kf",
                                                          "keyframe_side")}
    record = dict(times=times, times_frames=100, cfg=None, trace=None)
    assert reader("commit_ms.offline")(record) is None
    assert reader("mapping_ms.offline")(record) is None
    assert reader("scan_ms.offline")(record) == pytest.approx(60.0)


class Recorder:
    """Stands in for a System: records what each call is handed."""

    def __init__(self):
        self.calls = []

    def window_feed(self, lefts, rights, timestamps):
        assert len(lefts) == len(rights) == len(timestamps)
        self.calls.append(("feed", list(timestamps)))

    def window_flush(self):
        self.calls.append(("flush", []))


def test_schedule_hands_in_windows():
    schedule = harness.load_module("schedules", "offline_pipelined")
    n = 8
    route = world.Route(left=np.zeros((n, 4, 6), np.uint8), right=np.ones((n, 4, 6), np.uint8),
                        poses_wc=None, timestamps=np.arange(n) * 0.1, planes=None,
                        camera=None)
    system, i = Recorder(), 0
    while i < n:
        k = schedule.feed(system, route, i, {"window": 3})
        assert k == min(3, n - i)
        i += k
    schedule.finish(system)
    assert [len(t) for _, t in system.calls] == [3, 3, 2, 0]
    assert [c for c, _ in system.calls] == ["feed"] * 3 + ["flush"]
    np.testing.assert_array_equal(np.concatenate([t for _, t in system.calls]),
                                  route.timestamps)
    assert set(schedule.SPANS) >= {"window_feed", "_dispatch_window", "_commit_window",
                                   "_retrack_window_frame", "window_flush"}


def spans_exclusive(drained, stages):
    """Each metric's seconds as the spans' nesting gives them: a stage's
    spans less those of the stages the metric leaves to others."""
    ids = {s.id: s for s in drained.spans}

    def ancestors(s):
        while s.parent >= 0:
            s = ids[s.parent]
            yield s

    def secs(spans):
        return sum(s.t1_ns - s.t0_ns for s in spans) * 1e-9

    kf_outer = [s for s in drained.spans if s.name in stages and s.name.startswith("kf.")
                and not any(a.name in stages and a.name.startswith("kf.")
                            for a in ancestors(s))]
    commits = [s for s in drained.spans if s.name == "window.commit_total"]
    in_commit = [s for s in drained.spans if any(a in commits for a in ancestors(s))]
    retracks = [s for s in drained.spans if s.name == "window.retrack"]
    # what the commit leaves to the other metrics holds nothing of the other
    assert not any(a in retracks for s in kf_outer for a in ancestors(s))
    return {
        "scan_ms.offline": secs(s for s in drained.spans if s.name == "window.dispatch"),
        "commit_ms.offline": secs(commits) - secs(r for r in retracks if r in in_commit)
        - secs(s for s in kf_outer if s in in_commit),
        "retrack_ms.offline": secs(retracks),
        "mapping_ms.offline": secs(kf_outer),
    }


def test_readers_follow_the_spans_nesting(bench):
    """A small drive of the cell's schedule with the program's span
    recorder on: each reader, over ``System.times``, equals its exclusive
    time worked out from the spans' parents."""
    from pyorbslam_tpu_torch.place.vocabulary import load_default
    from pyorbslam_tpu_torch.slam.system import System
    from pyorbslam_tpu_torch.utils import trace

    cell = harness.resolve_cell(bench, CELL)
    cfg = harness.slam_config(cell, SMALL["overrides"])
    route = world.make_route(cell.traffic, harness.camera_of(cfg), 12, 5, "cpu", 1024)
    schedule = harness.load_module("schedules", cell.entry["schedule"])
    system = System(cfg, torch.device("cpu"), vocabulary=load_default())
    trace.drain()
    trace.enable()
    try:
        i = 0
        while i < 12:
            i += schedule.feed(system, route, i, cell.entry)
        schedule.finish(system)
    finally:
        trace.disable()
    drained = trace.drain()
    assert drained.dropped == 0 and all(s.frame >= 0 for s in drained.spans)
    record = dict(times=dict(system.times), times_frames=12, cfg=cfg, trace=None)
    want = spans_exclusive(drained, set(system.time_counts))
    for name in METRICS:
        got = reader(name)(record)
        assert got is not None and got >= 0.0, name
        assert got == pytest.approx(1e3 * want[name] / 12, abs=1e-6), name
    assert want["mapping_ms.offline"] > 0 and want["commit_ms.offline"] > 0
    # the schedule's per-frame fall-backs and flush map synchronously,
    # inside insertion: counted once
    stages = defaultdict(float, system.times)
    assert sum(v for k, v in stages.items() if k.startswith("kf.")) \
        > stages["keyframe_side"]


def small_run(**kwargs):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.resolve_cell(bench, CELL)
    cell.entry = dict(cell.entry, warm_frames=6)
    line, _ = run.measure(bench, cell, SEED, 1e-3, False, torch.device("cpu"),
                          **SMALL, **kwargs)
    return line


def values(line):
    return {k: v["value"] for k, v in line["checks"].items()}


@pytest.fixture(scope="module")
def sound():
    return small_run()


def test_small_run_is_correct(sound):
    assert sound["correct"] is True, sound["checks"]
    assert np.isfinite(list(values(sound).values())).all()


def test_control_is_not_correct(sound):
    line = small_run(program_cfg=control.broken)
    assert line["correct"] is False
    got, base = values(line), values(sound)
    assert max(got[k] / base[k] for k in got) >= 3.0
