"""The port's span recorder (``pyorbslam_tpu_torch/utils/trace.py``) over
the pipelined schedule, and ``tools/profile_system.py``'s attribution of a
device trace to the spans.

Two runs of ``System.track_stereo_async`` over the first frames of the
cached 512x160 sequence, recording off and on: recording changes no pose,
every span sits inside its parent, a dispatched frame's spans carry the id
the frame is given at its commit, and a keyframe's mapping work carries
the id of the frame that made the keyframe, also where it runs in a later
call.
"""

import time

import numpy as np
import pytest
import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.tools import profile_system
from pyorbslam_tpu_torch.utils import trace

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
N_FRAMES = 14
TRACK_SPANS = ("track.frontend", "track.motion", "track.local", "track.pose_opt")


def run(seq, recorded: bool):
    """``N_FRAMES`` frames through the pipelined schedule and the flush;
    (the System, the spans drained)."""
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=seq.left.shape[2], height=seq.left.shape[1],
            bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=1000))
    system = System(cfg, CPU, landmark_capacity=1 << 16, keyframe_capacity=128)
    trace.drain()
    if recorded:
        trace.enable()
    try:
        for i in range(N_FRAMES):
            system.track_stereo_async(seq.left[i], seq.right[i], seq.timestamps[i])
        system.flush_async()
    finally:
        trace.disable()
    return system, trace.drain()


@pytest.fixture(scope="module")
def runs(data_cache_dir):
    seq = generate_sequence(n_frames=30, width=512, height=160,
                            trajectory="straight", speed=0.8, seed=3,
                            cache_dir=data_cache_dir)
    return dict(off=run(seq, False), on=run(seq, True))


def by_id(spans):
    return {s.id: s for s in spans}


def ancestors(s, ids):
    while s.parent >= 0:
        s = ids[s.parent]
        yield s


def test_off_records_nothing(runs):
    system, drained = runs["off"]
    assert drained.spans == [] and drained.dropped == 0
    # the stage clocks run all the same
    assert system.time_counts["async.dispatch"] > 0
    assert system.time_counts["async.commit"] > 0


def test_poses_equal_recorded_or_not(runs):
    off, on = runs["off"][0], runs["on"][0]
    assert len(off.trajectory) == len(on.trajectory) == N_FRAMES
    np.testing.assert_array_equal(np.stack(off.trajectory), np.stack(on.trajectory))
    assert off.map.keyframes.n == on.map.keyframes.n
    assert dict(off.time_counts) == dict(on.time_counts)


def test_spans_nest_in_their_parents(runs):
    _, drained = runs["on"]
    assert drained.dropped == 0
    ids = by_id(drained.spans)
    for s in drained.spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = ids[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (s, p)
    roots = [s for s in drained.spans if s.parent < 0]
    assert {s.name for s in roots} <= {"call.async", "call.flush"}
    assert sum(s.name == "call.async" for s in roots) == N_FRAMES


def test_dispatched_frames_carry_their_id(runs):
    system, drained = runs["on"]
    ids = by_id(drained.spans)
    dispatch = [s for s in drained.spans if s.name == "async.dispatch"]
    commit = [s for s in drained.spans if s.name == "async.commit"]
    frames = [s.frame for s in dispatch]
    # one dispatch a frame, committed under the same id
    assert len(frames) == len(set(frames)) >= N_FRAMES - 2
    assert sorted(frames) == sorted(s.frame for s in commit)
    assert max(frames) == system.frame_id == N_FRAMES - 1
    for s in dispatch:
        assert set(s.args) == {"n_feat", "n_local"} and s.args["n_feat"] > 0
        inside = [c for c in drained.spans if s in ancestors(c, ids)]
        names = [c.name for c in inside]
        assert all(names.count(n) == (2 if n == "track.pose_opt" else 1)
                   for n in TRACK_SPANS), names
        assert "track.local_ids" in names
        assert all(c.frame == s.frame for c in inside)
    for s in commit:
        assert {"matches", "inliers_motion", "inliers_local", "kf", "rescue"} <= set(s.args)
        kf = s.args["kf"]
        assert kf == -1 or system.map.keyframes.frame_id[kf] == s.frame
    # every track step span ran inside a frame's dispatch, or on the
    # synchronous path of the first frame
    for s in drained.spans:
        if s.name in TRACK_SPANS:
            chain = [a.name for a in ancestors(s, ids)]
            assert "async.dispatch" in chain or s.frame == 0, (s, chain)


def test_keyframe_work_carries_its_frame(runs):
    system, drained = runs["on"]
    ks = system.map.keyframes
    kf_frames = set(ks.frame_id[: ks.n].tolist())
    names = set()
    for s in drained.spans:
        if not s.name.startswith("kf."):
            continue
        names.add(s.name)
        if "kf" in s.args:
            assert s.frame == ks.frame_id[s.args["kf"]], s
        else:
            assert s.name == "kf.snapshot_read" and s.frame in kf_frames, s
    assert {"kf.insert_total", "kf.maintain_dispatch", "kf.maintain_apply",
            "kf.ba_dispatch", "kf.ba_apply", "kf.loop"} <= names, names
    # mapping work runs in later calls than its keyframe's frame, yet
    # carries that frame's id; the map's and the loop closer's stages inside
    # it take it over
    ids = by_id(drained.spans)
    later = 0
    for s in drained.spans:
        if s.name in ("kf.ba_apply", "kf.maintain_apply"):
            root = [a for a in ancestors(s, ids)][-1]
            later += root.frame > s.frame
            assert "pending" in s.args and "pipe_depth" in s.args
        if s.name.startswith(("ba.", "loop.")):
            assert s.frame in kf_frames, s
    assert later > 0
    assemble = [s for s in drained.spans if s.name == "ba.assemble"]
    assert assemble and all(s.args["observations"] > 0 for s in assemble)


def test_clock_agrees_with_the_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function

    trace.drain()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # the first range of a profile pays a lazy set-up after its stamp
            with record_function("warm"):
                pass
            with record_function("trace_probe"):
                with trace.span("probe"):
                    time.sleep(0.005)
    finally:
        trace.disable()
    (span,) = trace.drain().epoch_spans()
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "trace_probe"]
    assert abs(event.start_ns() - span.t0_ns) < 1_000_000
    assert abs(event.end_ns() - span.t1_ns) < 1_000_000


def test_bound_drops_and_counts(monkeypatch):
    trace.drain()
    monkeypatch.setattr(trace.RECORDER, "capacity", 3)
    trace.enable()
    try:
        with trace.span("outer", 7):
            for _ in range(4):
                with trace.span("inner") as sp:
                    sp.args["n"] = 1
    finally:
        trace.disable()
    drained = trace.drain()
    assert [s.name for s in drained.spans] == ["inner"] * 3
    assert drained.dropped == 2
    assert all(s.frame == 7 for s in drained.spans)
    assert trace.drain() == ([], 0, drained.anchor)


def test_attribution_by_span():
    spans = [(0, 100, "call.async"), (10, 60, "async.dispatch"),
             (20, 40, "track.pose_opt"), (120, 150, "call.async")]
    launches = {1: 25, 2: 50, 3: 110, 4: 130}     # correlation id -> host ns
    kernels = [(30, 35, 1), (55, 70, 2), (112, 118, 3), (140, 145, 4), (146, 147, 9)]
    ops = kernels[:2] + [(80, 90)] + kernels[2:]   # a copy at 80-90
    by = profile_system.attribute(spans, launches, [k[:3] for k in kernels],
                                  [k[:2] for k in ops], (0, 160))
    assert by["track.pose_opt"]["launches"] == 1
    assert by["async.dispatch"]["launches"] == 1
    assert by[profile_system.OUTSIDE]["launches"] == 1
    assert by["call.async"]["launches"] == 1
    assert by[profile_system.UNMATCHED]["launches"] == 1
    # idle gaps by the span open at their start: 0-30, 70-80, 90-112,
    # 145-146 and 147-160 in call.async, 35-55 in pose_opt, 118-140 in none
    idle = {k: round(v["idle_s"] * 1e9) for k, v in by.items() if v["idle_s"]}
    assert idle == {"call.async": 30 + 10 + 22 + 1 + 13, "track.pose_opt": 20,
                    profile_system.OUTSIDE: 22}
    busy = sum(b - a for a, b in profile_system.union([k[:2] for k in ops]))
    assert sum(idle.values()) == 160 - busy
