"""The port's span recorder (``pyorbslam_tpu_torch/utils/trace.py``) over
the windowed schedule.

Runs of ``System.window_feed`` + ``window_flush`` and of
``System.track_stereo_window``, in windows of three frames over the first
frames of the cached 512x160 sequence, recording off and on: recording
changes no pose; every span carries a frame id, sits inside its parent
and, for a scanned step or a committed row, carries its own frame's id;
the counters agree with what the run did; and the keyframe side's clock
(``System.times["keyframe_side"]``) and its part inside a window's commit
(``"window.commit_kf"``) equal what the spans' nesting gives.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.slam.system import KEYFRAME_SIDE, WINDOW_COMMIT_KF, System
from pyorbslam_tpu_torch.utils import trace

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
W = 3
N_FRAMES = 12
# the first call initializes per frame; the later ones are scanned
SCANNED = list(range(W, N_FRAMES))
TRACK_SPANS = ("track.frontend", "track.motion", "track.local", "track.pose_opt")


def make_system(seq) -> System:
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=seq.left.shape[2], height=seq.left.shape[1],
            bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=1000))
    return System(cfg, CPU, landmark_capacity=1 << 16, keyframe_capacity=128)


def run(seq, schedule: str, recorded: bool):
    """``N_FRAMES`` frames through ``schedule`` in windows of ``W``;
    (the System, the poses each call gave back, the spans drained)."""
    system = make_system(seq)
    call = system.window_feed if schedule == "feed" else system.track_stereo_window
    returned = []
    trace.drain()
    if recorded:
        trace.enable()
    try:
        for i in range(0, N_FRAMES, W):
            s = slice(i, i + W)
            returned.append(call(seq.left[s], seq.right[s], seq.timestamps[s]))
        if schedule == "feed":
            returned.append(system.window_flush())
    finally:
        trace.disable()
    return system, returned, trace.drain()


@pytest.fixture(scope="module")
def seq(data_cache_dir):
    return generate_sequence(n_frames=30, width=512, height=160,
                             trajectory="straight", speed=0.8, seed=3,
                             cache_dir=data_cache_dir)


@pytest.fixture(scope="module")
def runs(seq):
    return {"feed_off": run(seq, "feed", False), "feed": run(seq, "feed", True),
            "window": run(seq, "window", True)}


def by_id(spans):
    return {s.id: s for s in spans}


def ancestors(s, ids):
    while s.parent >= 0:
        s = ids[s.parent]
        yield s


def test_poses_equal_recorded_or_not(runs):
    off, _, drained_off = runs["feed_off"]
    on = runs["feed"][0]
    assert drained_off.spans == []
    assert len(off.trajectory) == len(on.trajectory) == N_FRAMES
    np.testing.assert_array_equal(np.stack(off.trajectory), np.stack(on.trajectory))
    assert off.map.keyframes.n == on.map.keyframes.n
    assert dict(off.time_counts) == dict(on.time_counts)
    assert off.time_counts["window.dispatch"] == len(SCANNED) // W


@pytest.mark.parametrize("schedule", ["feed", "window"])
def test_spans_nest_and_carry_a_frame(runs, schedule):
    system, returned, drained = runs[schedule]
    assert drained.dropped == 0 and drained.spans
    ids = by_id(drained.spans)
    for s in drained.spans:
        assert 0 <= s.frame < N_FRAMES, s
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = ids[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (s, p)
    roots = [s for s in drained.spans if s.parent < 0]
    assert {s.name for s in roots} == {"call.window"}
    assert len(roots) == len(returned)
    # a call's id is that of the first frame it hands in (a flush: the
    # first it commits)
    assert [s.frame for s in roots] == list(range(0, N_FRAMES, W)) + (
        [SCANNED[-W]] if schedule == "feed" else [])


@pytest.mark.parametrize("schedule", ["feed", "window"])
def test_steps_and_rows_carry_their_own_frame(runs, schedule):
    system, _, drained = runs[schedule]
    ids = by_id(drained.spans)
    steps = [s for s in drained.spans if s.name == "window.step"]
    assert [s.frame for s in steps] == SCANNED
    for s in steps:
        assert ids[s.parent].name == "window.dispatch"
        inside = [c for c in drained.spans if s in ancestors(c, ids)]
        names = [c.name for c in inside]
        assert all(names.count(n) == (2 if n == "track.pose_opt" else 1)
                   for n in TRACK_SPANS), names
        assert all(c.frame == s.frame for c in inside)
    dispatch = [s for s in drained.spans if s.name == "window.dispatch"]
    assert [s.frame for s in dispatch] == SCANNED[::W]
    rows = [s for s in drained.spans if s.name == "window.row"]
    assert [s.frame for s in rows] == list(range(N_FRAMES))
    assert [s.args["perframe"] for s in rows] == [1] * W + [0] * len(SCANNED)
    ks = system.map.keyframes
    for s in drained.spans:
        if s.name == "kf.insert_total":
            # inserted by the row of its own frame
            row = next(a for a in ancestors(s, ids) if a.name == "window.row")
            assert row.frame == s.frame == ks.frame_id[s.args["kf"]]
        if s.name in ("window.retrack", "window.read"):
            assert ids[s.parent].name in ("window.row", "window.commit_total")
    for s in rows[W:]:
        commit = ids[s.parent]
        assert commit.name == "window.commit_total"
        assert 0 <= s.frame - commit.frame < W


@pytest.mark.parametrize("schedule", ["feed", "window"])
def test_counters_agree_with_the_run(runs, schedule):
    system, returned, drained = runs[schedule]
    ids = by_id(drained.spans)
    named = {}
    for s in drained.spans:
        named.setdefault(s.name, []).append(s)
    dispatch, commits = named["window.dispatch"], named["window.commit_total"]
    assert sum(s.args["frames"] for s in dispatch) == len(SCANNED)
    assert all(s.args["n_feat"] > 0 and s.args["n_local"] > 0 for s in dispatch)
    assert sum(s.args["frames"] for s in commits) == len(SCANNED)
    assert [s.frame for s in commits] == SCANNED[::W]
    events = [e for e in system.events if isinstance(e, str)]
    retracks = named.get("window.retrack", [])
    assert sum(s.args["retracked"] for s in commits) \
        == sum(e.startswith("retrack:") for e in events) == len(retracks)
    assert sum(s.args["rescued_28px"] for s in commits) \
        == sum(s.args["th"] == 28.0 and s.args["ok"] for s in retracks)
    assert sum(s.args["retracked"] for s in named["window.row"]
               if not s.args["perframe"]) == len(retracks)
    assert sum(s.args["aborted"] for s in commits) \
        == sum(e.startswith("abort:") for e in events) == 0
    inserted_in_commits = [s for s in named["kf.insert_total"]
                           if any(a.name == "window.commit_total"
                                  for a in ancestors(s, ids))]
    assert sum(s.args["kf"] for s in commits) == len(inserted_in_commits) > 0
    assert len(named["kf.insert_total"]) == system.map.keyframes.n
    calls = named["call.window"]
    assert [s.args["returned"] for s in calls] == [len(r) for r in returned]
    assert sum(s.args["returned"] for s in calls) == N_FRAMES == len(system.trajectory)


@pytest.mark.parametrize("schedule", ["feed", "window"])
def test_keyframe_clocks_follow_the_nesting(runs, schedule):
    """The keyframe side's clock counts each outermost keyframe stage
    once; the commit's part is what of it ran inside a commit."""
    system, _, drained = runs[schedule]
    ids = by_id(drained.spans)
    stages = {k for k in system.time_counts if k.startswith("kf.")}

    def secs(spans):
        return sum(s.t1_ns - s.t0_ns for s in spans) * 1e-9

    outer = [s for s in drained.spans if s.name in stages
             and not any(a.name in stages for a in ancestors(s, ids))]
    in_commit = [s for s in outer
                 if any(a.name == "window.commit_total" for a in ancestors(s, ids))]
    nested = [s for s in drained.spans if s.name in stages and s not in outer]
    assert outer and in_commit
    assert system.times[KEYFRAME_SIDE] == pytest.approx(secs(outer), abs=1e-9)
    assert system.times[WINDOW_COMMIT_KF] == pytest.approx(secs(in_commit), abs=1e-9)
    assert sum(system.times[k] for k in stages) == pytest.approx(
        secs(outer) + secs(nested), abs=1e-9)
    if schedule == "window":
        # every commit maps its keyframes synchronously, inside insertion
        assert {s.name for s in nested} >= {"kf.maintain", "kf.loop"}


def test_aborted_rows_start_the_next_scan_from_the_host(seq):
    """A commit whose re-track fails hands its rows to the per-frame
    machine (rows inside the commit, ``aborted``); the next scan starts
    from the frame and pose that machine left."""
    system = make_system(seq)
    trace.drain()
    trace.enable()
    try:
        for i in (0, W):
            system.window_feed(*(a[i: i + W] for a in (seq.left, seq.right,
                                                       seq.timestamps)))
        # every row of the next commit re-tracks, and no re-track holds
        system.window_commit_min_inliers = 10 ** 9
        system._retrack_window_frame_inner = lambda *a, **k: (None, False)
        system.window_feed(*(a[2 * W: 3 * W] for a in (seq.left, seq.right,
                                                      seq.timestamps)))
    finally:
        trace.disable()
    drained = trace.drain()
    ids = by_id(drained.spans)
    (commit,) = [s for s in drained.spans if s.name == "window.commit_total"]
    assert commit.frame == W
    assert (commit.args["aborted"], commit.args["retracked"],
            commit.args["rescued_28px"]) == (W, 1, 0)
    rows = [s for s in drained.spans if ids.get(s.parent) is commit
            and s.name == "window.row"]
    # the failed row, then the window again through the per-frame machine
    assert [(s.frame, s.args.get("perframe")) for s in rows] == \
        [(W, None)] + [(f, 1) for f in range(W, 2 * W)]
    calls = [s for s in drained.spans if s.name == "call.window"]
    assert [s.args["returned"] for s in calls] == [W, 0, W]
    assert all(s.frame >= 0 for s in drained.spans)
    pending = system._pending_window
    assert pending["frame0"] is system.last_frame
    assert system.frame_id == 2 * W - 1


def test_profile_system_drives_windows(seq, monkeypatch):
    """``tools/profile_system.py --window W``'s drive on the CPU (its
    device waits stubbed): the measured frames go through ``window_feed``
    and the flush, and its span table reads the windowed spans."""
    from pyorbslam_tpu_torch.tools import profile_system

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = make_system(seq).cfg
    short = dataclasses.replace(seq, left=seq.left[:9], right=seq.right[:9],
                                timestamps=seq.timestamps[:9])
    run = profile_system.drive(short, cfg, CPU, W, False, window=W)
    assert run["frames"] == 6
    table = profile_system.span_table(run["drained"], run["frames"])
    assert table["call.window"]["calls_per_frame"] == pytest.approx(3 / 6)
    assert table["window.step"]["calls_per_frame"] == 1.0
    assert table["window.row"]["calls_per_frame"] == 1.0
    assert table["window.commit_total"]["counters"]["frames"] == W
    assert all(s.frame >= W for s in run["drained"].spans)
