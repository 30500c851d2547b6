"""The frame's tracking step and the keyframe snapshot replayed as CUDA
graphs (``utils/cuda_graph.py``): ``tracking.fused_retrack_step``
(``TRACK_STEP``, body ``track_step_body``) and ``tracking.graphed_snapshot``
(``KF_SNAPSHOT``, body ``kf_snapshot``).

On the CPU: what the step's key is made of (the feature capacity N, the
mirror's M, the local bucket P, ``th_base`` and each setting the body
reads, nothing else); that CPU tensors take the eager body and the spans
say ``graph`` = 0; that ``fused_track_window`` keeps its rows when every
call hands back one and the same output tensor, as replays do; that a
pipelined run through recording programs is bit-equal to a plain one.
On the card (marked ``cuda``, skipped without one): replays bit-equal to
the eager body for the chain step, a window of 3, a re-track at
``th_base`` 28 and the snapshot; a second ``System`` replaying the
first's graphs; two pose_opt launches counted a replayed step.

The file imports no JAX, so the card tests run on the card with
``python -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_track_graph.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.slam import tracking
from pyorbslam_tpu_torch.slam.frame import StereoFrame
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.tools import profile_system
from pyorbslam_tpu_torch.utils import cuda_graph, trace
from pyorbslam_tpu_torch.utils.host_read import HostRead, upload

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend.
torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "_data")
N_FRAMES = 30
CPU = torch.device("cpu")


def seq30():
    return generate_sequence(n_frames=30, width=512, height=160,
                             trajectory="straight", speed=0.8, seed=3,
                             cache_dir=DATA)


def make_cfg(seq) -> SlamConfig:
    return SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=seq.left.shape[2], height=seq.left.shape[1],
            bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=1000))


def copied(a):
    return a.clone() if isinstance(a, torch.Tensor) else np.array(a, copy=True)


def on(device, a) -> torch.Tensor:
    return upload(np.ascontiguousarray(a), device) if isinstance(a, np.ndarray) \
        else a.to(device)


class Recording:
    """Stands in for a :class:`cuda_graph.GraphedProgram`: every call's
    body, inputs (copied), settings, counters, output and whether it
    replayed."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, body, inputs, device, settings=(), counters=None):
        kept = [copied(a) for a in inputs]
        out, replayed = self.real(body, inputs, device, settings, counters)
        self.calls.append(dict(
            body=body, inputs=kept, device=device, settings=settings,
            counters=counters, out=out.clone(), replayed=replayed,
            key=cuda_graph.GraphedProgram.key(kept, device, settings)))
        return out, replayed


def fresh_programs():
    return dict(step=cuda_graph.GraphedProgram("track.step_capture"),
                snapshot=cuda_graph.GraphedProgram("track.snapshot_capture"))


def pipelined_run(seq, device, monkeypatch, programs=None, record=True):
    """``N_FRAMES`` frames through the pipelined schedule and the flush,
    the span recorder on; with ``record`` both programs' calls recorded
    (through ``programs``, fresh ones by default)."""
    programs = programs or fresh_programs()
    rec = {k: Recording(p) if record else p for k, p in programs.items()}
    monkeypatch.setattr(tracking, "TRACK_STEP", rec["step"])
    monkeypatch.setattr(tracking, "KF_SNAPSHOT", rec["snapshot"])
    system = System(make_cfg(seq), device, landmark_capacity=1 << 16,
                    keyframe_capacity=128)
    trace.drain()
    trace.enable()
    try:
        poses = [system.track_stereo_async(seq.left[i], seq.right[i],
                                           seq.timestamps[i]).copy()
                 for i in range(N_FRAMES)]
        system.flush_async()
    finally:
        trace.disable()
    rec.update(spans=trace.drain().spans, system=system, programs=programs,
               poses=poses)
    return rec


# --------------------------------------------------------------------- CPU


class KeyOnly:
    """A program that runs nothing: it keeps each call's key and counters
    and hands back a row of the right length."""

    def __init__(self):
        self.keys, self.counters = [], []

    def __call__(self, body, inputs, device, settings=(), counters=None):
        self.keys.append(cuda_graph.GraphedProgram.key(inputs, device, settings))
        self.counters.append(counters)
        n, p = counters["features"], counters["local"]
        return torch.zeros(21 + n + p // 32, dtype=torch.int32), False


def tiny_frame(n: int, fill: float = 0.0) -> StereoFrame:
    return StereoFrame(
        xy=torch.full((n, 2), fill), response=torch.zeros(n),
        angle=torch.zeros(n), octave=torch.zeros(n, dtype=torch.int32),
        desc=torch.zeros((n, 8), dtype=torch.int32),
        desc_bits=torch.zeros((n, 256), dtype=torch.int8),
        valid=torch.ones(n, dtype=torch.bool), u_right=torch.zeros(n),
        depth=torch.zeros(n))


def step_args(n=64, m=128, p=64, fill=0.0):
    mirror = (torch.full((m, 3), fill), torch.zeros((m, 8), dtype=torch.int32),
              torch.zeros((m, 3)), torch.zeros(m), torch.zeros(m),
              torch.ones(m, dtype=torch.bool))
    return (tiny_frame(n, fill), *mirror, np.full(n, -1, np.int32),
            tiny_frame(n), np.full(p, -1, np.int32), np.eye(4, dtype=np.float32),
            np.eye(4, dtype=np.float32))


def replace_cfg(cfg: SlamConfig, part: str, **kw) -> SlamConfig:
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


READ = [("camera", "fx", 700.0), ("camera", "fy", 700.0), ("camera", "cx", 300.0),
        ("camera", "cy", 180.0), ("camera", "bf", 380.0), ("camera", "width", 1226),
        ("camera", "height", 370), ("camera", "th_depth", 35.0),
        ("orb", "scale_factor", 1.25), ("orb", "n_levels", 6),
        ("ba", "pose_rounds", 3), ("ba", "pose_iters_per_round", 8)]
UNREAD = [("camera", "k1", 0.1), ("camera", "fps", 20.0), ("camera", "rgb", False),
          ("orb", "n_features", 1500), ("orb", "ini_th_fast", 12),
          ("orb", "use_atlas", False), ("tracking", "th_high", 90),
          ("tracking", "max_frames", 5), ("tracking", "max_local_points", 4096),
          ("ba", "local_ba_iters1", 3), ("ba", "chi2_stereo", 6.0)]


class TestKey:
    CFG = SlamConfig()

    def key_of(self, monkeypatch, cfg=None, th_base=7.0, **shape):
        program = KeyOnly()
        monkeypatch.setattr(tracking, "TRACK_STEP", program)
        row, Tcw, assign = tracking.fused_retrack_step(
            *step_args(**shape), cfg or self.CFG, th_base=th_base)
        assert Tcw.shape == (4, 4) and assign.shape == (shape.get("n", 64),)
        return program.keys[0], program.counters[0]

    @pytest.mark.parametrize("change", [dict(n=128), dict(m=256), dict(p=96),
                                        dict(th_base=28.0)])
    def test_changes_with_shapes_and_th(self, monkeypatch, change):
        """N, M, P and ``th_base`` each make another key, and the
        capture's counters name them."""
        base, counters = self.key_of(monkeypatch)
        assert counters == dict(features=64, mirror=128, local=64, th=7.0)
        other, counters = self.key_of(monkeypatch, **change)
        assert other != base
        want = dict(features=change.get("n", 64), mirror=change.get("m", 128),
                    local=change.get("p", 64), th=change.get("th_base", 7.0))
        assert counters == want

    @pytest.mark.parametrize("part,field,value", READ,
                             ids=[f"{p}.{f}" for p, f, _ in READ])
    def test_changes_with_each_setting_read(self, monkeypatch, part, field, value):
        base, _ = self.key_of(monkeypatch)
        other, _ = self.key_of(monkeypatch, replace_cfg(self.CFG, part, **{field: value}))
        assert other != base

    @pytest.mark.parametrize("part,field,value", UNREAD,
                             ids=[f"{p}.{f}" for p, f, _ in UNREAD])
    def test_unchanged_by_anything_else(self, monkeypatch, part, field, value):
        """Settings the body does not read, and other values of the same
        shapes, leave the key as it was."""
        base, _ = self.key_of(monkeypatch)
        assert self.key_of(monkeypatch, replace_cfg(self.CFG, part, **{field: value}))[0] \
            == base
        assert self.key_of(monkeypatch, fill=3.0)[0] == base


class SharedOutput:
    """A program that runs the body eagerly and hands back one and the
    same tensor on every call, as a graph's replays do."""

    def __init__(self):
        self.out = None

    def __call__(self, body, inputs, device, settings=(), counters=None):
        got = body(*(on(device, a) for a in inputs))
        if self.out is None or self.out.shape != got.shape:
            self.out = torch.empty_like(got)
        self.out.copy_(got)
        return self.out, True


@pytest.fixture(scope="module")
def cpu_runs():
    """A plain pipelined run and one through recording programs."""
    mp = pytest.MonkeyPatch()
    seq = seq30()
    try:
        plain = pipelined_run(seq, CPU, mp, record=False)
        recorded = pipelined_run(seq, CPU, mp)
        yield seq, plain, recorded
    finally:
        mp.undo()


class TestOnTheCpu:
    def test_recorded_run_is_bit_equal(self, cpu_runs):
        """Poses, events and stats of the run through recording programs
        equal the plain run's, bit for bit."""
        _, plain, recorded = cpu_runs
        a, b = plain["system"], recorded["system"]
        assert len(plain["poses"]) == N_FRAMES
        for p, q in zip(plain["poses"], recorded["poses"]):
            assert np.array_equal(p, q)
        assert np.array_equal(a.corrected_trajectory(), b.corrected_trajectory())
        assert repr(a.events) == repr(b.events)
        assert repr(a.stats) == repr(b.stats)
        assert a.map.keyframes.n == b.map.keyframes.n >= 3

    def test_spans_read_graph_zero(self, cpu_runs):
        """Every ``track.step`` and ``track.prefetch`` span reads ``graph``
        = 0, no capture span opens, neither program has met a key, and
        each dispatch ran one step and one prefetch."""
        _, _, rec = cpu_runs
        spans = rec["spans"]
        ids = {s.id: s for s in spans}
        steps = [s for s in spans if s.name == "track.step"]
        prefetch = [s for s in spans if s.name == "track.prefetch"]
        dispatch = [s for s in spans if s.name == "async.dispatch"]
        assert len(dispatch) >= N_FRAMES - 2
        assert {s.args["graph"] for s in steps} == {0}
        assert {s.args["graph"] for s in prefetch} == {0}
        for s in dispatch:
            inside = [c.name for c in spans if c.parent == s.id]
            assert inside.count("track.step") == inside.count("track.prefetch") == 1
        assert not [s for s in spans if s.name.endswith("_capture")]
        for program in rec["programs"].values():
            assert program.seen == set() and program.graphs == {}
        assert not any(c["replayed"] for k in ("step", "snapshot") for c in rec[k].calls)
        # the motion and local stages and K4's span nest in the step
        for s in spans:
            if s.name in ("track.motion", "track.local"):
                assert ids[s.parent].name == "track.step"
        assert len(steps) == len(rec["step"].calls) >= len(dispatch)

    def test_step_keys_of_the_run(self, cpu_runs):
        """The run's step keys: N the feature capacity, M a mirror bucket,
        P a local bucket, ``th_base`` 7; the snapshot's key holds the
        vocabulary's arrays by address."""
        _, _, rec = cpu_runs
        system = rec["system"]
        n = system.cfg.orb.max_keypoints
        assert rec["step"].calls
        for c in rec["step"].calls:
            assert c["counters"]["features"] == n and c["counters"]["th"] == 7.0
            assert c["counters"]["mirror"] in (1 << 14, 1 << 15, 1 << 16)
            assert c["counters"]["local"] in (2048, 4096, 8192)
            assert c["settings"] == (tracking.step_settings(system.cfg), 7.0)
            shapes = [s for s, _ in c["key"][1]]
            assert shapes[:8] == [(n, 2), (n,), (n,), (n, 8), (n, 256), (n,), (n,), (n,)]
            assert shapes[-3:] == [(c["counters"]["local"],), (4, 4), (4, 4)]
        voc = system.vocabulary
        arrays = voc._device_arrays(CPU)
        assert rec["snapshot"].calls
        for c in rec["snapshot"].calls:
            assert c["settings"] == (voc.k, voc.L, voc.feature_levels_up,
                                     tuple(a.data_ptr() for a in arrays))

    def test_rows_and_snapshots_are_the_bodies(self, cpu_runs):
        """Each recorded call's output is its body on its inputs, the
        step's row decoding to the pose and assignment it carries."""
        _, _, rec = cpu_runs
        for c in rec["step"].calls[:3] + rec["snapshot"].calls[:2]:
            assert torch.equal(c["body"](*(on(CPU, a) for a in c["inputs"])), c["out"])
        c = rec["step"].calls[-1]
        Tcw, assign = tracking.decode_row(c["out"], c["counters"]["features"])
        row = tracking.read_row(c["out"].numpy(), c["counters"]["features"],
                                c["counters"]["local"])
        assert np.array_equal(Tcw.numpy(), row.Tcw)
        assert np.array_equal(assign.numpy(), row.assign)

    def test_window_keeps_its_rows_when_outputs_alias(self, cpu_runs, monkeypatch):
        """``fused_track_window`` over three frames, with every step's
        output one and the same tensor: its stacked rows and final carry
        equal those of the eager steps."""
        seq, plain, _ = cpu_runs
        system = plain["system"]
        args = window_args(system, seq, range(N_FRAMES - 3, N_FRAMES))
        monkeypatch.setattr(tracking, "TRACK_STEP", cuda_graph.GraphedProgram("x"))
        want_rows, _, want_carry = tracking.fused_track_window(*args, system.cfg)
        shared = SharedOutput()
        monkeypatch.setattr(tracking, "TRACK_STEP", shared)
        rows, _, carry = tracking.fused_track_window(*args, system.cfg)
        assert torch.equal(rows, want_rows)
        assert not torch.equal(rows[0], rows[-1])
        for a, b in zip(carry[1:], want_carry[1:]):
            assert torch.equal(a, b)


def window_args(system, seq, frames):
    images = torch.as_tensor(np.stack([
        np.stack([seq.left[i], seq.right[i]]) for i in frames])).to(system.device)
    p_ids = system._pad_ids(system._spatial_point_ids(system.Tcw))
    return (images, *system._landmark_mirror(), system.last_frame,
            system._dev(system._last_lm_ids()), system._dev(p_ids),
            system._dev(system.Tcw),
            system._dev((np.linalg.inv(system.velocity) @ system.Tcw)
                        .astype(np.float32)))


class TestProfileSummary:
    def test_tracking_programs_summarised(self):
        def span(name, **args):
            return trace.Span(0, name, 0, -1, 0, 1, args)

        warm = [span("track.step", graph=0), span("track.step_capture", th=7.0),
                span("track.step", graph=1), span("track.prefetch", graph=0)]
        measured = [span("track.step", graph=1), span("track.prefetch", graph=1),
                    span("track.snapshot_capture", features=2048),
                    span("track.prefetch", graph=1), span("track.step", graph=0)]
        got = {program: profile_system.graph_summary(warm, measured, name, capture)
               for program, (name, capture) in profile_system.GRAPHED.items()}
        assert got["step"] == dict(spans=2, graph_share=0.5, captures_warm=1,
                                   captures_measured=0)
        assert got["snapshot"] == dict(spans=2, graph_share=1.0, captures_warm=0,
                                       captures_measured=1)


# -------------------------------------------------------------------- card


def card_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_runs():
    """Two fresh ``System``s over the same frames on the card, one after
    the other, with the same (fresh) programs: the process's graphs."""
    device = card_or_skip()
    seq = seq30()
    mp = pytest.MonkeyPatch()
    try:
        first = pipelined_run(seq, device, mp)
        second = pipelined_run(seq, device, mp, first["programs"])
        yield seq, first, second
    finally:
        mp.undo()


def eager(call) -> torch.Tensor:
    return call["body"](*(on(call["device"], a) for a in call["inputs"]))


def replay_on_fresh_program(call, n: int = 4, body=None, settings=None):
    """A recorded call ``n`` times on a fresh program: each output copied
    to the host as it comes, and whether it replayed."""
    program = cuda_graph.GraphedProgram("test.capture")
    outs = []
    for _ in range(n):
        out, replayed = program(body or call["body"], call["inputs"], call["device"],
                                call["settings"] if settings is None else settings)
        outs.append((HostRead(out), replayed))
    return program, [(h.numpy().copy(), r) for h, r in outs]


@pytest.mark.cuda
class TestReplayOnTheCard:
    @pytest.mark.parametrize("which", ["step", "snapshot"])
    def test_replays_bit_equal_to_the_eager_body(self, card_runs, which):
        """Every recorded call of the first run (the chain steps, the
        prefetched snapshots) equals the eager body on its inputs, and so
        does each of its later calls on a fresh program: eager, capture
        and replay, replays."""
        _, first, _ = card_runs
        calls = first[which].calls
        assert len(calls) >= N_FRAMES - 2
        for c in calls:
            assert torch.equal(c["out"], eager(c))
        for c in calls[-3:]:
            program, outs = replay_on_fresh_program(c)
            want = eager(c).cpu().numpy()
            assert [r for _, r in outs] == [False, True, True, True]
            for got, _ in outs:
                assert np.array_equal(got, want)
            assert len(program.graphs) == 1

    def test_retrack_at_28_bit_equal(self, card_runs):
        """A chain step's inputs re-tracked at ``th_base`` 28, as the
        wide rescue does: its own key, replays bit-equal to the eager
        body."""
        _, first, _ = card_runs
        c = first["step"].calls[-1]
        body = c["body"]
        wide = type(body)(body.func, *body.args, **dict(body.keywords, th_base=28.0))
        settings = (c["settings"][0], 28.0)
        program, outs = replay_on_fresh_program(c, body=wide, settings=settings)
        want = wide(*(on(c["device"], a) for a in c["inputs"])).cpu().numpy()
        assert [r for _, r in outs] == [False, True, True, True]
        for got, _ in outs:
            assert np.array_equal(got, want)

    def test_window_of_three_bit_equal(self, card_runs, monkeypatch):
        """``fused_track_window`` over three frames on the card: graphed
        (the first step eager, the second captured, the third replayed)
        equal to the steps' eager bodies, rows and final carry."""
        seq, _, second = card_runs
        system = second["system"]
        args = window_args(system, seq, range(N_FRAMES - 3, N_FRAMES))

        class Eager:
            def __call__(self, body, inputs, device, settings=(), counters=None):
                return body(*(on(device, a) for a in inputs)), False

        monkeypatch.setattr(tracking, "TRACK_STEP", Eager())
        want_rows, _, want_carry = tracking.fused_track_window(*args, system.cfg)
        program = Recording(cuda_graph.GraphedProgram("test.capture"))
        monkeypatch.setattr(tracking, "TRACK_STEP", program)
        rows, _, carry = tracking.fused_track_window(*args, system.cfg)
        # the first step's q_lm comes from the host, the later ones from the
        # carry: the last step replays
        assert program.calls[-1]["replayed"]
        assert torch.equal(rows, want_rows)
        for a, b in zip(carry[1:], want_carry[1:]):
            assert torch.equal(a, b)

    def test_a_new_system_replays_the_graphs(self, card_runs):
        """The second ``System`` keeps every graph the first captured, and
        each of its calls whose key the first run met replays; its spans'
        ``graph`` says which calls replayed."""
        _, first, second = card_runs
        for which, span in (("step", "track.step"), ("snapshot", "track.prefetch")):
            seen_first = {c["key"] for c in first[which].calls}
            calls = second[which].calls
            assert calls
            for c in calls:
                if c["key"] in seen_first:
                    assert c["replayed"], (which, c["counters"])
            assert sum(c["replayed"] for c in calls) >= len(calls) - 2
            graph = [s.args["graph"] for s in second["spans"] if s.name == span]
            assert graph == [int(c["replayed"]) for c in calls]

    def test_pose_opt_counted_twice_a_replayed_step(self, card_runs):
        """Two pose_opt launches counted a step, eager, captured and
        replayed alike; the capture itself counts none."""
        _, first, _ = card_runs
        c = first["step"].calls[-1]
        program = cuda_graph.GraphedProgram("test.capture")
        for k in range(4):
            kernels.reset_launch_counts()
            _, replayed = program(c["body"], c["inputs"], c["device"], c["settings"])
            assert replayed == (k > 0)
            assert kernels.launch_counts()["pose_opt"] == 2
        graph = next(iter(program.graphs.values()))
        assert graph.launches["pose_opt"] == 2


def test_take_captured_moves_a_capture_off_the_counters():
    """What the kernels' wrappers counted while a graph was captured comes
    off the counters and is handed back for the replays to add."""
    kernels.reset_launch_counts()
    kernels.count_launches({"fast_score": 3})
    before = kernels.launch_counts()
    kernels.POSE_OPT.launches += 2      # the wrappers, during a capture
    captured = kernels.take_captured(before)
    assert captured == dict(fast_score=0, brief_canvas=0, brief_level=0, pose_opt=2)
    assert kernels.launch_counts() == before
    kernels.count_launches(captured)
    assert kernels.launch_counts()["pose_opt"] == 2
    kernels.reset_launch_counts()
