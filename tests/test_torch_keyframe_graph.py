"""The keyframe side's two device programs replayed as CUDA graphs
(``utils/cuda_graph.py``): the maintenance step
(``local_mapping.maintenance_ring_step``, ``MAINTENANCE``) and the dense
local-BA solve (``slam_map._dense_ba_body``, ``DENSE_BA``).

On the CPU: when a key runs eagerly, is captured and is replayed, what a
key is made of, that CPU tensors take the eager body and the spans say
``graph`` = 0, the keys a pipelined run makes, the maintenance step with
device slots bit-equal to the step with host slots it replaced, and
``profile_system``'s summary.  On the card (marked ``cuda``, skipped
without one): replays bit-equal to the eager body for both programs, at
the run's own calls and at the buckets the benchmark's cells meet;
results kept across later replays and two calls in flight on one key;
a new ``System`` reusing the process's graphs; a shape met once, as
global BA's, holding none.

The file imports no JAX, so the card tests run on the card with
``python -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_keyframe_graph.py``.
"""

import functools
import os

import numpy as np
import pytest
import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.ops import triangulation as tri_ops
from pyorbslam_tpu_torch.ops.fast import topk_stable
from pyorbslam_tpu_torch.optim import ba
from pyorbslam_tpu_torch.slam import local_mapping as lm_mod
from pyorbslam_tpu_torch.slam import slam_map as map_mod
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.tools import profile_system
from pyorbslam_tpu_torch.utils import cuda_graph, trace
from pyorbslam_tpu_torch.utils.host_read import HostRead, upload

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend.
torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "_data")
N_FRAMES = 30


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


def pipelined_run(seq, device, monkeypatch, programs=None):
    """``N_FRAMES`` frames through the pipelined schedule and the flush,
    the recorder on; the maintenance step's arguments recorded with its
    ring and mirror copied, and both programs' calls recorded (through
    ``programs``, fresh ones by default)."""
    programs = programs or dict(
        maintenance=cuda_graph.GraphedProgram("kf.maintain_capture"),
        ba=cuda_graph.GraphedProgram("ba.solve_capture"))
    rec = dict(maintenance=Recording(programs["maintenance"]),
               ba=Recording(programs["ba"]), steps=[])
    monkeypatch.setattr(lm_mod, "MAINTENANCE", rec["maintenance"])
    monkeypatch.setattr(map_mod, "DENSE_BA", rec["ba"])
    real_step = lm_mod.maintenance_ring_step

    def step(*args, **kwargs):
        kept = [tuple(copied(t) for t in a) if isinstance(a, tuple) else copied(a)
                if isinstance(a, (torch.Tensor, np.ndarray)) else a for a in args]
        rec["steps"].append((kept, kwargs))
        return real_step(*args, **kwargs)

    monkeypatch.setattr(lm_mod, "maintenance_ring_step", step)
    system = System(make_cfg(seq), device, landmark_capacity=1 << 16,
                    keyframe_capacity=128)
    trace.drain()
    trace.enable()
    try:
        for i in range(N_FRAMES):
            system.track_stereo_async(seq.left[i], seq.right[i], seq.timestamps[i])
        system.flush_async()
    finally:
        trace.disable()
    rec["spans"] = trace.drain().spans
    rec["system"] = system
    rec["programs"] = programs
    monkeypatch.setattr(lm_mod, "maintenance_ring_step", real_step)
    return rec


def maintenance_ring_step_before(
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive, ring,
    slot1, nb_slots, free1, nb_free, T1, nb_T, fuse_ids, tgt_slots, tgt_Tcw,
    rev_ids, cam5, baseline, scale_factors, level_sigma2, cfg,
    scale_factor=1.2,
):
    """The maintenance step as it was before its ring slots became device
    tensors: ``slot1`` a Python int, ``nb_slots`` uploaded inside,
    ``tgt_slots`` a host array looped over."""
    xyA, ocA, deA, urA, dpA, vaA = ring
    mirror = (m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive)
    slot1 = int(slot1)
    nb = upload(np.asarray(nb_slots, np.int64), xyA.device)
    Q = min(lm_mod.TRI_Q, int(free1.shape[0]))
    q1 = topk_stable(free1.to(torch.float32), Q)[1]
    q2 = topk_stable(nb_free.to(torch.float32), Q)[1]
    x1, o1, d1, u1, z1 = (a[slot1] for a in (xyA, ocA, deA, urA, dpA))

    def take(a):
        index = q2.reshape(q2.shape + (1,) * (a.dim() - 2)).expand(
            q2.shape + a.shape[2:])
        return torch.gather(a, 1, index)

    tri = tri_ops.triangulate_batch(
        x1[q1], o1[q1], d1[q1], u1[q1], z1[q1], free1[q1],
        take(xyA[nb]), take(ocA[nb]), take(deA[nb]), take(urA[nb]),
        take(dpA[nb]), torch.gather(nb_free, 1, q2), nb_T,
        T1, cam5, baseline, scale_factors, level_sigma2, scale_factor)
    sel = topk_stable(tri.valid.to(torch.float32), min(lm_mod.TRI_CAP, Q))[1]
    minus1 = torch.full_like(tri.idx1, -1)
    idx1_full = torch.where(
        tri.idx1 >= 0, q1[torch.clamp(tri.idx1, min=0).long()].to(torch.int32),
        minus1)
    idx2_full = torch.where(
        tri.idx2 >= 0,
        torch.gather(q2, 1, torch.clamp(tri.idx2, min=0).long()).to(torch.int32),
        minus1)
    pos_sel = torch.gather(tri.pos_w, 1, sel[..., None].expand(sel.shape + (3,)))
    tri_packed = torch.cat([
        torch.gather(idx1_full, 1, sel), torch.gather(idx2_full, 1, sel),
        torch.gather(tri.valid.to(torch.int32), 1, sel),
        pos_sel.contiguous().view(torch.int32).reshape(sel.shape[0], -1),
    ], dim=1)
    block = lm_mod._mirror_block(mirror, fuse_ids)
    fuse = torch.stack([
        lm_mod._fuse_match_one(*block, xyA[s], ocA[s], None, deA[s], vaA[s],
                               urA[s], tgt_Tcw[t], cfg, 3.0)
        for t, s in enumerate(np.asarray(tgt_slots).tolist())])
    rev = lm_mod._fuse_match_one(
        *lm_mod._mirror_block(mirror, rev_ids),
        xyA[slot1], ocA[slot1], None, deA[slot1], vaA[slot1], urA[slot1],
        T1, cfg, 3.0)
    return torch.cat([tri_packed.reshape(-1), fuse.reshape(-1), rev])


@pytest.fixture
def recorder():
    trace.drain()
    trace.enable()
    yield
    trace.disable()
    trace.drain()


# --------------------------------------------------------------------- CPU


class FakeGraph:
    """Stands in for ``cuda_graph._Graph`` on the CPU: counts captures and
    replays, and replays the body on copies of the inputs."""

    made = []

    def __init__(self, body, inputs, device, program):
        self.body, self.replays = body, 0
        FakeGraph.made.append(self)

    def __call__(self, inputs):
        self.replays += 1
        return self.body(*inputs)


class TestGraphedProgram:
    CUDA = torch.device("cuda", 0)

    @pytest.fixture
    def program(self, monkeypatch):
        FakeGraph.made = []
        monkeypatch.setattr(cuda_graph, "_Graph", FakeGraph)
        return cuda_graph.GraphedProgram("test.capture")

    @staticmethod
    def body(a, b):
        return a * 2 + b

    def inputs(self, n=4):
        return [torch.arange(n, dtype=torch.float32), torch.ones(n)]

    def test_second_call_captures_later_calls_replay(self, program, recorder):
        """A key's first call runs the body, its second captures and
        replays, its third replays the same graph; the capture's span
        carries the counters it was given."""
        got = [program(self.body, self.inputs(), self.CUDA, ("s",), dict(n=4))
               for _ in range(3)]
        assert [r for _, r in got] == [False, True, True]
        for out, _ in got:
            assert torch.equal(out, self.body(*self.inputs()))
        assert len(FakeGraph.made) == 1 and FakeGraph.made[0].replays == 2
        assert len(program.graphs) == 1 and len(program.seen) == 1
        spans = trace.drain().spans
        assert [(s.name, s.args) for s in spans] == [("test.capture", dict(n=4))]

    def test_a_key_met_once_holds_no_graph(self, program):
        out, replayed = program(self.body, self.inputs(), self.CUDA)
        assert not replayed and program.graphs == {} and len(program.seen) == 1
        program(self.body, self.inputs(5), self.CUDA)
        assert program.graphs == {} and len(program.seen) == 2
        assert FakeGraph.made == []

    def test_cpu_tensors_take_the_eager_body(self, program):
        for _ in range(3):
            out, replayed = program(self.body, self.inputs(), torch.device("cpu"))
            assert not replayed and torch.equal(out, self.body(*self.inputs()))
        assert program.seen == set() and program.graphs == {} and FakeGraph.made == []

    def test_host_arrays_are_uploaded_for_the_eager_body(self, program):
        a = np.arange(4, dtype=np.float32)
        out, _ = program(self.body, [a, torch.ones(4)], torch.device("cpu"))
        assert torch.equal(out, self.body(torch.from_numpy(a), torch.ones(4)))

    @pytest.mark.parametrize("change", ["shape", "dtype", "host_dtype", "settings",
                                        "device"])
    def test_key_is_shapes_dtypes_settings_and_device(self, change):
        key = cuda_graph.GraphedProgram.key
        a = [torch.zeros(4, 3), np.zeros(4, np.int16)]
        base = key(a, self.CUDA, (5, 10))
        other = {"shape": ([torch.zeros(4, 2), a[1]], self.CUDA, (5, 10)),
                 "dtype": ([torch.zeros(4, 3, dtype=torch.float64), a[1]], self.CUDA, (5, 10)),
                 "host_dtype": ([a[0], np.zeros(4, np.uint8)], self.CUDA, (5, 10)),
                 "settings": (a, self.CUDA, (5, 0)),
                 "device": (a, torch.device("cuda", 1), (5, 10))}[change]
        assert key(*other) != base
        assert key([torch.ones(4, 3), np.ones(4, np.int16)], self.CUDA, (5, 10)) == base


@pytest.fixture(scope="module")
def cpu_run():
    mp = pytest.MonkeyPatch()
    try:
        yield pipelined_run(seq30(), torch.device("cpu"), mp)
    finally:
        mp.undo()


class TestOnTheCpu:
    def test_spans_read_graph_zero(self, cpu_run):
        """Every ``kf.maintain_dispatch`` and ``ba.solve`` span reads
        ``graph`` = 0, no capture span opens, and neither program has met
        a key."""
        spans = cpu_run["spans"]
        maint = [s.args["graph"] for s in spans if s.name == "kf.maintain_dispatch"]
        solve = [s.args["graph"] for s in spans if s.name == "ba.solve"]
        assert len(maint) >= 2 and len(solve) >= 2
        assert set(maint) == {0} and set(solve) == {0}
        assert not [s for s in spans if s.name.endswith("_capture")]
        for program in cpu_run["programs"].values():
            assert program.seen == set() and program.graphs == {}
        assert not any(c["replayed"] for r in ("maintenance", "ba")
                       for c in cpu_run[r].calls)

    def test_maintenance_keys(self, cpu_run):
        """The maintenance step's key: its ring rows (1 + 4 + 8 keyframes),
        landmark rows of the two buckets, and its settings (the
        configuration, ``cap``)."""
        calls = cpu_run["maintenance"].calls
        assert len(calls) == len(cpu_run["steps"]) >= 2
        n = cpu_run["system"].map.keyframes.n_features
        for c in calls:
            cap, cap2 = c["counters"]["cap"], c["counters"]["cap2"]
            assert {cap, cap2} <= {1024, 2048, 4096, 8192, 16384}
            assert c["counters"]["neighbors"] == 4 and c["counters"]["targets"] == 8
            shapes = [s for s, _ in c["key"][1]]
            assert shapes[:6] == [(13, n, 2), (13, n), (13, n, 8), (13, n),
                                  (13, n), (13, n)]
            assert shapes[6] == (cap + cap2, 3) and shapes[12] == (cap + cap2,)
            assert c["settings"][:2] == (cpu_run["system"].cfg, cap)

    def test_ba_keys(self, cpu_run):
        """The dense solve's key: (C, P, K) from its inputs' shapes, the
        iteration counts in its settings."""
        bacfg = cpu_run["system"].cfg.ba
        for c in cpu_run["ba"].calls:
            C, P, K = (c["counters"][k] for k in ("cameras", "points", "width"))
            shapes = [s for s, _ in c["key"][1]]
            assert shapes == [(C, 4, 4), (C,), (P, 3), (P,), (P, K), (P, K, 3),
                              (P, K), (P, K)]
            assert c["settings"][:2] == (bacfg.local_ba_iters1, bacfg.local_ba_iters2)
            assert (c["counters"]["iters1"], c["counters"]["iters2"]) == c["settings"][:2]

    def test_maintenance_step_equals_the_step_before(self, cpu_run, monkeypatch):
        """Each recorded call, on its own copies of the ring and the
        mirror: the step with device slots is bit-equal to the step with
        host slots that it replaced."""
        monkeypatch.setattr(lm_mod, "MAINTENANCE",
                            cuda_graph.GraphedProgram("kf.maintain_capture"))
        matched = 0
        for args, kwargs in cpu_run["steps"]:
            mirror, ring, slots = args[:6], args[6], args[7].numpy()
            (free1, nb_free, T1, nb_T, fuse_ids, tgt_T, rev_ids,
             cam5, baseline, sf, s2, cfg) = args[8:20]
            up = [torch.as_tensor(a) for a in (free1, nb_free, T1, nb_T, tgt_T)]
            got, replayed = lm_mod.maintenance_ring_step(*args, **kwargs)
            want = maintenance_ring_step_before(
                *mirror, ring, int(slots[0]), slots[1:5], up[0], up[1], up[2],
                up[3], fuse_ids, slots[5:], up[4], rev_ids, cam5, baseline, sf,
                s2, cfg, **kwargs)
            assert not replayed and torch.equal(got, want)
            matched += int((want[4 * 6 * lm_mod.TRI_CAP:] >= 0).sum())
        assert matched > 50

    def test_dense_body_is_the_packed_solve(self, cpu_run):
        """The dense solve's body on a recorded call is the grid solve and
        its packing."""
        c = cpu_run["ba"].calls[-1]
        ins = [torch.as_tensor(a) for a in c["inputs"]]
        kw = c["body"].keywords
        res = ba.bundle_adjust_grid_packed(*ins, kw["cam"], kw["isig_table"],
                                           iters1=kw["iters1"], iters2=kw["iters2"])
        want = map_mod._pack_ba_result(res.cam_Tcw, res.pnt_pos,
                                       res.g_inlier.reshape(-1))
        assert torch.equal(c["out"], want)


class TestProfileSummary:
    def test_keyframe_programs_summarised(self):
        def span(name, **args):
            return trace.Span(0, name, 0, -1, 0, 1, args)

        warm = [span("kf.maintain_dispatch", graph=0),
                span("kf.maintain_capture", cap=1024),
                span("kf.maintain_dispatch", graph=1), span("ba.solve", graph=0)]
        measured = [span("kf.maintain_dispatch", graph=1), span("ba.solve", graph=1),
                    span("ba.solve_capture", cameras=16), span("ba.solve", graph=1),
                    span("ba.solve"), span("kf.maintain_dispatch", graph=1)]
        got = {program: profile_system.graph_summary(warm, measured, name, capture)
               for program, (name, capture) in profile_system.GRAPHED.items()}
        assert got["maintenance"] == dict(spans=2, graph_share=1.0, captures_warm=1,
                                          captures_measured=0)
        assert got["ba_solve"] == dict(spans=3, graph_share=2 / 3, captures_warm=0,
                                       captures_measured=1)
        assert got["frontend"]["graph_share"] is None


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
        yield first, second
    finally:
        mp.undo()


def eager(call) -> torch.Tensor:
    device = call["device"]
    return call["body"](*(upload(np.ascontiguousarray(a), device)
                          if isinstance(a, np.ndarray) else a.to(device)
                          for a in call["inputs"]))


def replay_on_fresh_program(call, n: int = 4):
    """A recorded call ``n`` times on a fresh program: each output copied
    to the host as it comes, and whether it replayed."""
    program = cuda_graph.GraphedProgram("test.capture")
    outs = []
    for _ in range(n):
        out, replayed = program(call["body"], call["inputs"], call["device"],
                                call["settings"])
        outs.append((HostRead(out), replayed))
    return program, [(h.numpy().copy(), r) for h, r in outs]


@pytest.mark.cuda
class TestReplayOnTheCard:
    @pytest.mark.parametrize("which", ["maintenance", "ba"])
    def test_replays_bit_equal_to_the_eager_body(self, card_runs, which):
        """Every recorded call of the first run equals the eager body on
        its inputs, and so does each of its later calls on a fresh
        program: eager, capture and replay, replays."""
        first, _ = card_runs
        calls = first[which].calls
        assert calls
        for c in calls:
            assert torch.equal(c["out"], eager(c))
        for c in calls[:3]:
            program, outs = replay_on_fresh_program(c)
            want = eager(c).cpu().numpy()
            assert [r for _, r in outs] == [False, True, True, True]
            for got, _ in outs:
                assert np.array_equal(got, want)
            assert len(program.graphs) == 1

    @pytest.mark.parametrize("which", ["maintenance", "ba"])
    def test_two_calls_in_flight_read_their_own(self, card_runs, which):
        """Two calls on one key, both in flight before either is read
        (two pipe items): each reads its own result, and an earlier read
        is left as it was by the later replays."""
        first, _ = card_runs
        calls = first[which].calls
        by_key = {}
        for c in calls:
            by_key.setdefault(c["key"], []).append(c)
        pairs = [cs for cs in by_key.values() if len(cs) >= 2]
        a, b = pairs[0][:2] if pairs else (calls[0], dict(
            calls[0], inputs=[perturbed(x) for x in calls[0]["inputs"]]))
        program = cuda_graph.GraphedProgram("test.capture")
        run = lambda c: program(c["body"], c["inputs"], c["device"], c["settings"])
        run(a), run(a)              # eager, then capture
        out_a, ra = run(a)
        read_a = HostRead(out_a)
        out_b, rb = run(b)
        read_b = HostRead(out_b)
        assert ra and rb and len(program.graphs) == 1
        got_a = read_a.numpy().copy()
        assert np.array_equal(got_a, eager(a).cpu().numpy())
        assert np.array_equal(read_b.numpy(), eager(b).cpu().numpy())
        run(b)
        assert np.array_equal(read_a.numpy(), got_a)

    def test_a_new_system_reuses_the_graphs(self, card_runs):
        """The second ``System`` keeps every graph the first one captured,
        and each of its calls whose key the first run met replays; its
        spans' ``graph`` says which calls replayed."""
        first, second = card_runs
        programs = first["programs"]
        replays = 0
        for which, span in (("maintenance", "kf.maintain_dispatch"),
                            ("ba", "ba.solve")):
            seen_first = {c["key"] for c in first[which].calls}
            captured_first = {k for k in seen_first
                              if sum(c["key"] == k for c in first[which].calls) >= 2}
            assert captured_first and captured_first <= set(programs[which].graphs)
            for c in second[which].calls:
                if c["key"] in seen_first:
                    assert c["replayed"], (which, c["counters"])
                replays += c["replayed"]
            graph = [s.args["graph"] for s in second["spans"] if s.name == span]
            assert graph == [int(c["replayed"]) for c in second[which].calls]
        assert replays >= 4

    def test_global_ba_met_once_holds_no_graph(self, card_runs, monkeypatch):
        """Global BA (all keyframes, no second phase) is a shape met once:
        it runs eagerly and leaves no graph behind."""
        first, second = card_runs
        program = second["programs"]["ba"]
        monkeypatch.setattr(map_mod, "DENSE_BA", program)
        before = dict(program.graphs)
        trace.drain()
        trace.enable()
        try:
            info = second["system"].map.global_ba()
        finally:
            trace.disable()
        solve = [s.args for s in trace.drain().spans if s.name == "ba.solve"]
        assert info["ran"] and solve == [dict(graph=0)]
        assert program.graphs == before


def perturbed(a):
    """Another input of the same shape and dtype: floats moved a little."""
    if isinstance(a, np.ndarray) and a.dtype == np.float32:
        return a + np.float32(1e-3)
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
        return a + 1e-3
    return a


def bucket_problem(C: int, P: int, K: int, seed: int):
    """A dense BA problem at the bucket (C, P, K), as its host arrays:
    cameras along a line, points in front, each point seen in a few of
    its K slots with 1-px noise."""
    r = np.random.default_rng(seed)
    cams = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cams[:, 2, 3] = -0.8 * np.arange(C)
    pts = np.stack([r.uniform(-8, 8, P), r.uniform(-2, 2, P),
                    r.uniform(5, 40, P)], 1).astype(np.float32)
    g_cam = r.integers(0, C, (P, K))
    z = pts[:, None, 2] + 0.8 * g_cam
    fx, cx, cy, bf = 718.856, 607.19, 185.2, 386.14
    u = fx * pts[:, None, 0] / z + cx
    v = fx * pts[:, None, 1] / z + cy
    uvr = np.stack([u, v, u - bf / z], -1) + r.normal(0, 1, (P, K, 3))
    g_act = r.random((P, K)) < 0.3
    g_act[:, 0] = True
    fixed = np.zeros(C, bool)
    fixed[0] = fixed[C // 2:] = True
    return [cams, fixed, pts + r.normal(0, 0.05, pts.shape).astype(np.float32),
            np.ones(P, bool), g_cam.astype(np.int16),
            np.round(uvr * ba.UVR_Q).astype(np.int16),
            r.integers(0, 8, (P, K)).astype(np.uint8), g_act]


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [(8, 2048, 8), (16, 4096, 32), (32, 8192, 32),
                                    (64, 8192, 32)])
def test_ba_buckets_of_the_cells(bucket):
    """The dense solve at buckets the benchmark's cells meet (1241x376,
    2000 features), on two problems of one key: replays bit-equal to the
    eager body."""
    device = card_or_skip()
    C, P, K = bucket
    cam5 = np.asarray([718.856, 718.856, 607.19, 185.2, 386.14], np.float32)
    isig = (1.0 / 1.2 ** (2 * np.arange(8))).astype(np.float32)
    body = functools.partial(
        map_mod._dense_ba_body, cam=torch.as_tensor(cam5).to(device),
        isig_table=torch.as_tensor(isig).to(device), iters1=5, iters2=10)
    program = cuda_graph.GraphedProgram("test.capture")
    for seed, want_replayed in ((1, False), (2, True), (1, True)):
        ins = bucket_problem(C, P, K, seed)
        out, replayed = program(body, ins, device, ("cells",))
        got = out.cpu().numpy()
        want = body(*(upload(a, device) for a in ins)).cpu().numpy()
        assert replayed == want_replayed and np.array_equal(got, want)


def maintenance_problem(cfg: SlamConfig, cap: int, cap2: int, seed: int):
    """The maintenance body's inputs at a cell's shapes, as host arrays:
    13 ring rows of random features; landmark rows that are the first
    target's features put back at their depth (so the fuse matches), the
    rest random; neighbors half a metre to the side."""
    r = np.random.default_rng(seed)
    c, n = cfg.camera, cfg.orb.max_keypoints
    rows = 13
    xy = np.stack([r.uniform(10, c.width - 10, (rows, n)),
                   r.uniform(10, c.height - 10, (rows, n))], -1).astype(np.float32)
    octave = r.integers(0, cfg.orb.n_levels, (rows, n)).astype(np.int32)
    desc = r.integers(-2**31, 2**31, (rows, n, 8)).astype(np.int32)
    depth = r.uniform(4, 30, (rows, n)).astype(np.float32)
    u_right = (xy[..., 0] - c.bf / depth).astype(np.float32)
    valid = r.random((rows, n)) < 0.9
    m = cap + cap2
    ids = np.full(m, -1, np.int32)
    ids[: cap // 2] = np.arange(cap // 2)
    ids[cap: cap + cap2 // 2] = np.arange(cap // 2, cap // 2 + cap2 // 2)
    f = r.integers(0, n, m)
    z = depth[5, f]
    pos = np.stack([(xy[5, f, 0] - c.cx) / c.fx * z, (xy[5, f, 1] - c.cy) / c.fy * z,
                    z], -1).astype(np.float32)
    dist = np.linalg.norm(pos, axis=1)
    T_nb = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    T_nb[:, 0, 3] = -0.5
    return [xy, octave, desc, u_right, depth, valid,
            pos, desc[5, f], (pos / dist[:, None]).astype(np.float32),
            (0.5 * dist).astype(np.float32), (2.0 * dist).astype(np.float32),
            np.ones(m, bool), ids, valid[0] & (r.random(n) < 0.5),
            valid[1:5] & (r.random((4, n)) < 0.5), np.eye(4, dtype=np.float32),
            T_nb, np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(1024, 1024), (1024, 2048), (1024, 4096),
                                  (2048, 4096)])
def test_maintenance_buckets_of_the_cells(caps):
    """The maintenance body at the (cap, cap2) buckets the benchmark's
    cells meet, 2048 feature slots, on two problems of one key: replays
    bit-equal to the eager body."""
    device = card_or_skip()
    cap, cap2 = caps
    cfg = SlamConfig(camera=CameraConfig(width=1241, height=376),
                     orb=OrbConfig(n_features=2000))
    mapper = lm_mod.LocalMapper(cfg, map_mod.SlamMap(cfg, device,
                                                     landmark_capacity=1 << 12,
                                                     keyframe_capacity=16))
    cam5, baseline, sf, s2 = mapper._tri_consts()
    body = functools.partial(lm_mod.maintenance_body, cap=cap, cam5=cam5,
                             baseline=baseline, scale_factors=sf,
                             level_sigma2=s2, cfg=cfg,
                             scale_factor=cfg.orb.scale_factor)
    program = cuda_graph.GraphedProgram("test.capture")
    fused = 0
    for seed, want_replayed in ((1, False), (2, True), (1, True)):
        ins = maintenance_problem(cfg, cap, cap2, seed)
        out, replayed = program(body, ins, device, ("cells",))
        got = out.cpu().numpy()
        want = body(*(upload(a, device) for a in ins)).cpu().numpy()
        assert replayed == want_replayed and np.array_equal(got, want)
        fused += int((got[4 * 6 * lm_mod.TRI_CAP:] >= 0).sum())
    assert fused > 100
