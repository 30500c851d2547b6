"""The PyTorch port's pipelined schedule (``System.track_stereo_async``)
and its rescue path (reference-keyframe fallback, relocalization, EPnP)
against the JAX package, plus the KITTI IO and the port's CLI.

Inputs come from numpy seeds or from the cached 512x160 synthetic
sequence.  Tolerances, stated where they apply:

* EPnP on well-determined sets (>= 6 points): rotation within 1e-3 rad and
  translation within 1e-3 of its norm; both packages take a float32
  ``eigh`` of the 12x12 ``M^T M``, whose null vector carries ~1e-4 of
  rounding.  A 4-point minimal set leaves a 4-dimensional null space whose
  basis is arbitrary, so single hypotheses are compared by how many of
  them explain the data, never one to one.
* RANSAC with the same index sets: the final pose within the same 1e-3
  bounds, inlier masks equal.
* Whole runs: the two packages' descriptors differ in ~0.03% of their bits
  (ROADMAP.md queue 3), so runs are held to the JAX tests' own gates and to
  the margins ``tests/test_torch_system.py`` uses (ATE within 1.5x + 2 cm,
  keyframes within 2).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mapping import make_cfgs

from pyorbslam_tpu.io import kitti as jkitti
from pyorbslam_tpu.io.synthetic import generate_sequence
from pyorbslam_tpu.optim import epnp as jepnp
from pyorbslam_tpu.slam import system as jsystem
from pyorbslam_tpu.utils.metrics import ate_rmse

from pyorbslam_tpu_torch import convert, stereo_kitti
from pyorbslam_tpu_torch.io import kitti as tkitti
from pyorbslam_tpu_torch.io.synthetic import SyntheticSequence
from pyorbslam_tpu_torch.optim import epnp as tepnp
from pyorbslam_tpu_torch.slam import system as tsystem
from pyorbslam_tpu_torch.tools import make_kitti_synth
from pyorbslam_tpu_torch.utils.host_read import HostRead, upload

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
ATE_GATE = 0.25                      # m, tests/test_system.py on this sequence
ATE_FACTOR, ATE_SLACK = 1.5, 0.02    # margin of tests/test_torch_system.py
KF_MARGIN = 2
RELOC_GATE = 0.5                     # m, tests/test_reloc.py
EPNP_TOL = 1e-3
CAM4 = np.array([500.0, 500.0, 256.0, 80.0], np.float32)


def T(a):
    return torch.as_tensor(np.array(a, order="C"))


# ------------------------------------------------------------------ EPnP


def pnp_scene(rng, n, yaw=0.2):
    """n world points in front of a camera at a known pose, projected."""
    Xw = rng.uniform([-5, -2, 4], [5, 2, 30], (n, 3)).astype(np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t = np.array([0.3, -0.1, 0.5], np.float32)
    Pc = Xw @ R.T + t
    uv = np.stack([CAM4[0] * Pc[:, 0] / Pc[:, 2] + CAM4[2],
                   CAM4[1] * Pc[:, 1] / Pc[:, 2] + CAM4[3]], 1).astype(np.float32)
    return Xw, uv, R, t


def assert_pose_close(R_a, t_a, R_b, t_b):
    R_a, R_b = np.asarray(R_a, np.float64), np.asarray(R_b, np.float64)
    ang = np.linalg.norm(R_a - R_b) / np.sqrt(2.0)
    assert ang < EPNP_TOL, ang
    rel = np.linalg.norm(np.asarray(t_a) - np.asarray(t_b)) / np.linalg.norm(t_b)
    assert rel < EPNP_TOL, rel


class TestEPnP:
    @pytest.mark.parametrize("n", [6, 12, 64])
    def test_epnp_single_matches_jax(self, n):
        Xw, uv, R, t = pnp_scene(np.random.default_rng(n), n)
        Rj, tj = jepnp.epnp_single(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(CAM4))
        Rt, tt = tepnp.epnp_single(T(Xw), T(uv), T(CAM4))
        assert_pose_close(Rt.numpy(), tt.numpy(), Rj, tj)
        assert_pose_close(Rt.numpy(), tt.numpy(), R, t)     # and the truth

    def test_batched_equals_one_by_one(self):
        """The written-out hypothesis dimension: a batch of 6-point sets
        gives each set's own solution."""
        rng = np.random.default_rng(5)
        Xw, uv, R, t = pnp_scene(rng, 96)
        idx = np.stack([rng.choice(96, 6, replace=False) for _ in range(8)])
        Rb, tb = tepnp.epnp_single(T(Xw)[idx], T(uv)[idx], T(CAM4))
        assert Rb.shape == (8, 3, 3) and tb.shape == (8, 3)
        for h in range(8):
            R1, t1 = tepnp.epnp_single(T(Xw[idx[h]]), T(uv[idx[h]]), T(CAM4))
            assert_pose_close(Rb[h].numpy(), tb[h].numpy(), R1.numpy(), t1.numpy())
            assert_pose_close(Rb[h].numpy(), tb[h].numpy(), R, t)

    def test_minimal_sets_explain_the_data_as_often_as_jax(self):
        """4-point hypotheses, same sets in both packages: counted by how
        many reach 80% inliers on the clean scene; degenerate sets (a
        repeated index) give no inliers and never raise."""
        rng = np.random.default_rng(9)
        Xw, uv, _, _ = pnp_scene(rng, 80)
        idx = rng.integers(0, 80, (64, 4))
        idx[0] = [3, 3, 3, 3]                               # fully degenerate
        Rt, tt = tepnp.epnp_single(T(Xw)[idx], T(uv)[idx], T(CAM4))
        Rj, tj = jax.vmap(lambda i: jepnp.epnp_single(
            jnp.asarray(Xw)[i], jnp.asarray(uv)[i], jnp.asarray(CAM4)))(jnp.asarray(idx))

        def good(Rs, ts):
            Pc = np.einsum("hij,nj->hni", np.asarray(Rs), Xw) + np.asarray(ts)[:, None]
            z = Pc[..., 2]
            with np.errstate(all="ignore"):
                u = CAM4[0] * Pc[..., 0] / z + CAM4[2]
                v = CAM4[1] * Pc[..., 1] / z + CAM4[3]
                inl = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2 < 5.991) & (z > 0)
            return int((inl.sum(1) >= 64).sum())

        g_t, g_j = good(Rt.numpy(), tt.numpy()), good(Rj, tj)
        assert g_j >= 10, g_j
        assert g_t >= 0.7 * g_j, (g_t, g_j)

    def _outlier_scene(self, seed):
        rng = np.random.default_rng(seed)
        Xw, uv, R, t = pnp_scene(rng, 128)
        uv[:40] += rng.uniform(-50, 50, (40, 2)).astype(np.float32)
        active = np.ones(128, bool)
        active[100:] = False
        sigma2 = np.where(np.arange(128) % 3 == 0, 1.44, 1.0).astype(np.float32)
        return Xw, uv, R, t, active, sigma2

    @pytest.mark.parametrize("seed", [1, 2])
    def test_ransac_same_index_sets(self, seed):
        """Both packages on the index sets the JAX key draws: the minimal
        sets go in as they are, the refinement set is drawn by the same
        rule from whatever inlier mask each package found."""
        Xw, uv, R, t, active, sigma2 = self._outlier_scene(seed)
        key = jax.random.PRNGKey(seed)
        want = jepnp.epnp_ransac(
            jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(sigma2),
            jnp.asarray(active), jnp.asarray(CAM4), key)
        logits = jnp.log(jnp.asarray(active).astype(jnp.float32) + 1e-9)
        idx = np.asarray(jax.random.categorical(
            key, logits[None, :].repeat(128 * 4, 0)).reshape(128, 4))

        def refine_idx(inl):
            w = jnp.log(jnp.asarray(inl.numpy()).astype(jnp.float32) + 1e-9)
            return T(np.asarray(jax.random.categorical(
                jax.random.fold_in(key, 1), w[None, :].repeat(64, 0))))

        got = tepnp.epnp_ransac_sets(
            T(Xw), T(uv), T(sigma2), T(active), T(CAM4), T(idx), refine_idx)
        assert bool(got.ok) and bool(want.ok)
        assert int(got.n_inliers) == int(want.n_inliers) == 60
        np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
        assert_pose_close(got.R.numpy(), got.t.numpy(), want.R, want.t)
        assert_pose_close(got.R.numpy(), got.t.numpy(), R, t)

    def test_ransac_from_a_generator(self):
        Xw, uv, R, t, active, sigma2 = self._outlier_scene(3)
        args = (T(Xw), T(uv), T(sigma2), T(active), T(CAM4))
        a = tepnp.epnp_ransac(*args, torch.Generator().manual_seed(7))
        b = tepnp.epnp_ransac(*args, torch.Generator().manual_seed(7))
        assert bool(a.ok) and int(a.n_inliers) == 60
        assert not a.inliers.numpy()[100:].any()            # inactive stay out
        assert_pose_close(a.R.numpy(), a.t.numpy(), R, t)
        assert torch.equal(a.R, b.R) and torch.equal(a.inliers, b.inliers)

    def test_ransac_reports_failure(self):
        """Observations unrelated to the points: too few inliers, ok False."""
        rng = np.random.default_rng(4)
        Xw, uv, _, _ = pnp_scene(rng, 64)
        uv = rng.uniform(0, 500, uv.shape).astype(np.float32)
        res = tepnp.epnp_ransac(T(Xw), T(uv), torch.ones(64), torch.ones(64, dtype=torch.bool),
                                T(CAM4), torch.Generator().manual_seed(0))
        assert not bool(res.ok) and int(res.n_inliers) < 10


# ------------------------------------------------------- host read, upload


def test_host_read_and_upload_on_cpu():
    """On a CPU tensor the handle is ready at once and reads the values."""
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    h = HostRead(t)
    assert not h.pending()
    np.testing.assert_array_equal(h.numpy(), t.numpy())
    a = np.arange(6, dtype=np.float32)
    u = upload(a, CPU)
    assert u.device.type == "cpu" and u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), a)
    assert upload(u, CPU) is u


# ---------------------------------------------------------------- the runs


@pytest.fixture(scope="module")
def seq30(data_cache_dir):
    return generate_sequence(
        n_frames=30, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir)


def port_system(tc):
    return tsystem.System(tc, CPU, landmark_capacity=1 << 16,
                          keyframe_capacity=128, enable_loop_closing=False)


def ate_of(system, seq):
    est = np.linalg.inv(system.corrected_trajectory())
    return ate_rmse(est, seq.poses_wc[: len(est)])


def string_events(system):
    return [e for e in system.events if isinstance(e, str)]


def tuple_events(system, kind):
    return [e[2] for e in system.events if isinstance(e, tuple) and e[0] == kind]


@pytest.fixture(scope="module")
def jax_async(seq30):
    """The JAX package's pipelined run over the sequence, stopped and
    flushed after 16 frames so that its state can be carried over
    (``at16``: the port's copies of that state), then run to the end."""
    jc, tc = make_cfgs(seq30)
    jsys = jsystem.System(jc, landmark_capacity=1 << 16, keyframe_capacity=128,
                          enable_loop_closing=False)
    for i in range(16):
        jsys.track_stereo_async(seq30.left[i], seq30.right[i], seq30.timestamps[i])
    jsys.flush_async()
    assert jsys.state == "OK" and len(jsys.trajectory) == 16
    at16 = [convert.system_from_numpy(jsys, tc, CPU) for _ in range(4)]
    kfs16 = jsys.map.keyframes.n
    for i in range(16, 30):
        jsys.track_stereo_async(seq30.left[i], seq30.right[i], seq30.timestamps[i])
    jsys.flush_async()
    return dict(jax=jsys, at16=at16, kfs16=kfs16, tc=tc, ate=ate_of(jsys, seq30))


@pytest.fixture(scope="module")
def port_sync(seq30):
    _, tc = make_cfgs(seq30)
    s = port_system(tc)
    for i in range(30):
        s.track_stereo(seq30.left[i], seq30.right[i], seq30.timestamps[i])
    s.shutdown()
    return s


@pytest.fixture(scope="module")
def port_async(seq30):
    """The port's pipelined run: 20 frames, ``shutdown()`` with a frame in
    flight (what it left is recorded), then the rest and a flush."""
    _, tc = make_cfgs(seq30)
    s = port_system(tc)
    returned = []
    for i in range(20):
        returned.append(s.track_stereo_async(
            seq30.left[i], seq30.right[i], seq30.timestamps[i]).copy())
    in_flight = len(s._async_q)
    s.shutdown()          # no explicit flush_async by the caller
    after_shutdown = dict(n=len(s.trajectory), q=len(s._async_q),
                          pipe=len(s._maint_pipe), queue=len(s._maint_queue))
    s.shutdown()          # idempotent
    after_shutdown["n_again"] = len(s.trajectory)
    for i in range(20, 30):
        s.track_stereo_async(seq30.left[i], seq30.right[i], seq30.timestamps[i])
    n_before_flush = len(s.trajectory)
    s.flush_async()
    return dict(sys=s, in_flight=in_flight, after_shutdown=after_shutdown,
                n_before_flush=n_before_flush, returned=returned)


class TestAsyncSchedule:
    """tests/test_system.py::TestAsyncSchedule on the port."""

    def test_async_matches_sync_accuracy(self, port_async, port_sync, seq30):
        s = port_async["sys"]
        ate_async, ate_sync = ate_of(s, seq30), ate_of(port_sync, seq30)
        assert len(s.trajectory) == 30 == len(s.frame_refs)
        # the one-frame maintenance lag costs at most a small ATE delta
        assert ate_async < max(2.0 * ate_sync, 0.15), (ate_async, ate_sync)
        assert ate_async < ATE_GATE
        # no rescue events on a clean run: the pipeline holds tracking
        assert not [e for e in string_events(s) if "rescue" in e]
        assert {st["state"] for st in s.stats} == {"OK"}

    def test_shutdown_drains_inflight_frames(self, port_async):
        r = port_async
        assert r["in_flight"] == 1            # one frame behind the feed
        assert r["after_shutdown"] == dict(n=20, q=0, pipe=0, queue=0, n_again=20)
        # fed again after the drain, the pipeline is one behind again
        assert r["n_before_flush"] == 29
        assert not r["sys"]._async_q and not r["sys"]._maint_pipe

    def test_returns_the_last_committed_pose(self, port_async):
        """Call i returns the pose of frame i - 1 as it stood then (frame 0
        and 1 go through the synchronous machine and the first dispatch)."""
        r = port_async
        traj = r["sys"].trajectory
        np.testing.assert_array_equal(r["returned"][0], traj[0])
        for i in range(3, 20):
            np.testing.assert_allclose(r["returned"][i], traj[i - 1], atol=0.05)

    def test_mapping_ran_in_stages(self, port_async):
        s = port_async["sys"]
        ba = tuple_events(s, "local_ba")
        maint = tuple_events(s, "maintain")
        assert ba and all(r["ran"] for r in ba)
        assert sum(r["new"] for r in maint) > 100
        assert not any(r["fallback"] for r in maint)
        for key in ("async.dispatch", "async.read", "async.commit",
                    "kf.maintain_dispatch", "kf.maintain_apply",
                    "kf.ba_dispatch", "kf.ba_apply"):
            assert s.time_counts[key] > 0, key
        assert s.time_counts["async.dispatch"] == 29     # frames 1..19, 20..29
        # a keyframe's mapping work never ran inside its own commit
        assert s.time_counts["kf.maintain"] == 0 == s.time_counts["kf.local_ba"]

    def test_against_the_jax_async_run(self, port_async, jax_async, seq30):
        s, j = port_async["sys"], jax_async["jax"]
        assert len(s.trajectory) == len(j.trajectory) == 30
        assert abs(s.map.keyframes.n - j.map.keyframes.n) <= KF_MARGIN
        assert not [e for e in j.events if isinstance(e, str) and "rescue" in e]
        ate_port = ate_of(s, seq30)
        assert ate_port < ATE_FACTOR * jax_async["ate"] + ATE_SLACK, \
            (ate_port, jax_async["ate"])

    def test_localization_mode_drains_first(self, jax_async, seq30):
        """From the JAX run's state at frame 16: two pipelined frames, then
        activate_localization_mode commits the frame in flight and freezes
        the map."""
        s = jax_async["at16"][0]
        for i in (16, 17):
            s.track_stereo_async(seq30.left[i], seq30.right[i], seq30.timestamps[i])
        assert len(s._async_q) == 1
        s.activate_localization_mode()
        assert not s._async_q and not s._maint_pipe and len(s.trajectory) == 18
        kfs = s.map.keyframes.n
        for i in (18, 19, 20):
            s.track_stereo_async(seq30.left[i], seq30.right[i], seq30.timestamps[i])
        s.shutdown()
        assert s.map.keyframes.n == kfs and len(s.trajectory) == 21
        assert s.state in ("OK", "MARGINAL")


class TestCarriedState:
    """``convert.system_from_numpy``: the port continues a JAX run."""

    def test_state_arrives(self, jax_async):
        s = jax_async["at16"][1]
        assert s.state == "OK" and s.frame_id == 15
        assert len(s.trajectory) == 16 == len(s.frame_refs)
        assert s.map.keyframes.n == jax_async["kfs16"] >= 3
        assert set(s.kfdb.bow) == set(range(s.map.keyframes.n)) - {
            k for k in range(s.map.keyframes.n) if not s.map.keyframes.alive[k]}
        assert s.local_mapper is not None and s.kf_ring.arrays is not None
        assert s.last_frame.desc.dtype == torch.int32

    def test_refuses_a_system_with_work_in_flight(self, jax_async):
        fake = type("S", (), dict(_async_q=[1], _maint_queue=[], _maint_pipe=[]))()
        with pytest.raises(ValueError, match="in flight"):
            convert.system_from_numpy(fake, jax_async["tc"], CPU)

    def test_port_continues_the_jax_run_pipelined(self, jax_async, seq30):
        s = jax_async["at16"][1]
        for i in range(16, 30):
            s.track_stereo_async(seq30.left[i], seq30.right[i], seq30.timestamps[i])
        s.shutdown()
        assert len(s.trajectory) == 30
        assert not [e for e in string_events(s) if "rescue" in e]
        assert {st["state"] for st in s.stats} == {"OK"}
        ate = ate_of(s, seq30)
        assert ate < ATE_GATE
        assert ate < ATE_FACTOR * jax_async["ate"] + ATE_SLACK, (ate, jax_async["ate"])
        assert abs(s.map.keyframes.n - jax_async["jax"].map.keyframes.n) <= KF_MARGIN


class TestRescue:
    def test_reference_kf_fallback_recovers_bad_motion_model(self, jax_async, seq30):
        """tests/test_system.py's case on the port, from the JAX run's state
        at frame 16: with a garbage velocity prediction, BoW matching
        against the reference keyframe recovers the pose
        (Tracking.py:329-356)."""
        s = jax_async["at16"][3]
        assert s.state == "OK"
        # corrupt the motion model: ~34 degrees of yaw + 4 m sideways
        bad = np.eye(4, dtype=np.float32)
        c, sn = np.cos(0.6), np.sin(0.6)
        bad[:3, :3] = [[c, 0, sn], [0, 1, 0], [-sn, 0, c]]
        bad[0, 3] = 4.0
        s.velocity = bad
        calls = []
        real = s._track_reference_keyframe
        s._track_reference_keyframe = lambda f: (calls.append(real(f)), calls[-1])[1]
        s.track_stereo(seq30.left[16], seq30.right[16], seq30.timestamps[16])
        assert s.state == "OK", s.stats[-1]
        assert "sync:weak" in s.events
        assert len(calls) == 1 and calls[0] is not None     # the fallback held
        est_wc = np.linalg.inv(s.trajectory[-1])
        err = np.linalg.norm(est_wc[:3, 3] - seq30.poses_wc[16][:3, 3])
        assert err < RELOC_GATE, f"pose error after fallback {err:.3f} m"

    def test_pipelined_commit_rescues_a_weak_frame(self, jax_async, seq30):
        """The same corruption under the pipelined schedule: the commit
        hands the frame to the per-frame machine (event ``async:rescue``)
        and the run goes on."""
        s = jax_async["at16"][2]
        s.track_stereo_async(seq30.left[16], seq30.right[16], seq30.timestamps[16])
        s.flush_async()
        bad = np.eye(4, dtype=np.float32)
        c, sn = np.cos(0.6), np.sin(0.6)
        bad[:3, :3] = [[c, 0, sn], [0, 1, 0], [-sn, 0, c]]
        bad[0, 3] = 4.0
        s.velocity = bad
        for i in (17, 18, 19):
            s.track_stereo_async(seq30.left[i], seq30.right[i], seq30.timestamps[i])
        s.shutdown()
        assert "async:rescue" in s.events
        assert s.state == "OK" and len(s.trajectory) == 20
        est_wc = np.linalg.inv(s.trajectory[-1])
        err = np.linalg.norm(est_wc[:3, 3] - seq30.poses_wc[19][:3, 3])
        assert err < RELOC_GATE, err

    def test_kidnap_recovery(self, jax_async, seq30):
        """tests/test_reloc.py on the port, from the JAX run's state at
        frame 16: two frames of noise destroy tracking, a mapped view
        (frame 5) relocalizes through BoW candidates and EPnP."""
        s = jax_async["at16"][0]      # 21 frames in, localization mode on
        s.deactivate_localization_mode()
        rng = np.random.default_rng(0)
        noise = rng.uniform(0, 255, seq30.left[0].shape).astype(np.float32)
        states = []
        for _ in range(2):
            s.track_stereo(noise, noise, 0.0)
            states.append(s.state)
        assert "WEAK" in states
        Tcw = s.track_stereo(seq30.left[5], seq30.right[5], 99.0)
        gt = np.linalg.inv(seq30.poses_wc[5])
        err = np.linalg.norm(Tcw[:3, 3] - gt[:3, 3])
        assert s.state == "OK", s.state
        assert s.last_reloc_frame == s.frame_id       # _relocalize answered
        assert err < RELOC_GATE, f"reloc pose error {err:.3f} m"

    def test_relocalize_without_candidates_is_none(self, seq30):
        _, tc = make_cfgs(seq30)
        s = port_system(tc)
        assert s._relocalize(None) is None            # no database, no map
        assert s._track_reference_keyframe(None) is None


# ------------------------------------------------------ KITTI IO and CLI


@pytest.fixture(scope="module")
def kitti_dir(seq30, tmp_path_factory):
    """A KITTI-layout directory written by the port's
    ``tools/make_kitti_synth.py``: 8 frames of the sequence as PNGs,
    times.txt, poses.txt and a settings YAML."""
    root = tmp_path_factory.mktemp("kitti")
    make_kitti_synth.write_kitti(SyntheticSequence(
        left=seq30.left[:8], right=seq30.right[:8], poses_wc=seq30.poses_wc[:8],
        K=seq30.K, baseline=seq30.baseline, timestamps=seq30.timestamps[:8]),
        str(root))
    return root


class TestKittiIO:
    def test_sequence_round_trip(self, kitti_dir, seq30):
        left, right, times = tkitti.load_image_paths(str(kitti_dir))
        jl, jr, jt = jkitti.load_image_paths(str(kitti_dir))
        assert (left, right) == (jl, jr) and len(left) == 8
        np.testing.assert_array_equal(times, jt)
        frames = list(tkitti.iter_stereo(str(kitti_dir)))
        assert len(frames) == 8
        for i, (l, r, ts) in enumerate(frames):
            assert l.dtype == np.uint8 and l.shape == (160, 512)
            np.testing.assert_array_equal(l, np.asarray(seq30.left[i]).astype(np.uint8))
            np.testing.assert_array_equal(r, np.asarray(seq30.right[i]).astype(np.uint8))
            assert ts == pytest.approx(float(seq30.timestamps[i]), rel=1e-6)
        with pytest.raises(FileNotFoundError):
            tkitti.read_grayscale(str(kitti_dir / "image_2" / "999999.png"))

    def test_trajectory_round_trip(self, tmp_path, seq30):
        poses_cw = np.linalg.inv(seq30.poses_wc[:10])
        a, b = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
        tkitti.save_trajectory_kitti(a, poses_cw)
        jkitti.save_trajectory_kitti(b, poses_cw)
        assert open(a).read() == open(b).read()
        back = tkitti.load_trajectory_kitti(a)
        np.testing.assert_allclose(back, seq30.poses_wc[:10], atol=1e-6)
        np.testing.assert_array_equal(back, jkitti.load_trajectory_kitti(a))


class TestCLI:
    @pytest.mark.parametrize("async_mode", [False, True])
    def test_runs_on_the_cpu(self, kitti_dir, tmp_path, seq30, capsys, async_mode):
        out = str(tmp_path / "traj.txt")
        argv = ["--pathToSequence", str(kitti_dir),
                "--pathToSettings", str(kitti_dir / "settings.yaml"),
                "--output", out, "--device", "cpu", "--maxFrames", "6"]
        stereo_kitti.main(argv + (["--async"] if async_mode else []))
        said = capsys.readouterr().out
        assert "tracking 6 frames" in said and "on cpu" in said and "done: 6" in said
        Twc = tkitti.load_trajectory_kitti(out)
        assert Twc.shape == (6, 4, 4)
        assert ate_rmse(Twc, seq30.poses_wc[:6]) < 0.1

    def test_cuda_without_a_card_fails_loudly(self, kitti_dir, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(SystemExit, match="no CUDA device"):
            stereo_kitti.main(["--pathToSequence", str(kitti_dir),
                               "--pathToSettings", str(kitti_dir / "settings.yaml"),
                               "--output", str(tmp_path / "t.txt")])

    def test_window_names_its_item(self, kitti_dir, tmp_path, seq30, capsys):
        """``--window 4`` runs the windowed schedule: 6 frames are one
        window (initialization, then a 3-frame scan) and a 2-frame tail
        tracked per frame; the trajectory has a line per frame.  (The name
        is the stub's this test replaced, kept so that the test keeps its
        identity.)"""
        out = str(tmp_path / "t.txt")
        stereo_kitti.main(["--pathToSequence", str(kitti_dir),
                           "--pathToSettings", str(kitti_dir / "settings.yaml"),
                           "--output", out, "--device", "cpu", "--window", "4",
                           "--maxFrames", "6"])
        said = capsys.readouterr().out
        assert "tracking 6 frames" in said and "done: 6" in said
        assert "frame 4/6" in said
        with open(out) as f:
            assert len(f.read().splitlines()) == 6
        Twc = tkitti.load_trajectory_kitti(out)
        assert ate_rmse(Twc, seq30.poses_wc[:6]) < 0.1
