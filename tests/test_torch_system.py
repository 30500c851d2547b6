"""The PyTorch port's ``System`` (synchronous schedule) against the JAX
package's on the cached synthetic sequence, loop closing off.  The
pipelined schedule and the weak-tracking fallbacks are held in
``tests/test_torch_async.py``.

The two packages' descriptors differ in ~0.03% of their bits (IC-angle
rounding, see ROADMAP.md queue 3), so the runs are not compared pose for
pose at machine precision.  The port is held to the JAX test's own gate
(ATE < 0.25 m over 30 frames, tests/test_system.py) and to stated margins
of the JAX run: ATE within 1.5x + 2 cm, keyframe count within 2,
landmark count within 10%.
"""

import itertools

import numpy as np
import pytest
import torch

from test_keyframe_policy import reference_decision
from test_torch_mapping import make_cfgs

from pyorbslam_tpu.io import kitti as jkitti
from pyorbslam_tpu.io.synthetic import generate_sequence
from pyorbslam_tpu.slam import system as jsystem
from pyorbslam_tpu.utils.metrics import ate_rmse

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.slam import system as tsystem

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
ATE_GATE = 0.25          # m, tests/test_system.py's bound on this sequence
ATE_FACTOR, ATE_SLACK = 1.5, 0.02
KF_MARGIN = 2
LANDMARK_MARGIN = 0.10


# ------------------------------------------------------- keyframe policy

POLICY_ROWS = list(itertools.product([10, 16, 40, 80, 200], [0, 50, 100, 300]))


@pytest.mark.parametrize("n_inliers,n_ref", POLICY_ROWS)
def test_need_new_keyframe(n_inliers, n_ref):
    """The JAX test's truth table, one case per (inliers, reference
    matches) row: the port's predicate equals the JAX package's and the
    independent transcription of Tracking.py:470-520."""
    grid = itertools.product(
        [1, 2, 5, 20], [5, 30], [0, 25, 29], [-1000, 28], [50, 150],
        [60, 80], [0, 3])
    for nkfs, fid, lkf, lreloc, tc, ntc, minf in grid:
        kw = dict(n_inliers=n_inliers, n_ref_matches=n_ref, n_kfs=nkfs,
                  frame_id=fid, last_kf_frame=lkf, last_reloc_frame=lreloc,
                  tracked_close=tc, non_tracked_close=ntc, min_frames=minf,
                  max_frames=10)
        got = tsystem.need_new_keyframe(**kw)
        assert got == jsystem.need_new_keyframe(**kw), kw
        assert got == reference_decision(
            n_inliers, n_ref, nkfs, fid, lkf, lreloc, tc, ntc, minf, 10), kw
        for busy in ((False, 0), (False, 3)):
            assert tsystem.need_new_keyframe(
                mapper_idle=busy[0], queue_len=busy[1], **kw) == \
                jsystem.need_new_keyframe(
                    mapper_idle=busy[0], queue_len=busy[1], **kw)


# ------------------------------------------------------------ the runs


@pytest.fixture(scope="module")
def seq30(data_cache_dir):
    return generate_sequence(
        n_frames=30, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir)


def run_both(seq, n_frames, use_atlas):
    """Both packages over the first frames of ``seq``.  The JAX System's
    fallbacks are wrapped to record any call."""
    import dataclasses
    jc, tc = make_cfgs(seq)
    if not use_atlas:
        jc = dataclasses.replace(jc, orb=dataclasses.replace(jc.orb, use_atlas=False))
        tc = convert.config_from_dict(convert.config_to_dict(jc))
    jsys = jsystem.System(jc, landmark_capacity=1 << 16, keyframe_capacity=128,
                          enable_loop_closing=False)
    fallbacks = []
    for name in ("_track_reference_keyframe", "_relocalize"):
        real = getattr(jsys, name)
        setattr(jsys, name,
                lambda f, _real=real, _n=name: (fallbacks.append(_n), _real(f))[1])
    tsys = tsystem.System(tc, CPU, landmark_capacity=1 << 16,
                          keyframe_capacity=128, enable_loop_closing=False)
    states = []
    for i in range(n_frames):
        jsys.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        tsys.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        states.append(tsys.state)
    tsys.shutdown()

    def ate(s):
        return ate_rmse(np.linalg.inv(s.corrected_trajectory()),
                        seq.poses_wc[:n_frames])

    return dict(jax=jsys, port=tsys, states=states, fallbacks=fallbacks,
                ate_jax=ate(jsys), ate_port=ate(tsys), n=n_frames,
                gt=seq.poses_wc[:n_frames])


@pytest.fixture(scope="module")
def atlas_runs(seq30):
    return run_both(seq30, 30, use_atlas=True)


@pytest.fixture(scope="module")
def level_runs(seq30):
    return run_both(seq30, 12, use_atlas=False)


def events(system, kind):
    return [e[2] for e in system.events if isinstance(e, tuple) and e[0] == kind]


class TestSystemRun:
    def test_ate_under_the_jax_tests_gate(self, atlas_runs):
        assert atlas_runs["ate_port"] < ATE_GATE, atlas_runs["ate_port"]
        # and the raw per-frame poses, as tests/test_system.py takes them
        raw = ate_rmse(np.linalg.inv(np.stack(atlas_runs["port"].trajectory)),
                       atlas_runs["gt"])
        assert raw < ATE_GATE

    def test_ate_within_margin_of_jax(self, atlas_runs):
        r = atlas_runs
        assert r["ate_port"] < ATE_FACTOR * r["ate_jax"] + ATE_SLACK, \
            (r["ate_port"], r["ate_jax"])

    def test_every_frame_ok_and_no_fallback(self, atlas_runs):
        r = atlas_runs
        assert set(r["states"]) == {"OK"}
        assert "sync:weak" not in r["port"].events
        # the JAX run on the same sequence never reached a fallback either
        assert r["fallbacks"] == []
        assert len(r["port"].trajectory) == r["n"] == len(r["port"].frame_refs)

    def test_keyframes_and_landmarks_within_margin(self, atlas_runs):
        jm, tm = atlas_runs["jax"].map, atlas_runs["port"].map
        assert tm.keyframes.n > 3
        assert abs(tm.keyframes.n - jm.keyframes.n) <= KF_MARGIN
        n_j = int(jm.landmarks.alive.sum())
        n_t = int(tm.landmarks.alive.sum())
        assert abs(n_t - n_j) <= LANDMARK_MARGIN * n_j, (n_t, n_j)

    def test_local_ba_ran_and_mapping_added_points(self, atlas_runs):
        port = atlas_runs["port"]
        ba = events(port, "local_ba")
        assert ba and all(r["ran"] for r in ba)
        assert all(r["n_cams"] >= 2 and r["n_obs"] > 1000 for r in ba)
        maint = events(port, "maintain")
        assert sum(r["new"] for r in maint) > 100      # triangulated
        assert sum(r["fused"] for r in maint) > 100
        assert not any(r["fallback"] for r in maint)   # the ring held them
        for key in ("perframe.track", "kf.insert_total", "kf.maintain",
                    "kf.local_ba"):
            assert port.times[key] > 0 and port.time_counts[key] > 0
        assert port.map.times["ba.solve"] > 0

    def test_map_structures_consistent(self, atlas_runs):
        """tests/test_system.py::test_map_structures_consistent's checks."""
        m = atlas_runs["port"].map
        assert m.keyframes.n >= 3
        ca, cb, cw = m.core.covis_edges()
        assert len(ca) > 0
        for a, b, w in zip(ca.tolist(), cb.tolist(), cw.tolist()):
            assert m.core.covis_weight(b, a) == w
        ids = m.core.observed_landmarks(m.landmarks.n)
        for lm in ids[:500]:
            kfs, feats = m.core.observers(int(lm))
            for kf, feat in zip(kfs.tolist(), feats.tolist()):
                assert m.keyframes.obs_lm[kf, feat] == lm
        alive = np.nonzero(m.landmarks.alive[:m.landmarks.n])[0]
        assert np.isfinite(m.landmarks.pos[alive]).all()

    def test_mirror_follows_the_store(self, atlas_runs):
        """After a forced refresh the device mirror holds the store's rows
        within the delta refresh's tolerances; integer fields are equal."""
        port = atlas_runs["port"]
        lm = port.map.landmarks
        pos, desc, normal, dmin, dmax, alive = (
            t.numpy() for t in port._landmark_mirror(force=True))
        n = lm.n
        assert np.array_equal(alive[:n], lm.alive[:n])
        assert np.array_equal(desc[:n], lm.desc[:n])
        assert np.abs(pos[:n] - lm.pos[:n]).max() <= 2e-3
        assert np.abs(normal[:n] - lm.normal[:n]).max() <= 1e-2
        assert np.abs(dmin[:n] - lm.dmin[:n]).max() <= 1e-2
        assert np.abs(dmax[:n] - lm.dmax[:n]).max() <= 1e-2

    def test_trajectory_file_reads_back(self, atlas_runs, tmp_path):
        port = atlas_runs["port"]
        path = str(tmp_path / "traj.txt")
        port.save_trajectory_kitti(path)
        Twc = jkitti.load_trajectory_kitti(path)
        Tcw = port.corrected_trajectory().astype(np.float64)
        # the file holds the closed-form inverse (Rwc = Rcw^T, twc = -Rwc tcw)
        Rwc = Tcw[:, :3, :3].transpose(0, 2, 1)
        np.testing.assert_allclose(Twc[:, :3, :3], Rwc, atol=1e-8)
        np.testing.assert_allclose(
            Twc[:, :3, 3], -np.einsum("nij,nj->ni", Rwc, Tcw[:, :3, 3]), atol=1e-6)
        assert Twc.shape == (30, 4, 4)


class TestPerLevelRun:
    """The same run with ``use_atlas=False`` (the per-level extractor,
    whose kernels are fast_score and brief_level on a card) at 12 frames."""

    def test_gates(self, level_runs):
        r = level_runs
        assert set(r["states"]) == {"OK"} and r["fallbacks"] == []
        assert r["ate_port"] < ATE_GATE
        assert r["ate_port"] < ATE_FACTOR * r["ate_jax"] + ATE_SLACK, \
            (r["ate_port"], r["ate_jax"])

    def test_map_close_to_jax(self, level_runs):
        jm, tm = level_runs["jax"].map, level_runs["port"].map
        assert tm.keyframes.n >= 3
        assert abs(tm.keyframes.n - jm.keyframes.n) <= KF_MARGIN
        n_j = int(jm.landmarks.alive.sum())
        assert abs(int(tm.landmarks.alive.sum()) - n_j) <= LANDMARK_MARGIN * n_j
        assert any(r["ran"] for r in events(level_runs["port"], "local_ba"))
        assert sum(r["new"] for r in events(level_runs["port"], "maintain")) > 50


class TestModes:
    def test_localization_only_adds_no_keyframes(self, seq30):
        _, tc = make_cfgs(seq30)
        s = tsystem.System(tc, CPU, landmark_capacity=1 << 16,
                           keyframe_capacity=64, enable_loop_closing=False)
        for i in range(8):
            s.track_stereo(seq30.left[i], seq30.right[i], seq30.timestamps[i])
        kfs, lms = s.map.keyframes.n, s.map.landmarks.n
        assert kfs >= 2
        s.activate_localization_mode()
        for i in range(8, 14):
            s.track_stereo(seq30.left[i], seq30.right[i], seq30.timestamps[i])
        assert s.map.keyframes.n == kfs and s.map.landmarks.n == lms
        assert s.state in ("OK", "MARGINAL") and len(s.trajectory) == 14
        s.deactivate_localization_mode()
        for i in range(14, 17):
            s.track_stereo(seq30.left[i], seq30.right[i], seq30.timestamps[i])
        assert s.map.keyframes.n > kfs           # mapping resumes
        s.shutdown()
        s.shutdown()                             # idempotent
        s.reset()
        assert s.state == "NOT_INITIALIZED" and s.map.keyframes.n == 0
        assert s.corrected_trajectory().shape == (0, 4, 4)

    WINDOWED = {
        # the windowed entry points:
        # (frames fed, poses returned, frames scanned in one dispatch)
        "track_stereo_window": (4, 4, 3),
        "window_feed": (4, 4, 3),
        "window_flush": (0, 0, 0),
    }

    @pytest.mark.parametrize("name", sorted(WINDOWED))
    def test_not_yet_ported_entry_points_raise(self, seq30, name):
        """Each windowed entry point runs from ``NOT_INITIALIZED``:
        ``track_stereo_window`` and the first ``window_feed`` initialize on
        their first frame and scan the other three in one dispatch, returning
        all four poses; ``window_flush`` with nothing pending returns none.
        (The name is the stub's this test replaced, kept so that the test
        keeps its identity.)"""
        _, tc = make_cfgs(seq30)
        s = tsystem.System(tc, CPU, landmark_capacity=1 << 14, keyframe_capacity=16,
                           enable_loop_closing=False)
        n_fed, n_out, n_scanned = self.WINDOWED[name]
        w = slice(0, n_fed)
        if name == "window_flush":
            poses = s.window_flush()
        else:
            poses = getattr(s, name)(seq30.left[w], seq30.right[w], seq30.timestamps[w])
        assert poses.shape == (n_out, 4, 4) and poses.dtype == np.float32
        assert np.isfinite(poses).all()
        assert len(s.trajectory) == n_out and s._pending_window is None
        assert s.time_counts["window.dispatch"] == (1 if n_scanned else 0)
        if n_out:
            assert s.state == "OK" and s.map.keyframes.n >= 1
            np.testing.assert_array_equal(poses, np.stack(s.trajectory))
            gt = np.linalg.inv(seq30.poses_wc[:n_out])
            assert np.abs(poses[:, :3, 3] - gt[:, :3, 3]).max() < 0.1

    def test_loop_closing_default_is_refused(self, seq30):
        """Loop closing is on by default in both packages, and the port's
        default ``System(cfg, device)`` constructs and creates its loop
        closer at the first keyframe (nothing is refused any more)."""
        _, tc = make_cfgs(seq30)
        assert tsystem.System.__dataclass_fields__["enable_loop_closing"].default \
            is jsystem.System.__dataclass_fields__["enable_loop_closing"].default
        s = tsystem.System(tc, CPU)
        assert s.enable_loop_closing and s.loop_closer is None
        s.track_stereo(seq30.left[0], seq30.right[0], seq30.timestamps[0])
        assert s.map.keyframes.n == 1
        assert s.loop_closer is not None and s.loop_closer.kfdb is s.kfdb
        assert s.loop_closer.map is s.map
        s.reset()
        assert s.loop_closer is None
