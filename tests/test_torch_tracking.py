"""Parity of the PyTorch port's tracking path with the JAX package, and
the port's tracking-only slice held to tests/test_tracking_vo.py's gates.

Stage tests feed both packages the same frames and the same landmark
store: the JAX package builds them, and ``pyorbslam_tpu_torch.convert``
carries them across.  Tolerances: stats within one match, assignments
equal on >= 99% of slots, poses within the pose optimizer's own
tolerance (rotation 1e-4 rad, translation 1e-3 m), since both packages
solve the same float32 LM with sums taken in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyorbslam_tpu import config as jcfg_mod
from pyorbslam_tpu.geometry import se3 as jse3
from pyorbslam_tpu.ops import hamming as jham
from pyorbslam_tpu.ops import matching as jmatch
from pyorbslam_tpu.optim import pose_opt as jpose
from pyorbslam_tpu.slam import frame as jframe
from pyorbslam_tpu.slam import tracking as jtrack

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.ops import hamming as tham
from pyorbslam_tpu_torch.ops import matching as tmatch
from pyorbslam_tpu_torch.optim import pose_opt as tpose
from pyorbslam_tpu_torch.slam import tracking as ttrack
from pyorbslam_tpu_torch.utils.metrics import ate_rmse, rpe

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
ROT_TOL = 1e-4      # rad
TRANS_TOL = 1e-3    # m


def T(a):
    return torch.as_tensor(np.array(a, order="C"))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def pose_close(Ta, Tb):
    """Rotation angle between the two within ROT_TOL (||Ra - Rb||_F is
    sqrt(2) times the angle for small angles; arccos of the trace is not
    resolvable near zero) and translations within TRANS_TOL."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    ang = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / np.sqrt(2.0)
    return ang < ROT_TOL and np.abs(Ta[:3, 3] - Tb[:3, 3]).max() < TRANS_TOL


def slot_agreement(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.fixture(scope="module")
def cfgs(synth_seq):
    seq = synth_seq
    jc = jcfg_mod.SlamConfig(
        camera=jcfg_mod.CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=seq.left.shape[2], height=seq.left.shape[1],
            bf=seq.bf, th_depth=40.0,
        ),
        orb=jcfg_mod.OrbConfig(n_features=1000),
    )
    return jc, convert.config_from_dict(convert.config_to_dict(jc))


@pytest.fixture(scope="module")
def jax_state(synth_seq, cfgs):
    """The JAX Tracker's state after frame 0 (its landmark store, frame
    and per-feature landmark ids) plus frame 1 built by the JAX package,
    and the same state carried across to the port."""
    jc, _ = cfgs
    seq = synth_seq
    jtr = jtrack.Tracker(jc, landmark_capacity=16384)
    jtr.track(seq.left[0], seq.right[0], seq.timestamps[0])
    frame1 = jframe.build_stereo_frame_jit(
        jnp.asarray(seq.left[1], jnp.float32), jnp.asarray(seq.right[1], jnp.float32), jc)
    store = jtr.landmarks
    return dict(
        jstore=store, jframe0=jtr.last_frame, jframe1=frame1,
        assign0=jtr.last_assign.copy(),
        tstore=convert.landmarks_from_numpy(store),
        tframe0=convert.frame_from_numpy(jtr.last_frame, CPU),
        tframe1=convert.frame_from_numpy(frame1, CPU),
    )


def _motion_inputs(state):
    store = state["jstore"]
    lm_ids = store.resolve(state["assign0"])
    safe = np.maximum(lm_ids, 0)
    return lm_ids, dict(q_pos=store.pos[safe], q_desc=store.desc[safe],
                        q_active=lm_ids >= 0)


@pytest.fixture(scope="module")
def motion_results(jax_state, cfgs):
    jc, tc = cfgs
    lm_ids, q = _motion_inputs(jax_state)
    f0j, f1j = jax_state["jframe0"], jax_state["jframe1"]
    eye = np.eye(4, dtype=np.float32)
    jres = jtrack.motion_track_step(
        f1j, jnp.asarray(q["q_pos"]), jnp.asarray(q["q_desc"]), f0j.angle,
        f0j.octave, jnp.asarray(q["q_active"]), jnp.asarray(eye), jnp.asarray(eye), jc)
    f0t, f1t = jax_state["tframe0"], jax_state["tframe1"]
    tres = ttrack.motion_track_step(
        f1t, T(q["q_pos"]), T(convert.desc_to_port(q["q_desc"])), f0t.angle,
        f0t.octave, T(q["q_active"]), T(eye), T(eye), tc)
    return lm_ids, jres, tres


class TestMatching:
    def _queries(self, jax_state, cfgs):
        jc = cfgs[0]
        _, q = _motion_inputs(jax_state)
        f0, f1 = jax_state["jframe0"], jax_state["jframe1"]
        cam = np.array([jc.camera.fx, jc.camera.fy, jc.camera.cx, jc.camera.cy,
                        jc.camera.bf], np.float32)
        bounds = np.array([0, jc.camera.width - 1, 0, jc.camera.height - 1], np.float32)
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[2, 3] = -0.8          # about one frame of forward motion
        proj = jmatch.project_points(jnp.asarray(Tcw), jnp.asarray(q["q_pos"]),
                                     jnp.asarray(cam), jnp.asarray(bounds))
        sf = np.asarray(jc.orb.scale_factors, np.float32)
        oct0 = np.asarray(f0.octave)
        args = dict(
            q_u=np.asarray(proj.u), q_v=np.asarray(proj.v), q_ur=np.asarray(proj.ur),
            q_desc_bits=np.asarray(jham.unpack_bits(jnp.asarray(q["q_desc"]))),
            q_pop=np.asarray(jham.popcount(jnp.asarray(q["q_desc"]))),
            q_radius=(15.0 * sf[oct0]).astype(np.float32),
            q_min_level=np.maximum(oct0 - 1, 0).astype(np.int32),
            q_max_level=(oct0 + 1).astype(np.int32),
            q_active=q["q_active"] & np.asarray(proj.in_image),
            f_xy=np.asarray(f1.xy), f_octave=np.asarray(f1.octave),
            f_u_right=np.asarray(f1.u_right), f_desc_bits=np.asarray(f1.desc_bits),
            f_pop=np.asarray(jham.popcount(f1.desc)), f_free=np.asarray(f1.valid),
        )
        return args, Tcw, cam, bounds, q

    @pytest.mark.parametrize("ratio", [None, 0.8])
    def test_match_by_projection_identical(self, jax_state, cfgs, ratio):
        args, *_ = self._queries(jax_state, cfgs)
        jidx, jdist, jm = jmatch.match_by_projection(
            **{k: jnp.asarray(v) for k, v in args.items()}, ratio=ratio)
        tidx, tdist, tm = tmatch.match_by_projection(
            **{k: T(v) for k, v in args.items()}, ratio=ratio)
        assert int(np.asarray(jm).sum()) > 100
        np.testing.assert_array_equal(N(tidx), np.asarray(jidx))
        np.testing.assert_array_equal(N(tm), np.asarray(jm))
        np.testing.assert_array_equal(N(tdist), np.asarray(jdist))

    @pytest.mark.parametrize("node_gate,ratio", [(True, 0.7), (True, 1.5),
                                                 (False, 0.7), (False, 1.5)])
    def test_match_by_bow_identical_with_ties(self, node_gate, ratio):
        """search_by_BoW on descriptors drawn from 40 prototypes, so equal
        distances and several queries on one feature are the rule: every
        integer output equals the JAX package's (first column among equal
        distances, lower distance then lower query index per feature)."""
        rng = np.random.default_rng(11)
        Q, F = 300, 400
        base = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint64).astype(np.uint32)
        qd = base[rng.integers(0, 40, Q)].copy()
        fd = base[rng.integers(0, 40, F)].copy()
        for i in np.nonzero(rng.random(Q) < 0.7)[0]:
            qd[i, rng.integers(0, 8)] ^= np.uint32(1 << int(rng.integers(0, 32)))
        qn = rng.integers(0, 5, Q).astype(np.int32)
        fn = rng.integers(0, 5, F).astype(np.int32)
        qa, fa = rng.random(Q) < 0.9, rng.random(F) < 0.9
        jq, jf = jnp.asarray(qd), jnp.asarray(fd)
        want = jmatch.match_by_bow(
            jham.unpack_bits(jq), jham.popcount(jq), jnp.asarray(qn), jnp.asarray(qa),
            jham.unpack_bits(jf), jham.popcount(jf), jnp.asarray(fn), jnp.asarray(fa),
            ratio=ratio, node_gate=node_gate)
        tq, tf = T(convert.desc_to_port(qd)), T(convert.desc_to_port(fd))
        got = tmatch.match_by_bow(
            tham.unpack_bits(tq), tham.popcount(tq), T(qn), T(qa),
            tham.unpack_bits(tf), tham.popcount(tf), T(fn), T(fa),
            ratio=ratio, node_gate=node_gate)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(N(w), N(g))
        if ratio > 1.0:
            assert int(N(got[2]).sum()) > 20     # the case is not empty
        # the two matchers of the weak-tracking fallbacks, from packed words
        idx, dist, matched = tmatch.bow_match(
            tq, T(qn), T(qa), tham.unpack_bits(tf), tham.popcount(tf), T(fn), T(fa))
        if node_gate and ratio == 0.7:
            for w, g in zip(want, (idx, dist, matched)):
                np.testing.assert_array_equal(N(w), N(g))
        qang = rng.uniform(0, 360, Q).astype(np.float32)
        fang = rng.uniform(0, 360, F).astype(np.float32)
        ridx, rmatched = tmatch.bow_match_rot(
            tq, T(qn), T(qa), tham.unpack_bits(tf), tham.popcount(tf), T(fn), T(fa),
            T(qang), T(fang))
        jkeep = jmatch.rotation_consistency_mask(
            jnp.asarray(qang), jnp.asarray(fang), jnp.maximum(jnp.asarray(N(idx)), 0),
            jnp.asarray(N(matched)))
        np.testing.assert_array_equal(N(rmatched), N(jkeep))
        np.testing.assert_array_equal(N(ridx), N(idx))

    def test_rotation_consistency_identical(self, jax_state, cfgs):
        args, *_ = self._queries(jax_state, cfgs)
        jidx, _, jm = jmatch.match_by_projection(
            **{k: jnp.asarray(v) for k, v in args.items()})
        q_angle = np.asarray(jax_state["jframe0"].angle)
        f_angle = np.asarray(jax_state["jframe1"].angle)
        idx = np.maximum(np.asarray(jidx), 0)
        for cut in (True, False):
            ref = np.asarray(jmatch.rotation_consistency_mask(
                jnp.asarray(q_angle), jnp.asarray(f_angle), jnp.asarray(idx), jm,
                apply_ratio_cut=cut))
            got = N(tmatch.rotation_consistency_mask(
                T(q_angle), T(f_angle), T(idx), T(np.asarray(jm)), apply_ratio_cut=cut))
            np.testing.assert_array_equal(got, ref)
            assert 0 < ref.sum() <= np.asarray(jm).sum()

    def test_projection_and_gates(self, jax_state, cfgs):
        _, Tcw, cam, bounds, _ = self._queries(jax_state, cfgs)
        store = jax_state["jstore"]
        n = store.n
        jp = jmatch.project_points(jnp.asarray(Tcw), jnp.asarray(store.pos[:n]),
                                   jnp.asarray(cam), jnp.asarray(bounds))
        tp = tmatch.project_points(T(Tcw), T(store.pos[:n]), T(cam), T(bounds))
        for name in jp._fields:
            np.testing.assert_allclose(N(getattr(tp, name)),
                                       np.asarray(getattr(jp, name)), rtol=1e-5, atol=1e-4)
        Ow = np.asarray(jmatch.se3_center(jnp.asarray(Tcw)))
        jg = jmatch.frustum_gate(jp, jnp.asarray(store.normal[:n]), jnp.asarray(store.dmin[:n]),
                                 jnp.asarray(store.dmax[:n]), jnp.asarray(store.pos[:n]),
                                 jnp.asarray(Ow))
        tg = tmatch.frustum_gate(tp, T(store.normal[:n]), T(store.dmin[:n]),
                                 T(store.dmax[:n]), T(store.pos[:n]), T(Ow))
        assert slot_agreement(N(tg), np.asarray(jg)) >= 0.999
        js = jmatch.predict_scale(jp.dist, jnp.asarray(store.dmax[:n] / 1.2),
                                  float(np.log(1.2)), 8)
        ts = tmatch.predict_scale(tp.dist, T(store.dmax[:n] / 1.2), float(np.log(1.2)), 8)
        assert slot_agreement(N(ts), np.asarray(js)) >= 0.999


class TestPoseOptimization:
    def test_matches_jax(self):
        """Same synthetic problem (noise + 15% outliers): inlier count
        within one, rotation within 1e-4 rad, translation within 1e-3 m."""
        rng = np.random.default_rng(12)
        n = 400
        Xw = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n),
                       rng.uniform(4, 35, n)], 1).astype(np.float32)
        xi_true = np.array([0.02, -0.03, 0.01, 0.2, -0.05, 0.6], np.float32)
        T_true = np.asarray(jse3.exp_se3(jnp.asarray(xi_true)))
        cam = np.array([300.0, 300.0, 256.0, 80.0, 300.0 * 0.54], np.float32)
        Pc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
        u = cam[0] * Pc[:, 0] / Pc[:, 2] + cam[2]
        v = cam[1] * Pc[:, 1] / Pc[:, 2] + cam[3]
        obs = np.stack([u, v, u - cam[4] / Pc[:, 2]], 1)
        obs += rng.normal(0, 0.6, obs.shape)
        out = rng.random(n) < 0.15
        obs[out] += rng.uniform(-40, 40, (out.sum(), 3))
        obs = obs.astype(np.float32)
        octave = rng.integers(0, 8, n)
        inv_sigma2 = (1.0 / 1.44 ** octave).astype(np.float32)
        active = rng.random(n) < 0.9
        T0 = np.asarray(jse3.exp_se3(jnp.asarray(
            xi_true + rng.normal(0, 0.02, 6).astype(np.float32))))
        jr = jpose.pose_optimization(jnp.asarray(T0), jnp.asarray(Xw), jnp.asarray(obs),
                                     jnp.asarray(inv_sigma2), jnp.asarray(active),
                                     jnp.asarray(cam))
        tr = tpose.pose_optimization(T(T0), T(Xw), T(obs), T(inv_sigma2), T(active), T(cam))
        assert abs(int(tr.num_inliers) - int(jr.num_inliers)) <= 1
        assert int(jr.num_inliers) > 250
        assert pose_close(N(tr.Tcw), np.asarray(jr.Tcw))
        assert slot_agreement(N(tr.inliers), np.asarray(jr.inliers)) >= 0.99
        e_j, J_j = jpose.stereo_residual_jacobian(jnp.asarray(T0), jnp.asarray(Xw),
                                                  jnp.asarray(obs), jnp.asarray(cam))
        e_t, J_t = tpose.stereo_residual_jacobian(T(T0), T(Xw), T(obs), T(cam))
        np.testing.assert_allclose(N(e_t), np.asarray(e_j), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(N(J_t), np.asarray(J_j), rtol=1e-4, atol=1e-3)

    def test_too_few_points_returns_initial(self):
        T0 = np.eye(4, dtype=np.float32)
        T0[0, 3] = 0.3
        r = tpose.pose_optimization(T(T0), torch.zeros(5, 3), torch.zeros(5, 3),
                                    torch.ones(5), torch.tensor([1, 1, 0, 0, 0], dtype=torch.bool),
                                    T(np.array([300, 300, 256, 80, 160], np.float32)))
        np.testing.assert_array_equal(N(r.Tcw), T0)


class TestTrackingSteps:
    def test_motion_track_step(self, motion_results):
        _, jres, tres = motion_results
        assert int(jres.n_matches) > 100
        assert abs(int(tres.n_matches) - int(jres.n_matches)) <= 1
        assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= 1
        assert slot_agreement(N(tres.feat_query), np.asarray(jres.feat_query)) >= 0.99
        assert pose_close(N(tres.Tcw), np.asarray(jres.Tcw))
        assert tres.feat_query.dtype == torch.int32

    def test_local_track_step(self, jax_state, motion_results, cfgs):
        jc, tc = cfgs
        lm_ids, jres, _ = motion_results
        store = jax_state["jstore"]
        fq = np.asarray(jres.feat_query)
        assign = np.where(fq >= 0, lm_ids[np.maximum(fq, 0)], -1)
        local = np.setdiff1d(np.arange(store.n, dtype=np.int32), assign[assign >= 0])
        cap = jc.tracking.max_local_points
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local)] = local
        ps = np.maximum(p_ids, 0)
        feat_xw = store.pos[np.maximum(assign, 0)]
        Tcw = np.asarray(jres.Tcw)
        common = [feat_xw, assign >= 0, store.pos[ps], store.desc[ps], store.normal[ps],
                  store.dmin[ps], store.dmax[ps], p_ids >= 0, Tcw]
        jl = jtrack.local_track_step(jax_state["jframe1"], *map(jnp.asarray, common), jc)
        tcommon = [T(a) for a in common]
        tcommon[3] = T(convert.desc_to_port(store.desc[ps]))
        tl = ttrack.local_track_step(jax_state["tframe1"], *tcommon, tc)
        assert int(jl.n_inliers) > 100
        assert abs(int(tl.n_inliers) - int(jl.n_inliers)) <= 1
        assert slot_agreement(N(tl.feat_local), np.asarray(jl.feat_local)) >= 0.99
        assert slot_agreement(N(tl.p_visible), np.asarray(jl.p_visible)) >= 0.99
        assert pose_close(N(tl.Tcw), np.asarray(jl.Tcw))

    def test_fused_chain_row(self, synth_seq, jax_state, cfgs):
        """The packed row of fused_track_chain_step for frame 1: each
        package builds frame 1 from the images itself; the map, frame 0
        and its landmark ids come from the same JAX Tracker state."""
        jc, tc = cfgs
        seq = synth_seq
        js, ts = jax_state["jstore"], jax_state["tstore"]
        cap = jc.tracking.max_local_points
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: js.n] = np.arange(js.n)
        eye = np.eye(4, dtype=np.float32)
        mirror_j = [jnp.asarray(getattr(js, k)) for k in convert.MIRROR_FIELDS]
        jrow, _ = jtrack.fused_track_chain_step(
            jnp.asarray(seq.left[1]), jnp.asarray(seq.right[1]), *mirror_j,
            jax_state["jframe0"], jnp.asarray(jax_state["assign0"]),
            jnp.asarray(eye), jnp.asarray(eye), jnp.asarray(p_ids), jc)
        m = convert.landmark_mirror(ts, CPU)
        trow, tframe1 = ttrack.fused_track_chain_step(
            T(seq.left[1]), T(seq.right[1]), *(m[k] for k in convert.MIRROR_FIELDS),
            jax_state["tframe0"], T(jax_state["assign0"]), T(eye), T(eye), T(p_ids), tc)
        jrow, trow = np.asarray(jrow), N(trow)
        n = tframe1.capacity
        assert trow.shape == jrow.shape == (21 + n + cap // 32,)
        assert jrow[0] > 100
        assert np.abs(trow[:5] - jrow[:5]).max() <= 1, (trow[:5], jrow[:5])
        assert pose_close(trow[5:21].view(np.float32).reshape(4, 4),
                          jrow[5:21].view(np.float32).reshape(4, 4))
        assert slot_agreement(trow[21:21 + n], jrow[21:21 + n]) >= 0.99
        vis_t = ttrack.unpack_bool_np(trow[21 + n:], cap)
        vis_j = jtrack.unpack_bool_np(jrow[21 + n:], cap)
        assert slot_agreement(vis_t, vis_j) >= 0.99

    def test_read_row_and_snapshot(self, jax_state, cfgs):
        """The host decoders: ``read_row`` of the row that
        ``fused_retrack_step`` builds for frame 1 gives back the stats,
        pose, assignment and visibility the row holds, and ``read_snapshot``
        of ``kf_snapshot`` gives back ``unpack_frame_np(pack_frame(...))``
        and the vocabulary's transform of the frame's descriptors."""
        from pyorbslam_tpu_torch.place.vocabulary import load_default
        from pyorbslam_tpu_torch.slam.frame import pack_frame, unpack_frame_np

        tc = cfgs[1]
        ts, frame = jax_state["tstore"], jax_state["tframe1"]
        n, cap = frame.capacity, tc.tracking.max_local_points
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: ts.n] = np.arange(ts.n)
        eye = T(np.eye(4, dtype=np.float32))
        m = convert.landmark_mirror(ts, CPU)
        row, Tcw, assign = ttrack.fused_retrack_step(
            frame, *(m[k] for k in convert.MIRROR_FIELDS), T(jax_state["assign0"]),
            jax_state["tframe0"], T(p_ids), eye, eye, tc)
        out = N(row)
        r = ttrack.read_row(out, n, cap)
        assert r.n_matches > 100 and r.p_visible.shape == (cap,) and all(
            np.array_equal(a, b) for a, b in [
                (r[:5], out[:5]), (r.Tcw, N(Tcw)), (r.assign, N(assign)),
                (N(ttrack._bitpack_bool(T(r.p_visible))), out[21 + n:])])

        voc = load_default()
        snap, vocab = ttrack.read_snapshot(N(ttrack.kf_snapshot(
            frame, voc._device_arrays(CPU), voc.k, voc.L, voc.feature_levels_up)), n)
        want = unpack_frame_np(N(pack_frame(frame)), n)
        assert snap.keys() == want.keys() and all(
            np.array_equal(snap[k], want[k]) for k in want) and all(
            np.array_equal(a, b) for a, b in zip(
                vocab, voc.transform(frame.desc, levels_up=voc.feature_levels_up)))


class TestConvert:
    def test_landmarks_and_frames_round_trip(self, jax_state):
        js, ts = jax_state["jstore"], jax_state["tstore"]
        back = convert.landmarks_to_numpy(ts)
        for name, a in back.items():
            np.testing.assert_array_equal(a, np.asarray(getattr(js, name))[: js.n], name)
        assert back["desc"].dtype == np.uint32 and ts.desc.dtype == np.int32
        f = convert.frame_to_numpy(jax_state["tframe1"])
        for name, a in f.items():
            np.testing.assert_array_equal(a, np.asarray(getattr(jax_state["jframe1"], name)))
        # the mirror is a frozen copy, on the CPU too
        fresh = convert.landmarks_from_numpy(js)
        mirror = convert.landmark_mirror(fresh, CPU)
        fresh.pos[0] += 1.0
        np.testing.assert_array_equal(N(mirror["pos"][0]), js.pos[0])


@pytest.fixture(scope="module")
def port_vo_run(synth_seq, cfgs):
    """The port's Tracker over the whole sequence, as test_tracking_vo.py
    runs the JAX one."""
    seq = synth_seq
    tracker = ttrack.Tracker(cfgs[1], CPU)
    for i in range(len(seq.left)):
        tracker.track(seq.left[i], seq.right[i], seq.timestamps[i])
    est_wc = np.linalg.inv(np.stack(tracker.trajectory))
    return tracker, est_wc, seq


class TestPortTrackingVO:
    """tests/test_tracking_vo.py's gates, unchanged, on the port."""

    def test_ate_gate(self, port_vo_run):
        _, est_wc, seq = port_vo_run
        track_len = np.linalg.norm(np.diff(seq.poses_wc[:, :3, 3], axis=0), axis=1).sum()
        ate = ate_rmse(est_wc, seq.poses_wc)
        assert ate < 1.2, f"ATE {ate:.3f} m over {track_len:.1f} m"
        assert ate / track_len < 0.025, f"drift {ate / track_len:.2%}"

    def test_rpe_gate(self, port_vo_run):
        _, est_wc, seq = port_vo_run
        t_rmse, r_rmse = rpe(est_wc, seq.poses_wc)
        assert t_rmse < 0.25, f"RPE-t {t_rmse:.3f} m/frame"
        assert r_rmse < 0.017, f"RPE-r {r_rmse:.4f} rad/frame"

    def test_tracking_never_lost(self, port_vo_run):
        tracker, _, _ = port_vo_run
        weak = sum(1 for s in tracker.stats if s["inliers"] < 20)
        assert weak <= 3, f"{weak} weak/lost frames"
        med_inliers = np.median([s["inliers"] for s in tracker.stats])
        assert med_inliers > 60, f"median inliers {med_inliers}"

    def test_landmark_bookkeeping(self, port_vo_run):
        tracker, _, _ = port_vo_run
        lm = tracker.landmarks
        assert lm.n > 500
        assert lm.alive[:lm.n].all()
        assert (lm.dmin[:lm.n] < lm.dmax[:lm.n]).all()
        assert np.isfinite(lm.pos[:lm.n]).all()

    def test_first_ten_frames_follow_jax(self, port_vo_run, synth_seq, cfgs):
        """Over the first 10 frames the port's camera centres stay within
        1 cm of the JAX Tracker's on the same images."""
        tracker, _, seq = port_vo_run
        jtr = jtrack.Tracker(cfgs[0])
        for i in range(10):
            jtr.track(seq.left[i], seq.right[i], seq.timestamps[i])
        cj = np.linalg.inv(np.stack(jtr.trajectory))[:, :3, 3]
        ct = np.linalg.inv(np.stack(tracker.trajectory[:10]))[:, :3, 3]
        assert np.linalg.norm(cj - ct, axis=1).max() < 0.01
        for sj, st in zip(jtr.stats, tracker.stats[:9]):
            assert abs(sj["matches"] - st["matches"]) <= 3
            assert abs(sj["inliers"] - st["inliers"]) <= 3
