"""Parity of the PyTorch port's keyframe-side modules with the JAX package:
bundle adjustment, triangulation, the native map core, the keyframe ring,
the per-keyframe maintenance program, SlamMap and LocalMapper.

Inputs are made from a seed with numpy or taken from a short JAX
``System`` run on the cached synthetic sequence, and go through both
packages on the CPU.  Tolerances are stated where they are used: integer
outputs (indices, masks, packed words) must be equal; float outputs of
the two float32 LM solvers agree to 1e-3 m (sums are taken in different
orders, and 15 LM iterations amplify the last bits).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_keyframe_policy as jpolicy
import test_native_mapcore as jnative
from test_ba import make_ba_problem

from pyorbslam_tpu import config as jcfg_mod
from pyorbslam_tpu.ops import triangulation as jtri
from pyorbslam_tpu.optim import ba as jba
from pyorbslam_tpu.slam import local_mapping as jlm
from pyorbslam_tpu.slam import system as jsystem

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.native import mapcore_ffi as tffi
from pyorbslam_tpu_torch.ops import triangulation as ttri
from pyorbslam_tpu_torch.optim import ba as tba
from pyorbslam_tpu_torch.parallel import dist_ba
from pyorbslam_tpu_torch.slam import local_mapping as tlm
from pyorbslam_tpu_torch.slam import system as tsystem
from pyorbslam_tpu_torch.slam.kf_ring import DeviceKFRing
from pyorbslam_tpu_torch.slam.mapstore import KeyFrameStore
from pyorbslam_tpu_torch.slam.slam_map import SlamMap

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BA_POS_TOL = 1e-3    # m, between the two packages' float32 LM solutions


def T(a):
    return convert.tensor_from_numpy(a, CPU)


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ----------------------------------------------------------------- BA


def sorted_obs(prob):
    oc, op = np.asarray(prob.obs_cam), np.asarray(prob.obs_pnt)
    order = np.lexsort((oc, op))
    return (oc[order], op[order], np.asarray(prob.obs_uvr)[order],
            np.asarray(prob.obs_inv_sigma2)[order])


@pytest.fixture(scope="module")
def ba_case():
    rng = np.random.default_rng(1)
    prob, T_true, pts = make_ba_problem(
        rng, noise_px=0.4, pose_noise=0.08, pnt_noise=0.15,
        pad_cam=2, pad_pnt=24)
    return prob, T_true, pts


class TestGridLayout:
    @pytest.mark.parametrize("K", [4, 8])
    def test_grid_from_obs_equal(self, ba_case, K):
        prob = ba_case[0]
        oc, op, uvr, isig = sorted_obs(prob)
        P = prob.pnt_pos.shape[0]
        got = tba.grid_from_obs(oc, op, uvr, isig, P, K=K)
        want = jba.grid_from_obs(oc, op, uvr, isig, P, K=K)
        for g, w in zip(got[:-1], want[:-1]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert got[-1] == want[-1]
        assert (got[-1] > 0) == (K == 4)     # K=4 drops, K=8 does not

    @pytest.mark.parametrize("K", [4, 8])
    def test_grid_pack_from_obs_equal(self, ba_case, K):
        prob = ba_case[0]
        oc, op, uvr, _ = sorted_obs(prob)
        octv = (np.arange(len(oc)) % 8).astype(np.int32)
        P = prob.pnt_pos.shape[0]
        got = tba.grid_pack_from_obs(oc, op, uvr, octv, P, K=K)
        want = jba.grid_pack_from_obs(oc, op, uvr, octv, P, K=K)
        for g, w in zip(got[:-1], want[:-1]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert got[-1] == want[-1]

    @pytest.mark.parametrize("what", ["camera id", "pixel coordinate"])
    def test_pack_raises_outside_int16(self, what):
        """The JAX packer wraps silently at 2048 px (1/16-px int16); the
        port's raises."""
        oc = np.array([0, 1], np.int32)
        op = np.array([0, 0], np.int32)
        uvr = np.array([[10.0, 20.0, 5.0], [30.0, 40.0, 25.0]], np.float32)
        if what == "camera id":
            oc[1] = 40000
        else:
            uvr[1, 0] = 2048.0
        with pytest.raises(ValueError, match=what):
            tba.grid_pack_from_obs(oc, op, uvr, np.zeros(2, np.int32), 4)
        uvr[1, 0] = 2047.9
        oc[1] = 1
        tba.grid_pack_from_obs(oc, op, uvr, np.zeros(2, np.int32), 4)


class TestBundleAdjust:
    def test_inv3x3(self):
        rng = np.random.default_rng(3)
        A = rng.normal(size=(64, 3, 3)).astype(np.float32)
        M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
        M[5] = 0.0                                 # singular: det clamp path
        got = N(tba._inv3x3(T(M)))
        want = np.asarray(jba._inv3x3(jnp.asarray(M)))
        # the same closed form in float32; products round alike, the
        # adjugate's differences may cancel differently by an ulp
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_flat_bundle_adjust(self, ba_case):
        prob, T_true, _ = ba_case
        want = jba.bundle_adjust(prob)
        got = tba.bundle_adjust(convert.ba_problem_from_numpy(prob, CPU))
        assert np.abs(N(got.cam_Tcw) - np.asarray(want.cam_Tcw)).max() < BA_POS_TOL
        assert np.abs(N(got.pnt_pos) - np.asarray(want.pnt_pos)).max() < BA_POS_TOL
        assert np.array_equal(N(got.obs_inlier), np.asarray(want.obs_inlier))
        assert np.array_equal(N(got.obs_depth_ok), np.asarray(want.obs_depth_ok))
        # and the port's own answer is right (tests/test_ba.py's bound)
        n = T_true.shape[0]
        err = np.linalg.norm(N(got.cam_Tcw)[:n, :3, 3] - T_true[:, :3, 3], axis=1)
        assert err.max() < 0.06

    def _grid_problem(self, prob, K=8):
        oc, op, uvr, isig = sorted_obs(prob)
        P = prob.pnt_pos.shape[0]
        g = jba.grid_from_obs(oc, op, uvr, isig, P, K=K)
        return jba.BAGridProblem(
            prob.cam_Tcw, prob.cam_fixed, prob.pnt_pos, prob.pnt_active,
            *[jnp.asarray(a) for a in g[:4]], prob.cam)

    def test_grid_bundle_adjust(self, ba_case):
        jp = self._grid_problem(ba_case[0])
        want = jba.bundle_adjust_grid(jp)
        got = tba.bundle_adjust_grid(convert.ba_problem_from_numpy(jp, CPU))
        assert np.abs(N(got.cam_Tcw) - np.asarray(want.cam_Tcw)).max() < BA_POS_TOL
        assert np.abs(N(got.pnt_pos) - np.asarray(want.pnt_pos)).max() < BA_POS_TOL
        assert np.array_equal(N(got.g_inlier), np.asarray(want.g_inlier))

    def test_grid_bundle_adjust_with_outliers(self):
        rng = np.random.default_rng(2)
        prob, _, _ = make_ba_problem(rng, noise_px=0.3, outlier_frac=0.15)
        jp = self._grid_problem(prob)
        want = jba.bundle_adjust_grid(jp)
        got = tba.bundle_adjust_grid(convert.ba_problem_from_numpy(jp, CPU))
        # a point whose every observation was gated out has a zero Hessian
        # block in phase 2 (only the 1e-8 damping holds it): where it
        # lands is rounding noise in both packages, so it is not compared
        held = np.asarray(want.g_inlier).any(axis=1)
        assert held.sum() >= 150
        diff = np.abs(N(got.pnt_pos) - np.asarray(want.pnt_pos))[held]
        assert diff.max() < BA_POS_TOL
        assert np.abs(N(got.cam_Tcw) - np.asarray(want.cam_Tcw)).max() < BA_POS_TOL
        # gating is a threshold on a float: allow 2 slots at the chi2 edge
        assert (N(got.g_inlier) != np.asarray(want.g_inlier)).sum() <= 2
        rate = N(got.g_inlier)[np.asarray(jp.g_act)].mean()
        assert 0.75 < rate < 0.92

    def test_packed_grid_bundle_adjust(self, ba_case):
        prob = ba_case[0]
        oc, op, uvr, _ = sorted_obs(prob)
        octv = (op % 3).astype(np.int32)
        P = prob.pnt_pos.shape[0]
        g_cam, g_uvrq, g_oct, g_act, _, _, _ = tba.grid_pack_from_obs(
            oc, op, uvr, octv, P, K=8)
        isig = (1.0 / 1.44 ** np.arange(8)).astype(np.float32)
        head = (prob.cam_Tcw, prob.cam_fixed, prob.pnt_pos, prob.pnt_active)
        want = jba.bundle_adjust_grid_packed(
            *head, jnp.asarray(g_cam), jnp.asarray(g_uvrq), jnp.asarray(g_oct),
            jnp.asarray(g_act), prob.cam, jnp.asarray(isig))
        got = tba.bundle_adjust_grid_packed(
            *[T(a) for a in head], T(g_cam), T(g_uvrq), T(g_oct), T(g_act),
            T(prob.cam), T(isig))
        assert np.abs(N(got.cam_Tcw) - np.asarray(want.cam_Tcw)).max() < BA_POS_TOL
        assert np.abs(N(got.pnt_pos) - np.asarray(want.pnt_pos)).max() < BA_POS_TOL
        assert np.array_equal(N(got.g_inlier), np.asarray(want.g_inlier))


# ------------------------------------------------- native map core


class TestPortNativeMapCore(jnative.TestNativeMapCore):
    """The cases of tests/test_native_mapcore.py against the port's own
    wrapper and its own build of the map core."""

    @pytest.fixture(autouse=True)
    def _port_ffi(self, monkeypatch):
        monkeypatch.setattr(jnative, "mapcore_ffi", tffi)


def test_mapcore_builds_only_into_the_port():
    """The library lives under pyorbslam_tpu_torch/_build/, its name
    carries the source hash, and building it touches nothing under
    pyorbslam_tpu/native/."""
    jdir = os.path.join(REPO, "pyorbslam_tpu", "native")
    before = {f: os.stat(os.path.join(jdir, f)).st_mtime_ns
              for f in sorted(os.listdir(jdir))}
    lib = tffi.build()
    tffi._load()
    assert os.path.dirname(lib) == os.path.join(REPO, "pyorbslam_tpu_torch", "_build")
    assert os.path.basename(lib).startswith("libmapcore_") and os.path.exists(lib)
    after = {f: os.stat(os.path.join(jdir, f)).st_mtime_ns
             for f in sorted(os.listdir(jdir))}
    assert before == after


def test_mapcore_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "mapcore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tffi, "SOURCE", str(bad))
    monkeypatch.setattr(tffi, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tffi.build()


def test_mapcore_available(monkeypatch, tmp_path):
    """``available()`` as the JAX package's: True where the core builds
    and loads (both packages here), False where its build fails."""
    assert tffi.available() is True
    assert tffi.available() == jnative.mapcore_ffi.available()
    bad = tmp_path / "mapcore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tffi, "_lib", None)
    monkeypatch.setattr(tffi, "SOURCE", str(bad))
    monkeypatch.setattr(tffi, "BUILD_DIR", str(tmp_path / "build"))
    assert tffi.available() is False


# ------------------------------------------- keyframe policy and culling


def _port_policy(monkeypatch):
    monkeypatch.setattr(jpolicy, "SlamMap",
                        lambda cfg, **kw: SlamMap(
                            convert.config_from_dict(convert.config_to_dict(cfg)),
                            CPU, **kw))
    monkeypatch.setattr(jpolicy, "LocalMapper", tlm.LocalMapper)
    monkeypatch.setattr(jpolicy, "need_new_keyframe", tsystem.need_new_keyframe)


class TestPortNeedNewKeyframe(jpolicy.TestNeedNewKeyframe):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        _port_policy(monkeypatch)


class TestPortCulledKeyframeExport(jpolicy.TestCulledKeyframeExport):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        _port_policy(monkeypatch)


class TestPortCovisibilityReparenting(jpolicy.TestCovisibilityReparenting):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        _port_policy(monkeypatch)


# ------------------------------------------------------ stores and ring


class TestStores:
    def test_keyframe_store_add_and_capacity(self):
        ks = KeyFrameStore(capacity=2, n_features=4)
        assert ks.kp_desc.dtype == np.int32
        row = dict(
            Tcw=np.eye(4, dtype=np.float32), frame_id=7, timestamp=0.5,
            kp_xy=np.ones((4, 2), np.float32), kp_octave=np.arange(4),
            kp_angle=np.zeros(4, np.float32),
            kp_desc=np.full((4, 8), -1, np.int32), kp_valid=np.ones(4, bool),
            u_right=np.zeros(4, np.float32), depth=np.ones(4, np.float32),
            obs_lm=np.array([3, -1, 2, -1], np.int32))
        assert ks.add(**row) == 0 and ks.add(**row, kp_node=np.arange(4)) == 1
        assert ks.n == 2 and ks.alive[:2].all() and ks.frame_id[1] == 7
        assert ks.kp_node[0].tolist() == [-1] * 4
        assert ks.kp_node[1].tolist() == [0, 1, 2, 3]
        with pytest.raises(RuntimeError, match="capacity 2 exceeded"):
            ks.add(**row)

    def test_ring_rotation(self):
        from pyorbslam_tpu_torch.slam.frame import StereoFrame

        def frame(v):
            n = 8
            return StereoFrame(
                xy=torch.full((n, 2), float(v)), response=torch.zeros(n),
                angle=torch.zeros(n), octave=torch.full((n,), v, dtype=torch.int32),
                desc=torch.full((n, 8), -v, dtype=torch.int32),
                desc_bits=torch.zeros((n, 256), dtype=torch.int8),
                valid=torch.ones(n, dtype=torch.bool),
                u_right=torch.full((n,), float(v)), depth=torch.full((n,), float(v)))

        ring = DeviceKFRing(capacity=4)
        for kf in range(6):
            ring.insert(kf, frame(kf + 1))
        # keyframes 0 and 1 rotated out; 4 and 5 took their slots
        assert ring.slots_for([0]) is None and ring.slots_for([2, 1]) is None
        assert ring.slots_for([4, 5, 2, 3]).tolist() == [0, 1, 2, 3]
        xy, octave, desc, ur, depth, valid = ring.arrays
        for kf, slot in ring.slot_of.items():
            assert float(xy[slot, 0, 0]) == kf + 1
            assert int(octave[slot, 0]) == kf + 1 and int(desc[slot, 0, 0]) == -(kf + 1)
            assert float(ur[slot, 0]) == kf + 1 and bool(valid[slot].all())
        assert desc.dtype == torch.int32 and xy.shape == (4, 8, 2)
        ring.reset()
        assert ring.arrays is None and not ring.slot_of


# ------------------- a short JAX System run: triangulation, maintenance,
# ------------------- SlamMap on the same map state


def make_cfgs(seq, n_features=1000):
    jc = jcfg_mod.SlamConfig(
        camera=jcfg_mod.CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=seq.left.shape[2], height=seq.left.shape[1],
            bf=seq.bf, th_depth=40.0),
        orb=jcfg_mod.OrbConfig(n_features=n_features))
    return jc, convert.config_from_dict(convert.config_to_dict(jc))


@pytest.fixture(scope="module")
def jax_run(synth_seq):
    """The JAX System over the first frames of the cached sequence until
    it holds 4 keyframes, with the arguments and result of its last
    ``maintenance_ring_step`` call recorded."""
    jc, tc = make_cfgs(synth_seq)
    calls = []
    real = jlm.maintenance_ring_step

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, np.asarray(out)))
        return out

    jlm.maintenance_ring_step = recording
    try:
        sysm = jsystem.System(jc, landmark_capacity=1 << 15,
                              keyframe_capacity=64, enable_loop_closing=False)
        i = 0
        while sysm.map.keyframes.n < 4 and i < 20:
            sysm.track_stereo(synth_seq.left[i], synth_seq.right[i],
                              synth_seq.timestamps[i])
            i += 1
    finally:
        jlm.maintenance_ring_step = real
    assert sysm.map.keyframes.n == 4 and calls
    return sysm, calls, jc, tc


def jax_map_copy(sysm):
    """A private, rebuilt copy of the JAX run's map: the shared fixture
    stays as it was, and both packages start from a recounted core."""
    import copy
    jm = copy.copy(sysm.map)
    jm.landmarks = copy.deepcopy(sysm.map.landmarks)
    jm.keyframes = copy.deepcopy(sysm.map.keyframes)
    jm.counters = type(sysm.map.counters)(int)
    jm.times = type(sysm.map.times)(float)
    jm.rebuild_core()
    return jm


def port_map_copy(sysm, tc):
    m = SlamMap(tc, CPU, landmark_capacity=1 << 15, keyframe_capacity=64)
    m.landmarks = convert.landmarks_from_numpy(sysm.map.landmarks)
    m.keyframes = convert.keyframes_from_numpy(sysm.map.keyframes)
    m.rebuild_core()
    return m


class TestTriangulation:
    def _pair_inputs(self, sysm, jc, k1, k2):
        ks = sysm.map.keyframes
        c = jc.camera
        f = lambda a: jnp.asarray(a)  # noqa: E731
        # every valid feature counts as free here (the run has bound most
        # of them already), so the matcher sees a few hundred candidates
        free1, free2 = ks.kp_valid[k1], ks.kp_valid[k2]
        return [
            f(ks.kp_xy[k1]), f(ks.kp_octave[k1]), f(ks.kp_desc[k1]),
            f(ks.u_right[k1]), f(ks.depth[k1]), f(free1),
            f(ks.kp_xy[k2]), f(ks.kp_octave[k2]), f(ks.kp_desc[k2]),
            f(ks.u_right[k2]), f(ks.depth[k2]), f(free2),
            f(ks.Tcw[k1]), f(ks.Tcw[k2]),
            jnp.asarray([c.fx, c.fy, c.cx, c.cy, c.bf], jnp.float32),
            jnp.float32(c.baseline),
            jnp.asarray(jc.orb.scale_factors, jnp.float32),
            jnp.asarray(jc.orb.level_sigma2, jnp.float32)]

    def test_fundamental_from_poses(self, jax_run):
        sysm, _, jc, _ = jax_run
        ks = sysm.map.keyframes
        K = jc.camera.K
        want = np.asarray(jtri.fundamental_from_poses(
            jnp.asarray(ks.Tcw[3]), jnp.asarray(ks.Tcw[1]), jnp.asarray(K)))
        got = N(ttri.fundamental_from_poses(T(ks.Tcw[3]), T(ks.Tcw[1]), T(K)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)

    def test_triangulate_pair(self, jax_run):
        sysm, _, jc, _ = jax_run
        args = self._pair_inputs(sysm, jc, 3, 1)
        want = jtri.triangulate_pair(*args, scale_factor=jc.orb.scale_factor)
        targs = [T(a) for a in args]
        targs[15] = float(args[15])
        got = ttri.triangulate_pair(*targs, scale_factor=jc.orb.scale_factor)
        valid = np.asarray(want.valid)
        assert valid.sum() > 20
        assert np.array_equal(N(got.valid), valid)
        assert np.array_equal(N(got.idx1), np.asarray(want.idx1))
        assert np.array_equal(N(got.idx2), np.asarray(want.idx2))
        # float32 DLT / unprojection of points 5-60 m away: 1 cm
        assert np.abs(N(got.pos_w)[valid] - np.asarray(want.pos_w)[valid]).max() < 1e-2

    def test_triangulate_batch_packed(self, jax_run):
        sysm, _, jc, _ = jax_run
        a1 = self._pair_inputs(sysm, jc, 3, 1)
        a2 = self._pair_inputs(sysm, jc, 3, 2)
        nb = [jnp.stack([x, y]) for x, y in zip(a1[6:12], a2[6:12])]
        nb_T = jnp.stack([a1[13], a2[13]])
        jargs = a1[:6] + nb + [nb_T, a1[12]] + a1[14:]
        want = np.asarray(jtri.triangulate_batch_packed(
            *jargs, scale_factor=jc.orb.scale_factor))
        targs = [T(a) for a in jargs]
        targs[15] = float(jargs[15])
        got = N(ttri.triangulate_batch_packed(
            *targs, scale_factor=jc.orb.scale_factor))
        assert got.shape == want.shape and got.dtype == np.int32
        i1, i2, va, pos = ttri.unpack_tri_batch_np(got)
        j1, j2, jva, jpos = jtri.unpack_tri_batch_np(want)
        assert np.array_equal(va, jva) and va.sum() > 40
        assert np.array_equal(i1, j1) and np.array_equal(i2, j2)
        assert np.abs(pos[va] - jpos[jva]).max() < 1e-2


class TestMaintenanceRingStep:
    def test_packed_row_matches(self, jax_run):
        """The whole per-keyframe program on the JAX run's own ring,
        mirror and dispatch arguments: the integer fields of the packed
        row (triangulation indices and validity, both fuse directions)
        are equal, the triangulated positions agree to 1 cm."""
        sysm, calls, jc, tc = jax_run
        args, kwargs, want = calls[-1]
        mirror = [T(a) for a in args[:6]]
        ring = convert.ring_from_numpy(args[6], CPU)
        (slot1, nb_slots, free1, nb_free, T1, nb_T, fuse_ids, tgt_slots,
         tgt_T, rev_ids, cam5, baseline, sf, s2) = args[7:21]
        slots = np.concatenate([[int(slot1)], np.asarray(nb_slots),
                                np.asarray(tgt_slots)]).astype(np.int64)
        got, replayed = tlm.maintenance_ring_step(
            *mirror, ring, T(slots), T(free1), T(nb_free), T(T1), T(nb_T),
            T(fuse_ids), T(tgt_T), T(rev_ids), T(cam5), float(baseline),
            T(sf), T(s2), tc, scale_factor=kwargs["scale_factor"])
        got = N(got)
        assert not replayed
        assert got.shape == want.shape
        B, cap_t = 4, min(tlm.TRI_CAP, free1.shape[0])
        nt = 6 * cap_t
        gi1, gi2, gva, gpos = ttri.unpack_tri_batch_np(got[: B * nt].reshape(B, nt))
        wi1, wi2, wva, wpos = jtri.unpack_tri_batch_np(want[: B * nt].reshape(B, nt))
        assert wva.sum() > 20
        assert np.array_equal(gva, wva)
        assert np.array_equal(gi1[wva], wi1[wva]) and np.array_equal(gi2[wva], wi2[wva])
        assert np.abs(gpos[wva] - wpos[wva]).max() < 1e-2
        # fuse targets and the reverse fuse: integer matches, equal
        assert (want[B * nt:] >= 0).sum() > 50
        assert np.array_equal(got[B * nt:], want[B * nt:])


class TestSlamMap:
    @pytest.fixture()
    def port_map(self, jax_run):
        return port_map_copy(jax_run[0], jax_run[3])

    def test_rebuilt_core_matches(self, jax_run, port_map):
        jm = jax_map_copy(jax_run[0])
        n = jm.landmarks.n
        assert np.array_equal(port_map.landmarks.n_obs[:n], jm.landmarks.n_obs[:n])
        for kf in range(jm.keyframes.n):
            assert port_map.covisible_neighbors(kf) == jm.covisible_neighbors(kf)
        assert port_map.reprojection_chi2() == pytest.approx(
            jm.reprojection_chi2(), rel=1e-6)

    def test_local_ba_matches(self, jax_run, port_map):
        jm = jax_map_copy(jax_run[0])
        before = jm.landmarks.pos.copy()
        kf = jm.keyframes.n - 1
        want = jm.local_ba(kf)
        got = port_map.local_ba(kf)
        assert want["ran"] and got["ran"]
        for key in ("n_cams", "n_free", "n_points", "n_obs"):
            assert got[key] == want[key]
        assert abs(got["n_erased"] - want["n_erased"]) <= 2
        n = jm.keyframes.n
        assert np.abs(port_map.keyframes.Tcw[:n] - jm.keyframes.Tcw[:n]).max() < BA_POS_TOL
        # Points: the solve's long float32 sums (6144 terms per row of the
        # reduced system) are taken in another order by the two packages,
        # and by torch itself at another thread count; 15 LM iterations
        # carry that into the weakly constrained depth of far points
        # (dz ~ z^2 / bf per pixel of disparity).  So positions are
        # compared relative to their distance from the origin camera:
        # median 1e-4, 99th percentile 5e-3 (measured 1.4e-5 and 4e-4 at
        # two threads), and the maps' own quality metric must agree to 1%.
        # The few points whose observations were all gated out in phase 2
        # are held only by the 1e-8 damping and land on rounding noise.
        m = jm.landmarks.n
        moved = (np.abs(jm.landmarks.pos[:m] - before[:m]).max(axis=1) > 0) \
            & jm.landmarks.alive[:m] & port_map.landmarks.alive[:m]
        assert moved.sum() > 500
        d = np.abs(port_map.landmarks.pos[:m] - jm.landmarks.pos[:m]).max(axis=1)
        rel = (d / np.linalg.norm(jm.landmarks.pos[:m], axis=1).clip(1.0))[moved]
        assert np.median(rel) < 1e-4 and np.percentile(rel, 99) < 5e-3
        assert port_map.reprojection_chi2() == pytest.approx(
            jm.reprojection_chi2(), rel=1e-2)
        assert dict(port_map.counters) == dict(jm.counters)

    def test_split_local_ba(self, port_map):
        kf = port_map.keyframes.n - 1
        r = port_map.local_ba(kf, split=True)
        # the result is on its way to the host from the dispatch on; on the
        # CPU it is there at once
        assert r["ran"] and not r["pending"]["handle"].pending()
        assert r["pending"]["handle"].numpy().dtype == np.int32
        done = port_map.local_ba_apply(r["pending"])
        assert done["ran"] and done["n_obs"] == r["n_obs"]

    @pytest.mark.parametrize("call", ["global_ba", "cg", "dist"])
    def test_other_engines_raise(self, jax_run, port_map, call):
        """The engines beside local BA: ``global_ba`` (its dense rung at
        this map size), ``_run_ba(engine="cg")`` and the multi-device
        ``_run_ba(engine="dist")`` (the JAX package's 8-device CPU mesh,
        the port's 8 CPU shards) against the JAX package on the same map,
        keyframe poses within ``BA_POS_TOL``, erased observations within 2
        (the dist rung erases none in either package).  None of them
        raises any more; the name is the one the test has carried since
        the dist engine was a stub."""
        jm = jax_map_copy(jax_run[0])
        if call == "global_ba":
            want, got = jm.global_ba(), port_map.global_ba()
        else:
            cams = list(range(jm.keyframes.n))
            pnt = jm.core.observed_landmarks(jm.landmarks.n)
            mesh = dist_ba.device_mesh(CPU, 8) if call == "dist" else None
            want = jm._run_ba(cams, len(cams), pnt, 3, 3, True, engine=call)
            got = port_map._run_ba(cams, len(cams), pnt, 3, 3, True,
                                   engine=call, mesh=mesh)
        assert want["ran"] and got["ran"]
        for key in ("n_cams", "n_free", "n_points", "n_obs"):
            assert got[key] == want[key]
        assert abs(got["n_erased"] - want["n_erased"]) <= 2
        n = jm.keyframes.n
        assert np.abs(port_map.keyframes.Tcw[:n] - jm.keyframes.Tcw[:n]).max() < BA_POS_TOL
        assert port_map.reprojection_chi2() == pytest.approx(
            jm.reprojection_chi2(), rel=1e-2)


class TestLocalMapper:
    def test_separate_steps_match_jax(self, jax_run):
        """create_new_points and fuse_neighbors (the path taken when the
        ring has rotated a participant out) on the same map state, host
        upload path: same counts as the JAX LocalMapper."""
        sysm, _, jc, tc = jax_run
        jm, tm = jax_map_copy(sysm), port_map_copy(sysm, tc)
        kf = jm.keyframes.n - 1
        jmap, tmap = jlm.LocalMapper(jc, jm), tlm.LocalMapper(tc, tm)
        assert tmap.create_new_points(kf) == jmap.create_new_points(kf)
        assert tmap.fuse_neighbors(kf) == jmap.fuse_neighbors(kf)
        assert tm.landmarks.n == jm.landmarks.n
        n = jm.landmarks.n
        assert np.array_equal(tm.landmarks.alive[:n], jm.landmarks.alive[:n])
        assert np.array_equal(tm.keyframes.obs_lm[: kf + 1], jm.keyframes.obs_lm[: kf + 1])
        assert tmap.cull_keyframes(kf) == jmap.cull_keyframes(kf)

    def test_ring_paths_equal_host_upload_paths(self, jax_run):
        """With every participant in the device ring, create_new_points
        and fuse_neighbors gather from the ring and the landmark mirror
        (triangulate_ring_packed, fuse_ring_batch); the outcome equals
        the host-upload path's on the same map."""
        from pyorbslam_tpu_torch.ops.hamming import unpack_bits
        from pyorbslam_tpu_torch.slam.frame import StereoFrame

        sysm, _, _, tc = jax_run
        ringed, hosted = port_map_copy(sysm, tc), port_map_copy(sysm, tc)
        ks = ringed.keyframes
        ring = DeviceKFRing()
        for k in range(ks.n):
            desc = T(ks.kp_desc[k])
            ring.insert(k, StereoFrame(
                xy=T(ks.kp_xy[k]), response=torch.zeros(ks.n_features),
                angle=T(ks.kp_angle[k]), octave=T(ks.kp_octave[k]), desc=desc,
                desc_bits=unpack_bits(desc), valid=T(ks.kp_valid[k]),
                u_right=T(ks.u_right[k]), depth=T(ks.depth[k])))

        def mirror(force=False):
            lm = ringed.landmarks
            return tuple(T(getattr(lm, f)[:8192]) for f in convert.MIRROR_FIELDS)

        with_ring = tlm.LocalMapper(tc, ringed, ring=ring, mirror_fn=mirror)
        on_host = tlm.LocalMapper(tc, hosted)
        kf = ks.n - 1
        n_new = with_ring.create_new_points(kf)
        assert n_new == on_host.create_new_points(kf) and n_new > 0
        n_fused = with_ring.fuse_neighbors(kf)
        assert n_fused == on_host.fuse_neighbors(kf) and n_fused > 0
        assert np.array_equal(ringed.keyframes.obs_lm[: ks.n],
                              hosted.keyframes.obs_lm[: ks.n])
        n = ringed.landmarks.n
        assert n == hosted.landmarks.n
        assert np.array_equal(ringed.landmarks.alive[:n], hosted.landmarks.alive[:n])
        np.testing.assert_array_equal(ringed.landmarks.pos[:n], hosted.landmarks.pos[:n])
