"""Parity of the PyTorch port's loop closing with the JAX package: Sim3
algebra, Horn alignment and RANSAC, the relative Sim3 refinement, the
mutual Sim3 matcher, the essential-graph solvers, the CG bundle
adjustment, the Sim3 failure cooldown, and the whole ``LoopCloser`` at
the keyframe where the JAX package closes the loop of the cached
92-frame loop sequence.

Inputs are made from numpy seeds, or taken from a JAX ``System`` run, and
go through both packages on the CPU.  The JAX package's RANSAC draws
come from ``jax.random``; where a RANSAC is compared, the test draws the
JAX package's own index sets with ``jax`` and hands them to the port's
``sim3_ransac_sets``.  Tolerances are stated where they are used.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import make_ba_problem
from test_loop_negative import TestSim3FailCooldown as JaxCooldown

from pyorbslam_tpu.geometry import se3 as jse3
from pyorbslam_tpu.geometry import sim3 as jsim3
from pyorbslam_tpu.ops import hamming as jham
from pyorbslam_tpu.ops import matching as jmatch
from pyorbslam_tpu.optim import ba_cg as jba_cg
from pyorbslam_tpu.optim import horn as jhorn
from pyorbslam_tpu.optim import pose_graph as jpg
from pyorbslam_tpu.optim import sim3_opt as jsim3_opt

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.geometry import sim3 as tsim3
from pyorbslam_tpu_torch.ops import hamming as tham
from pyorbslam_tpu_torch.ops import matching as tmatch
from pyorbslam_tpu_torch.optim import ba_cg as tba_cg
from pyorbslam_tpu_torch.optim import horn as thorn
from pyorbslam_tpu_torch.optim import pose_graph as tpg
from pyorbslam_tpu_torch.optim import sim3_opt as tsim3_opt
from pyorbslam_tpu_torch.parallel import dist_ba as tdist
from pyorbslam_tpu_torch.optim import ba as tba
from pyorbslam_tpu_torch.slam import loop_closing as tloop
from pyorbslam_tpu_torch.slam import slam_map as tslam_map
from pyorbslam_tpu_torch.tools.gba_tiling import centres as centers
from pyorbslam_tpu_torch.tools.multihost_dryrun import drift_graph

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
FX, FY, CX, CY = 400.0, 400.0, 320.0, 120.0


def T(a):
    return convert.tensor_from_numpy(a, CPU)


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rand_rot(rng, scale=1.0):
    return np.asarray(jse3.exp_so3(jnp.asarray(rng.normal(0, scale, 3).astype(np.float32))))


def project(P):
    return np.stack([FX * P[:, 0] / P[:, 2] + CX,
                     FY * P[:, 1] / P[:, 2] + CY], 1).astype(np.float32)


def cam_points(rng, n):
    return np.stack([rng.uniform(-5, 5, n), rng.uniform(-2, 2, n),
                     rng.uniform(4, 25, n)], 1).astype(np.float32)


# ------------------------------------------------------------- Sim3 group


class TestSim3Group:
    """exp / log / compose / act / inverse against the JAX package, rtol
    1e-5, atol 1e-6, over tangents with and without rotation and scale
    (every Taylor branch of the W coefficients)."""

    @pytest.fixture(scope="class")
    def xis(self):
        rng = np.random.default_rng(0)
        xi = rng.normal(0, 0.5, (64, 7)).astype(np.float32)
        xi[:8, :3] = 0.0            # theta ~ 0
        xi[8:16, 6] = 0.0           # sigma ~ 0
        xi[16:20, :3] = 1e-6        # both small
        xi[16:20, 6] = 1e-7
        return xi

    def test_exp_log(self, xis):
        want = jsim3.exp(jnp.asarray(xis))
        got = tsim3.exp(T(xis))
        for w, g in zip(want, got):
            np.testing.assert_allclose(N(g), np.asarray(w), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(N(tsim3.log(got)), np.asarray(jsim3.log(want)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(N(tsim3.to_matrix(got)),
                                   np.asarray(jsim3.to_matrix(want)),
                                   rtol=1e-5, atol=1e-6)

    def test_compose_inverse_act(self, xis):
        ja, jb = jsim3.exp(jnp.asarray(xis)), jsim3.exp(jnp.asarray(xis[::-1].copy()))
        ta, tb = tsim3.exp(T(xis)), tsim3.exp(T(xis[::-1].copy()))
        for w, g in zip(jsim3.compose(ja, jb), tsim3.compose(ta, tb)):
            np.testing.assert_allclose(N(g), np.asarray(w), rtol=1e-5, atol=1e-6)
        for w, g in zip(jsim3.inverse(ja), tsim3.inverse(ta)):
            np.testing.assert_allclose(N(g), np.asarray(w), rtol=1e-5, atol=1e-6)
        pts = np.random.default_rng(1).normal(0, 3, (64, 5, 3)).astype(np.float32)
        np.testing.assert_allclose(N(tsim3.act(ta, T(pts))),
                                   np.asarray(jsim3.act(ja, jnp.asarray(pts))),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(N(tsim3.act(ta, T(pts[:, 0]))),
                                   np.asarray(jsim3.act(ja, jnp.asarray(pts[:, 0]))),
                                   rtol=1e-5, atol=1e-5)

    def test_identity_and_from_se3(self, xis):
        """``Sim3.identity`` and ``Sim3.from_se3`` equal the JAX package's
        (``tests/test_geometry.py`` lifts SE3 poses with ``from_se3``)."""
        for batch in ((), (4,), (2, 3)):
            for w, g in zip(jsim3.Sim3.identity(batch), tsim3.Sim3.identity(batch)):
                assert tuple(g.shape) == w.shape
                np.testing.assert_array_equal(N(g), np.asarray(w))
        xi = xis[20:30].copy()
        xi[:, 6] = 0.0                  # unit scale: SE3 poses
        Tm = N(tsim3.to_matrix(tsim3.exp(T(xi))))
        want = jsim3.Sim3.from_se3(jnp.asarray(Tm))
        got = tsim3.Sim3.from_se3(T(Tm))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(N(g), np.asarray(w))

    def test_jacobian_matches_jacfwd(self, xis):
        """The forward-mode Jacobian of the retraction's log against
        ``jax.jacfwd`` of the same function (a check of ``sim3.jacobian``;
        the solvers below are compared on residual and pose)."""
        g = xis[30]
        jg, tg = jsim3.exp(jnp.asarray(g)), tsim3.exp(T(g))
        want = jax.jacfwd(lambda x: jsim3.log(jsim3.retract(jg, x)))(jnp.zeros(7))
        got = tsim3.jacobian(lambda x: tsim3.log(tsim3.retract(tg, x)),
                             torch.zeros(1, 7))[0]
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------- Horn


class TestHorn:
    @pytest.mark.parametrize("with_scale", [False, True])
    def test_exact_alignment(self, with_scale):
        """R, t and s within 1e-5 of the truth and of the JAX package."""
        rng = np.random.default_rng(0)
        P = rng.normal(0, 3, (20, 3)).astype(np.float32)
        R_true = rand_rot(rng)
        t_true = rng.normal(0, 2, 3).astype(np.float32)
        s_true = 1.7 if with_scale else 1.0
        Q = s_true * (P @ R_true.T) + t_true
        R, t, s = thorn.horn_align(T(P), T(Q), with_scale=with_scale)
        jR, jt, js = jhorn.horn_align(jnp.asarray(P), jnp.asarray(Q), with_scale)
        for got, want in ((R, R_true), (t, t_true), (s, s_true)):
            np.testing.assert_allclose(N(got), want, atol=1e-5)
        for got, want in ((R, jR), (t, jt), (s, js)):
            np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5)


def jax_draws(key, active, n_hyp=256):
    """The JAX package's minimal sets (``horn.py:83``) and, as a function
    of the best hypothesis' inlier mask, its refinement set
    (``:114-118``)."""
    w = jnp.asarray(np.asarray(active, np.float32))
    idx = jax.random.categorical(
        key, jnp.log(w + 1e-9)[None, :].repeat(n_hyp * 3, 0)).reshape(n_hyp, 3)

    def refine(best_inl):
        b = jnp.asarray(N(best_inl).astype(np.float32))
        return T(np.asarray(jax.random.categorical(
            jax.random.fold_in(key, 7), jnp.log(b + 1e-9)[None, :].repeat(32, 0))))

    return T(np.asarray(idx)), refine


class TestSim3Ransac:
    def test_sets_match_jax(self):
        """On the JAX package's own index sets: equal inlier masks, R and
        t within 1e-4 (the same best hypothesis and the same refinement)."""
        rng = np.random.default_rng(2)
        n, B = 80, 128
        X2 = cam_points(rng, n)
        R_true = rand_rot(rng, 0.3)
        t_true = rng.normal(0, 1.0, 3).astype(np.float32)
        X1 = X2 @ R_true.T + t_true
        X2n = X2.copy()
        bad = rng.choice(n, int(0.3 * n), replace=False)
        X2n[bad] += rng.normal(0, 3.0, (len(bad), 3))
        uv1, uv2 = project(X1), project(X2n)

        def pad(a, fill=0.0):
            return np.concatenate([a, np.full((B - n,) + a.shape[1:], fill, a.dtype)])

        args = [pad(X1), pad(X2n), pad(uv1), pad(uv2),
                np.ones(B, np.float32), np.ones(B, np.float32), np.arange(B) < n]
        cam4 = np.array([FX, FY, CX, CY], np.float32)
        key = jax.random.PRNGKey(36)
        want = jhorn.sim3_ransac(*(jnp.asarray(a) for a in args),
                                 jnp.asarray(cam4), key)
        idx, refine = jax_draws(key, args[-1])
        got = thorn.sim3_ransac_sets(*(T(a) for a in args), T(cam4), idx, refine)
        assert bool(want.ok) and bool(got.ok)
        assert np.array_equal(N(got.inliers), np.asarray(want.inliers))
        assert int(got.n_inliers) == int(want.n_inliers) >= 0.6 * n
        np.testing.assert_allclose(N(got.R), np.asarray(want.R), atol=1e-4)
        np.testing.assert_allclose(N(got.t), np.asarray(want.t), atol=1e-4)
        np.testing.assert_allclose(N(got.R), R_true, atol=5e-3)

    def test_generator_draws(self):
        """The port's own draws (a ``torch.Generator``) find the same
        inlier set on clean data with 30% gross outliers."""
        rng = np.random.default_rng(3)
        n = 100
        X2 = cam_points(rng, n)
        R_true = rand_rot(rng, 0.3)
        t_true = rng.normal(0, 1.0, 3).astype(np.float32)
        X1 = X2 @ R_true.T + t_true
        X2n = X2.copy()
        bad = rng.choice(n, 30, replace=False)
        X2n[bad] += rng.normal(0, 3.0, (30, 3))
        g = torch.Generator().manual_seed(5)
        res = thorn.sim3_ransac(
            T(X1), T(X2n), T(project(X1)), T(project(X2n)),
            torch.ones(n), torch.ones(n), torch.ones(n, dtype=torch.bool),
            T(np.array([FX, FY, CX, CY], np.float32)), g)
        truth = np.ones(n, bool)
        truth[bad] = False
        assert bool(res.ok) and np.array_equal(N(res.inliers), truth)
        np.testing.assert_allclose(N(res.R), R_true, atol=1e-4)
        np.testing.assert_allclose(N(res.t), t_true, atol=1e-3)


class TestOptimizeSim3:
    def test_matches_jax(self):
        """Pose within 1e-4 of the JAX package's, inlier count within 1
        (a pair at the chi2 edge may fall either way)."""
        rng = np.random.default_rng(3)
        n = 60
        X2 = cam_points(rng, n)
        R_true = rand_rot(rng, 0.2)
        t_true = rng.normal(0, 0.5, 3).astype(np.float32)
        X1 = X2 @ R_true.T + t_true
        obs1 = project(X1) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
        obs2 = project(X2) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
        obs1[:5] += 20.0            # gross outliers for the chi2 gate
        R0 = np.asarray(jse3.exp_so3(jnp.asarray(
            np.asarray(jse3.log_so3(jnp.asarray(R_true)))
            + rng.normal(0, 0.02, 3).astype(np.float32))))
        t0 = t_true + rng.normal(0, 0.1, 3).astype(np.float32)
        args = [R0, t0, np.ones((), np.float32), X1, X2, obs1, obs2,
                np.ones(n, np.float32), np.ones(n, np.float32), np.ones(n, bool),
                np.array([FX, FY, CX, CY], np.float32)]
        want = jsim3_opt.optimize_sim3(*(jnp.asarray(a) for a in args))
        got = tsim3_opt.optimize_sim3(*(T(a) for a in args))
        np.testing.assert_allclose(N(got.R), np.asarray(want.R), atol=1e-4)
        np.testing.assert_allclose(N(got.t), np.asarray(want.t), atol=1e-4)
        assert float(got.s) == 1.0
        assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 1
        assert 50 <= int(got.n_inliers) <= 55


# ----------------------------------------------------- mutual Sim3 matcher


def mutual_match_inputs(seed=6, n=300):
    """Two keyframes seeing one landmark cloud: features at the noisy
    projections with descriptors a few bits from their landmark's, some
    features and landmarks missing, a Sim3 a little off the truth."""
    rng = np.random.default_rng(seed)
    W, H = 640, 240
    pts = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n),
                    rng.uniform(6, 30, n)], 1).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, :3] = rand_rot(rng, 0.05)
    T2[:3, 3] = [0.6, 0.05, -0.4]
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)

    def flip(d, k):
        d = d.copy()
        for i in range(len(d)):
            for b in rng.choice(256, k, replace=False):
                d[i, b // 32] ^= np.uint32(1 << (b % 32))
        return d

    sides = []
    for Tk in (T1, T2):
        Pc = pts @ Tk[:3, :3].T + Tk[:3, 3]
        xy = project(Pc) + rng.normal(0, 0.7, (n, 2)).astype(np.float32)
        perm = rng.permutation(n)           # feature slot -> landmark
        has = rng.random(n) > 0.15
        dist = np.linalg.norm(Pc, axis=1)
        sides.append(dict(
            p_pos=pts[perm], p_desc=desc[perm], p_has=has,
            p_dmin=(0.5 * dist[perm]).astype(np.float32),
            p_dmax=(1.25 * dist[perm]).astype(np.float32),
            already=rng.random(n) > 0.9, f_xy=xy[perm],
            f_oct=rng.integers(0, 2, n).astype(np.int32),
            f_desc=flip(desc[perm], 6), f_valid=rng.random(n) > 0.05))
    S12 = T1 @ np.linalg.inv(T2)
    R12 = (S12[:3, :3] @ rand_rot(rng, 0.002)).astype(np.float32)
    t12 = (S12[:3, 3] + 0.01).astype(np.float32)
    geo = dict(T1w=T1, T2w=T2, R12=R12, t12=t12, s12=np.float32(1.0),
               cam4=np.array([FX, FY, CX, CY], np.float32),
               bounds=np.array([0, W - 1, 0, H - 1], np.float32),
               scale_factors=(1.2 ** np.arange(8)).astype(np.float32))
    return sides, geo


def run_mutual(pkg, sides, geo):
    to, ham = (jnp.asarray, jham) if pkg == "jax" else (T, tham)
    args = []
    for s in sides:
        pd, fd = to(s["p_desc"]), to(s["f_desc"])
        args += [to(s["p_pos"]), ham.unpack_bits(pd), ham.popcount(pd),
                 to(s["p_has"]), to(s["p_dmin"]), to(s["p_dmax"]),
                 to(s["already"]), to(s["f_xy"]), to(s["f_oct"]),
                 ham.unpack_bits(fd), ham.popcount(fd), to(s["f_valid"])]
    args += [to(geo[k]) for k in ("T1w", "T2w", "R12", "t12", "s12", "cam4",
                                  "bounds", "scale_factors")]
    fn = jmatch.sim3_mutual_match if pkg == "jax" else tmatch.sim3_mutual_match
    return N(fn(*args, log_scale_factor=float(np.log(1.2)), n_levels=8))


class TestSim3MutualMatch:
    @pytest.mark.parametrize("seed", [6, 7])
    def test_integers_equal(self, seed):
        sides, geo = mutual_match_inputs(seed)
        want = run_mutual("jax", sides, geo)
        got = run_mutual("port", sides, geo)
        assert (want >= 0).sum() > 100
        assert np.array_equal(got, want)


# ------------------------------------------------------------- pose graph


class TestPoseGraph:
    def test_dense_matches_jax(self):
        """Poses within 1e-4 of the JAX package's dense solver, and the
        loop gap closed as ``tests/test_sim3.py`` requires."""
        gt, est, args = drift_graph(4, 20, 10.0, 0.01, 0.05)
        want = jpg.optimize_pose_graph(*(jnp.asarray(a) for a in args))
        got = tpg.optimize_pose_graph(*(T(a) for a in args))
        np.testing.assert_allclose(N(got.R), np.asarray(want.R), atol=1e-4)
        np.testing.assert_allclose(N(got.t), np.asarray(want.t), atol=1e-4)
        np.testing.assert_allclose(N(got.s), 1.0)
        c_gt = centers(gt[:, :3, :3], gt[:, :3, 3])
        assert np.linalg.norm(centers(N(got.R), N(got.t))[-1] - c_gt[-1]) < 0.25

    def test_cg_matches_dense(self):
        """The port's CG solver against its dense solver and against the
        JAX package's CG, within ``tests/test_sim3.py``'s 2 cm."""
        gt, est, args = drift_graph(9, 24, 8.0, 0.008, 0.04)
        dense = tpg.optimize_pose_graph(*(T(a) for a in args))
        cg = tpg.optimize_pose_graph_cg(*(T(a) for a in args), cg_iters=160)
        jcg = jpg.optimize_pose_graph_cg(*(jnp.asarray(a) for a in args), cg_iters=160)
        c_d, c_c = centers(N(dense.R), N(dense.t)), centers(N(cg.R), N(cg.t))
        assert np.linalg.norm(c_d - c_c, axis=1).max() < 2e-2
        c_j = centers(np.asarray(jcg.R), np.asarray(jcg.t))
        assert np.linalg.norm(c_j - c_c, axis=1).max() < 2e-2
        c_gt = centers(gt[:, :3, :3], gt[:, :3, 3])
        assert np.linalg.norm(c_c[-1] - c_gt[-1]) < 0.25


# ------------------------------------------------------------ CG BA


class TestBundleAdjustCG:
    @pytest.mark.parametrize("outlier_frac", [0.0, 0.15])
    def test_matches_jax(self, outlier_frac):
        """``bundle_adjust_cg`` on one ``BAProblem`` against the JAX
        package's, at ``tests/test_ba.py``'s engine tolerance: camera
        error within max(2x the JAX package's, 2 cm), cameras within 2 cm
        of each other, inlier masks within 1% of the observations."""
        rng = np.random.default_rng(10)
        prob, T_true, _ = make_ba_problem(
            rng, noise_px=0.3, pose_noise=0.06, pnt_noise=0.12,
            outlier_frac=outlier_frac, pad_cam=2, pad_pnt=20)
        want = jba_cg.bundle_adjust_cg(prob, cg_iters=96)
        got = tba_cg.bundle_adjust_cg(convert.ba_problem_from_numpy(prob, CPU),
                                      cg_iters=96)
        n = T_true.shape[0]
        err_j = np.linalg.norm(np.asarray(want.cam_Tcw)[:n, :3, 3] - T_true[:, :3, 3], axis=1)
        err_t = np.linalg.norm(N(got.cam_Tcw)[:n, :3, 3] - T_true[:, :3, 3], axis=1)
        assert err_t.max() < max(2.0 * err_j.max(), 0.02), (err_j, err_t)
        assert np.abs(N(got.cam_Tcw) - np.asarray(want.cam_Tcw)).max() < 2e-2
        diff = N(got.obs_inlier) != np.asarray(want.obs_inlier)
        assert diff.sum() <= 0.01 * diff.size
        # the padding cameras and KF 0 stay where they were
        np.testing.assert_array_equal(N(got.cam_Tcw)[0], np.asarray(prob.cam_Tcw)[0])


# ----------------------------------------------------------- the cooldown


class TestSim3FailCooldown(JaxCooldown):
    """``tests/test_loop_negative.py``'s cooldown cases on the port's
    ``LoopCloser`` (the JAX class's test bodies, the port's closer)."""

    def _closer(self):
        lc = tloop.LoopCloser.__new__(tloop.LoopCloser)
        tloop.LoopCloser.__post_init__(lc)
        lc.map = types.SimpleNamespace(
            covisible_neighbors=lambda k, n=10: [k - 1, k + 1])
        return lc


# ------------------------------------------------- the whole loop closer

LOOP_SEQ = dict(n_frames=92, width=512, height=160, trajectory="loop",
                seed=11, laps=1.15)   # tests/conftest.py::full_loop_run
CG_THRESHOLD = 16


def loop_cfgs(seq):
    from pyorbslam_tpu.config import CameraConfig, OrbConfig, SlamConfig

    jc = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=1000))
    return jc, convert.config_from_dict(convert.config_to_dict(jc))


def jax_map_copy(m):
    """A private copy of a JAX map with its native index rebuilt."""
    import copy
    out = copy.copy(m)
    out.landmarks = copy.deepcopy(m.landmarks)
    out.keyframes = copy.deepcopy(m.keyframes)
    out.parent, out.children = dict(m.parent), {k: set(v) for k, v in m.children.items()}
    out.loop_edges = {k: set(v) for k, v in m.loop_edges.items()}
    out.counters = type(m.counters)(int)
    out.times = type(m.times)(float)
    out.rebuild_core()
    return out


def injected_ransac(kf):
    """The port's ``sim3_ransac`` on the JAX package's draws for keyframe
    ``kf`` (``loop_closing.py:271`` seeds ``PRNGKey(kf)``)."""
    def run(X1, X2, uv1, uv2, s1, s2, active, cam4, generator, **kw):
        idx, refine = jax_draws(jax.random.PRNGKey(kf), N(active))
        return thorn.sim3_ransac_sets(X1, X2, uv1, uv2, s1, s2, active, cam4,
                                      idx, refine, **kw)
    return run


def recorder(obj, name, log):
    """Wrap ``obj.name`` (an instance's method or a module's function):
    each call's result goes to ``log[name]``.  Returns the original."""
    real = getattr(obj, name)

    def call(*args, **kwargs):
        out = real(*args, **kwargs)
        log.setdefault(name, []).append(out)
        return out
    setattr(obj, name, call)
    return real


def solved_poses(res) -> np.ndarray:
    """An essential-graph solution (R, t, s) as SE3 matrices [R | t/s]."""
    R, t, s = (N(a) for a in res)
    T = np.tile(np.eye(4, dtype=np.float32), (R.shape[0], 1, 1))
    T[:, :3, :3], T[:, :3, 3] = R, t / s[:, None]
    return T


def bindings(m) -> np.ndarray:
    """Every keyframe feature's landmark, replacements followed."""
    return m.landmarks.resolve(m.keyframes.obs_lm[: m.keyframes.n])


def merged_bindings(m, bound_before, cfg) -> tuple:
    """The bindings of either package's map that a closing call made
    (merged or added) and that it still holds, and how many of those the
    map's geometry rejects by local BA's inlier rule."""
    ks, lm = m.keyframes, m.landmarks
    n = bound_before.shape[0]
    bound = bindings(m)[:n]
    ki, fi = np.nonzero((bound >= 0) & (bound != bound_before) & ks.alive[:n, None])
    ids = bound[ki, fi]
    live = lm.alive[ids]
    ki, fi, ids = ki[live], fi[live], ids[live]
    view = types.SimpleNamespace(keyframes=ks, landmarks=lm, cfg=cfg)
    chi2, depth = tslam_map.SlamMap.observation_chi2(view, ki, fi, ids)
    return len(ids), int(((chi2 > tba.CHI2_STEREO) | (depth <= 0)).sum())


@pytest.fixture(scope="module")
def closing(data_cache_dir):
    """The JAX ``System`` over the cached loop sequence until its loop
    closer closes a loop.  A wrapper around that instance's
    ``loop_closer.on_keyframe`` asks ``detect`` first (restoring the
    consistency groups it moves); where detect has candidates, the JAX
    map's native index is recounted, the state is carried into two port
    ``System``s (``convert.system_from_numpy``) and one JAX map copy
    before the real call, and the JAX closer's
    ``compute_sim3`` / ``correct`` results are recorded.  The copies of
    the call that closes are kept; then the port's closer runs the same
    keyframe on them."""
    from pyorbslam_tpu.io.synthetic import generate_sequence
    from pyorbslam_tpu.slam import loop_closing as jloop
    from pyorbslam_tpu.slam import system as jsystem

    seq = generate_sequence(cache_dir=data_cache_dir, **LOOP_SEQ)
    jc, tc = loop_cfgs(seq)
    # the same configuration with the essential graph's CG branch taken at
    # this map size (tests/test_scale.py's threshold)
    tc_cg = dataclasses.replace(tc, ba=dataclasses.replace(
        tc.ba, pose_graph_cg_threshold=CG_THRESHOLD))
    jsys = jsystem.System(jc, landmark_capacity=1 << 16, keyframe_capacity=128)
    rec = {}

    def install(lc):
        real_on, real_detect = lc.on_keyframe, lc.detect

        def on_keyframe(kf, bow):
            if "kf" in rec:
                return real_on(kf, bow)
            saved = [(set(g), c) for g, c in lc.prev_groups]
            cands = real_detect(kf, bow)
            lc.prev_groups = saved
            if not cands:
                return real_on(kf, bow)
            # both packages start from a recounted native index: the port's
            # is rebuilt from the observation table by the conversion, and
            # covisibility weights the JAX run kept incrementally may be
            # stale (a weight >= 100 decides an essential-graph edge)
            jsys.map.rebuild_core()
            before = dict(
                port=convert.system_from_numpy(jsys, tc, CPU),
                port_gba=convert.system_from_numpy(jsys, tc, CPU),
                port_sharded=convert.system_from_numpy(jsys, tc, CPU),
                port_cg=convert.system_from_numpy(jsys, tc_cg, CPU),
                jax_gba=jax_map_copy(jsys.map))
            log = {}
            for name in ("detect", "compute_sim3", "_search_and_fuse"):
                recorder(lc, name, log)
            recorder(jsys.map, "reprojection_chi2", log)
            real_pg = recorder(jloop, "optimize_pose_graph", log)
            n_closed = lc.n_loops_closed
            bound_before = bindings(jsys.map)
            try:
                closed = real_on(kf, bow)
            finally:
                jloop.optimize_pose_graph = real_pg
            for name in ("detect", "compute_sim3", "_search_and_fuse"):
                delattr(lc, name)
            del jsys.map.reprojection_chi2
            if closed:
                ks = jsys.map.keyframes
                rec.update(before, kf=kf, bow=dict(bow), log=log,
                           jax_Tcw=ks.Tcw[: ks.n].copy(),
                           jax_accepted=lc.n_loops_closed == n_closed + 1,
                           jax_merged=merged_bindings(jsys.map, bound_before, tc))
            return closed

        lc.on_keyframe = on_keyframe

    for i in range(LOOP_SEQ["n_frames"]):
        jsys.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        if i == 0:
            install(jsys.loop_closer)
        if "kf" in rec:
            break
    assert "kf" in rec, "the JAX package closed no loop on the sequence"

    # the port's closer at the same keyframe, on the carried state
    kf, bow, port = rec["kf"], rec["bow"], rec["port"]
    plc = port.loop_closer
    rec["port_cands"] = plc.detect(kf, bow)
    real_ransac = tloop.sim3_ransac
    tloop.sim3_ransac = injected_ransac(kf)
    try:
        rec["port_hit"] = plc.compute_sim3(kf, rec["port_cands"])
    finally:
        tloop.sim3_ransac = real_ransac
    plog = {}
    recorder(plc, "_search_and_fuse", plog)
    recorder(port.map, "reprojection_chi2", plog)
    real_pg = recorder(tloop, "optimize_pose_graph", plog)
    loop_kf, Scw, match_map = rec["log"]["compute_sim3"][0]
    closed0 = plc.n_loops_closed
    bound_before = bindings(port.map)
    try:
        plc.correct(kf, loop_kf, Scw, dict(match_map))
    finally:
        tloop.optimize_pose_graph = real_pg
    rec["port_merged"] = merged_bindings(port.map, bound_before, tc)
    del port.map.reprojection_chi2
    rec["plog"] = plog
    rec["port_accepted"] = plc.n_loops_closed == closed0 + 1
    return rec


def rot_deg(Ra, Rb):
    """Angle between rotations from ||Ra - Rb||_F = 2 sqrt(2) sin(a / 2):
    unlike the trace, blind to the float32 drift from orthonormality that
    chained Sim3 products carry in both packages alike."""
    d = np.linalg.norm((np.asarray(Ra, np.float64) - Rb).reshape(
        np.shape(Ra)[:-2] + (9,)), axis=-1)
    return np.degrees(2 * np.arcsin(np.clip(d / (2 * np.sqrt(2)), 0, 1)))


class TestWholeCloser:
    """The port's ``LoopCloser`` at the JAX package's closing keyframe,
    started from the JAX state carried over just before that call."""

    def test_detect_candidates_equal(self, closing):
        want = closing["log"]["detect"][0]
        assert want and closing["port_cands"] == want

    def test_compute_sim3(self, closing):
        """The same loop keyframe; with the JAX package's draws injected,
        the Sim3 within 0.5 deg and 2 cm and >= 90% of the loop-landmark
        bindings (feature keys) shared."""
        want = closing["log"]["compute_sim3"][0]
        got = closing["port_hit"]
        assert want is not None and got is not None
        assert got[0] == want[0]
        (Rw, tw, sw), (Rg, tg, sg) = want[1], got[1]
        assert sw == sg == 1.0
        assert rot_deg(Rg, Rw) < 0.5
        assert np.linalg.norm(-Rg.T @ tg + Rw.T @ tw) < 0.02
        kw, kg = set(want[2]), set(got[2])
        assert len(kw & kg) >= 0.9 * max(len(kw), len(kg))

    def test_correct(self, closing):
        """From the JAX package's Sim3 and bindings: the same accept
        decision; keyframe poses within 0.5 deg and 2 cm, both as the
        essential graph placed them (the geometry the accept check
        judges) and as ``correct`` left them; the fused count within 10%;
        the accept check's two reprojection chi2 values within 1e-3
        relative."""
        assert closing["port_accepted"] == closing["jax_accepted"]
        n = closing["jax_Tcw"].shape[0]
        for got, want in (
                (solved_poses(closing["plog"]["optimize_pose_graph"][0])[:n],
                 solved_poses(closing["log"]["optimize_pose_graph"][0])[:n]),
                (closing["port"].map.keyframes.Tcw[:n], closing["jax_Tcw"])):
            assert rot_deg(got[:, :3, :3], want[:, :3, :3]).max() < 0.5
            c_got = -np.einsum("kji,kj->ki", got[:, :3, :3], got[:, :3, 3])
            c_want = -np.einsum("kji,kj->ki", want[:, :3, :3], want[:, :3, 3])
            assert np.linalg.norm(c_got - c_want, axis=1).max() < 0.02
        nf_w = closing["log"]["_search_and_fuse"][0]
        nf_g = closing["plog"]["_search_and_fuse"][0]
        assert nf_w > 0 and abs(nf_g - nf_w) <= 0.1 * nf_w
        cw, cg = closing["log"]["reprojection_chi2"], closing["plog"]["reprojection_chi2"]
        assert len(cw) == len(cg) == 2
        np.testing.assert_allclose(cg, cw, rtol=1e-3)
        loop_kf = closing["log"]["compute_sim3"][0][0]
        assert closing["port"].map.loop_edges == (
            {closing["kf"]: {loop_kf}, loop_kf: {closing["kf"]}}
            if closing["port_accepted"] else {})

    def test_correct_sharded_essential_graph(self, closing):
        """``correct`` with its essential graph sharded over 4 CPU shards
        (``parallel/dist_pose_graph.py``; the branch the port takes above
        the CG threshold where several CUDA devices are visible) from the
        same state and Sim3: the same accept decision, and keyframe poses
        within 0.5 deg and 2 cm of the port's one-device correction (its
        dense solver here; ``tests/test_sim3.py``'s dense-against-CG
        tolerance)."""
        sysm = closing["port_sharded"]
        lc = sysm.loop_closer
        lc._pose_graph_mesh = lambda big: tdist.device_mesh(CPU, 4)
        loop_kf, Scw, match_map = closing["log"]["compute_sim3"][0]
        closed0 = lc.n_loops_closed
        lc.correct(closing["kf"], loop_kf, Scw, dict(match_map))
        assert (lc.n_loops_closed == closed0 + 1) == closing["port_accepted"]
        n = closing["jax_Tcw"].shape[0]
        got = sysm.map.keyframes.Tcw[:n]
        want = closing["port"].map.keyframes.Tcw[:n]
        assert rot_deg(got[:, :3, :3], want[:, :3, :3]).max() < 0.5
        c_got = centers(got[:, :3, :3], got[:, :3, 3])
        c_want = centers(want[:, :3, :3], want[:, :3, 3])
        assert np.linalg.norm(c_got - c_want, axis=1).max() < 0.02

    def test_correct_cg_essential_graph(self, closing):
        """``correct`` with the essential graph above its CG threshold
        (``optimize_pose_graph_cg``, the branch the default configuration
        takes above 384 keyframes) from the same state and Sim3: the same
        accept decision as the dense correction, and keyframe poses within
        0.5 deg and 2 cm of it (the sharded case's tolerance)."""
        sysm = closing["port_cg"]
        lc = sysm.loop_closer
        n = closing["jax_Tcw"].shape[0]
        assert n > sysm.cfg.ba.pose_graph_cg_threshold == CG_THRESHOLD
        log = {}
        real_cg = recorder(tloop, "optimize_pose_graph_cg", log)
        real_dense = recorder(tloop, "optimize_pose_graph", log)
        loop_kf, Scw, match_map = closing["log"]["compute_sim3"][0]
        closed0 = lc.n_loops_closed
        try:
            lc.correct(closing["kf"], loop_kf, Scw, dict(match_map))
        finally:
            tloop.optimize_pose_graph_cg = real_cg
            tloop.optimize_pose_graph = real_dense
        assert len(log.get("optimize_pose_graph_cg", ())) == 1
        assert "optimize_pose_graph" not in log
        assert (lc.n_loops_closed == closed0 + 1) == closing["port_accepted"]
        got = solved_poses(log["optimize_pose_graph_cg"][0])[:n]
        want = solved_poses(closing["plog"]["optimize_pose_graph"][0])[:n]
        for g, w in ((got, want),
                     (sysm.map.keyframes.Tcw[:n], closing["port"].map.keyframes.Tcw[:n])):
            assert rot_deg(g[:, :3, :3], w[:, :3, :3]).max() < 0.5
            c_got = centers(g[:, :3, :3], g[:, :3, 3])
            c_want = centers(w[:, :3, :3], w[:, :3, 3])
            assert np.linalg.norm(c_got - c_want, axis=1).max() < 0.02

    def test_rolled_back_bindings(self, closing):
        """ROADMAP.md queue 3, F6: the closing call is rolled back in both
        packages (on the recounted state, see ``closing``).  The JAX
        package keeps every binding the call merged, and its restored
        geometry rejects some of them (chi2 above the stereo gate); the
        port erases those, so every merged binding it keeps agrees with
        the geometry, and it keeps as many as the JAX package keeps
        agreeing ones (within 10%)."""
        (jax_held, jax_bad), (port_held, port_bad) = (
            closing["jax_merged"], closing["port_merged"])
        assert not closing["jax_accepted"] and not closing["port_accepted"]
        assert jax_bad > 0 and port_bad == 0
        erased = [e for e in closing["port"].loop_closer.events
                  if isinstance(e, str) and e.startswith("loop:rolled_back_bindings")]
        assert len(erased) == 1
        good = jax_held - jax_bad
        assert abs(port_held - good) <= 0.1 * good, (port_held, jax_held, jax_bad)

    def test_global_ba_dense(self, closing):
        """``SlamMap.global_ba`` (its dense rung at this map size) on the
        state before the closing call: keyframe poses within 1e-3 m, the
        maps' reprojection chi2 within 1%."""
        jm, pm = closing["jax_gba"], closing["port_gba"].map
        want, got = jm.global_ba(iters=2), pm.global_ba(iters=2)
        assert want["ran"] and got["ran"]
        assert got["n_cams"] == want["n_cams"] <= 96
        assert got["n_obs"] == want["n_obs"]
        n = jm.keyframes.n
        assert np.abs(pm.keyframes.Tcw[:n] - jm.keyframes.Tcw[:n]).max() < 1e-3
        assert pm.reprojection_chi2() == pytest.approx(jm.reprojection_chi2(), rel=1e-2)

    def test_garbage_sim3_is_rolled_back(self, closing):
        """``tests/test_loop_closing.py``'s roll-back case on the port: a
        Sim3 6 m and 20 deg off must be rejected and the geometry
        restored."""
        check_rollback(closing["port"])


def check_rollback(sysm):
    lc = sysm.loop_closer
    ks = sysm.map.keyframes
    kf = ks.n - 1
    pre_Tcw = ks.Tcw[: ks.n].copy()
    pre_closed, pre_rejected = lc.n_loops_closed, lc.n_loops_rejected
    bad = ks.Tcw[kf].copy()
    c, s = np.cos(0.35), np.sin(0.35)
    bad[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) @ bad[:3, :3]
    bad[0, 3] += 6.0
    lc.correct(kf, 0, (bad[:3, :3].copy(), bad[:3, 3].copy(), 1.0), match_map={})
    assert lc.n_loops_rejected == pre_rejected + 1
    assert lc.n_loops_closed == pre_closed
    assert np.abs(ks.Tcw[: ks.n] - pre_Tcw).max() < 1e-4
    assert any("accept_check" in e for e in lc.events)
