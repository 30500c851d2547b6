"""Parity of the PyTorch port's sharded engines (``parallel/dist_ba.py``,
``parallel/dist_pose_graph.py``) and of global BA's ``dist`` rung with the
JAX package.

The port's stand-in for the tests' 8-device virtual CPU mesh
(``tests/conftest.py``) is a mesh of 8 shards on the CPU, made by name
(``dist_ba.device_mesh("cpu", 8)``).  The four cases of
``tests/test_dist_ba.py`` run on the same seeded problems through the
JAX package's mesh, the port's mesh and the port's single-device engines,
under the JAX tests' own tolerances: camera translations within 2e-3 m,
pose-graph R and t within 5e-3.  A sum over shards is not bit-equal to one
segment sum, so nothing is compared bit for bit.  ``_run_ba(engine="dist")``
runs on a map carried from a JAX ``System``, against the JAX package's
``dist`` rung on the same map and the port's ``cg`` rung (camera centres
within 2 cm), and that map is tiled as ``tests/test_dist_gba_scale.py``
tiles its own, to fewer cameras and observations (the full tiling runs on
the card, ``chip_smoke.py`` phase 12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import make_ba_problem
from test_dist_ba import shardable_problem
from test_torch_mapping import make_cfgs

from pyorbslam_tpu.optim import ba_cg as jba_cg
from pyorbslam_tpu.parallel import dist_ba as jdist
from pyorbslam_tpu.parallel import dist_pose_graph as jdpg
from pyorbslam_tpu.slam import system as jsystem

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.optim import ba as tba
from pyorbslam_tpu_torch.optim import ba_cg as tba_cg
from pyorbslam_tpu_torch.optim import pose_graph as tpg
from pyorbslam_tpu_torch.parallel import dist_ba as tdist
from pyorbslam_tpu_torch.parallel import dist_pose_graph as tdpg
from pyorbslam_tpu_torch.tools import gba_tiling
from pyorbslam_tpu_torch.tools import multihost_dryrun as dryrun
from pyorbslam_tpu_torch.tools.gba_tiling import centres
from pyorbslam_tpu_torch.tools.multihost_dryrun import drift_graph

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
N_SHARDS = 8
T_TOL = 2e-3          # tests/test_dist_ba.py: camera translations
PG_TOL = 5e-3         # tests/test_dist_ba.py: pose graph R and t
CENTRE_TOL = 0.02     # the dist rung against the cg rung (chip_smoke phase 9)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= N_SHARDS, "conftest must provide 8 CPU devices"
    return jdist.make_mesh(N_SHARDS), tdist.device_mesh(CPU, N_SHARDS)


def N(t):
    return t.detach().cpu().numpy()


def port(prob):
    return convert.ba_problem_from_numpy(prob, CPU)


def trans(cam) -> np.ndarray:
    return np.asarray(cam)[:, :3, 3]


class TestDistributedBA:
    def test_matches_single_device_quality(self, meshes):
        """``distributed_bundle_adjust`` (the dense reduced system): the JAX
        test's quality gates, and translations within 2e-3 m of the JAX
        package's mesh and of the port's single-device ``bundle_adjust``."""
        jmesh, tmesh = meshes
        prob, T_true, _ = shardable_problem(np.random.default_rng(0))
        want, _, _ = jdist.distributed_bundle_adjust(
            jdist.shard_problem(prob, jmesh), jmesh, n_cam=8)
        got, _, _ = tdist.distributed_bundle_adjust(
            tdist.shard_problem(port(prob), tmesh), tmesh, n_cam=8)
        one = tba.bundle_adjust(port(prob))
        err = np.linalg.norm(trans(N(got))[:8] - T_true[:, :3, 3], axis=1)
        err_1 = np.linalg.norm(trans(N(one.cam_Tcw))[:8] - T_true[:, :3, 3], axis=1)
        assert err.max() < 0.06, err
        assert err.mean() < 2.0 * err_1.mean() + 1e-3
        np.testing.assert_allclose(trans(N(got)), trans(want), atol=T_TOL)
        np.testing.assert_allclose(trans(N(got)), trans(N(one.cam_Tcw)), atol=T_TOL)

    def test_point_updates_happen_on_shards(self, meshes):
        """Every shard's points move and land near the truth, and where the
        JAX package's mesh puts them (2e-3 m)."""
        jmesh, tmesh = meshes
        prob, _, pts = shardable_problem(np.random.default_rng(1))
        _, want, _ = jdist.distributed_bundle_adjust(
            jdist.shard_problem(prob, jmesh), jmesh, n_cam=8)
        _, got, inlier = tdist.distributed_bundle_adjust(
            tdist.shard_problem(port(prob), tmesh), tmesh, n_cam=8)
        n = len(pts)
        got = N(got)
        assert got.shape == np.asarray(prob.pnt_pos).shape
        assert N(inlier).shape == np.asarray(prob.obs_active).shape
        moved = np.linalg.norm(got[:n] - np.asarray(prob.pnt_pos)[:n], axis=1)
        assert (moved > 1e-6).mean() > 0.9
        assert np.median(np.linalg.norm(got[:n] - pts, axis=1)) < 0.1
        np.testing.assert_allclose(got, np.asarray(want), atol=T_TOL)


class TestDistributedBACG:
    def test_large_camera_count_no_truncation(self, meshes):
        """300 cameras, every one free: the cameras past the dense engine's
        256 cap move, and the solve reaches the single-device CG engine's
        quality (the JAX test's gates); translations within 2e-3 m of the
        port's single-device CG."""
        _, tmesh = meshes
        rng = np.random.default_rng(7)
        n_cam = 300
        flat, T_true, _ = make_ba_problem(
            rng, n_cam=n_cam, n_pnt=3072 - 8, noise_px=0.3, pose_noise=0.004,
            pnt_noise=0.05, pad_pnt=8, pnt_span=(-12.0, 250.0))
        new_pnt, (oc, ouvr, oisig), active = tdist.group_observations_by_point_shard(
            np.asarray(flat.obs_pnt), flat.pnt_pos.shape[0], N_SHARDS,
            (np.asarray(flat.obs_cam), np.asarray(flat.obs_uvr),
             np.asarray(flat.obs_inv_sigma2)))
        prob = flat._replace(
            obs_pnt=jnp.asarray(new_pnt), obs_cam=jnp.asarray(oc),
            obs_uvr=jnp.asarray(ouvr), obs_inv_sigma2=jnp.asarray(oisig),
            obs_active=jnp.asarray(active))
        iters = dict(iters1=3, iters2=5, cg_iters=64)
        cam, _, _ = tdist.distributed_bundle_adjust_cg(
            tdist.shard_problem(port(prob), tmesh), tmesh, n_cam=n_cam, **iters)
        cam = N(cam)
        assert np.isfinite(cam).all()
        moved = np.linalg.norm(cam[256:, :3, 3]
                               - np.asarray(prob.cam_Tcw)[256:, :3, 3], axis=1)
        assert (moved > 1e-6).all(), moved.min()
        # the single-device engine on the same observations, ungrouped
        # (grouping pads them 2.4x here with inactive rows)
        ref = N(tba_cg.bundle_adjust_cg(port(flat), **iters).cam_Tcw)
        err = np.linalg.norm(cam[:, :3, 3] - T_true[:, :3, 3], axis=1)
        ref_err = np.linalg.norm(ref[:, :3, 3] - T_true[:, :3, 3], axis=1)
        assert np.median(err) < 1.5 * np.median(ref_err) + 1e-3
        assert np.median(err) < 0.08
        np.testing.assert_allclose(trans(cam), trans(ref), atol=T_TOL)

    def test_matches_single_device_cg(self, meshes):
        """The sum over shards of per-shard segment sums is the global
        segment sum: translations within 2e-3 m of the port's single-device
        CG, of the JAX package's single-device CG and of its mesh."""
        jmesh, tmesh = meshes
        prob, _, _ = shardable_problem(np.random.default_rng(3))
        iters = dict(iters1=3, iters2=5, cg_iters=48)
        got, _, _ = tdist.distributed_bundle_adjust_cg(
            tdist.shard_problem(port(prob), tmesh), tmesh, n_cam=8, **iters)
        want, _, _ = jdist.distributed_bundle_adjust_cg(
            jdist.shard_problem(prob, jmesh), jmesh, n_cam=8, **iters)
        one = tba_cg.bundle_adjust_cg(port(prob), **iters)
        jone = jba_cg.bundle_adjust_cg(prob, **iters)
        for ref in (N(one.cam_Tcw), np.asarray(jone.cam_Tcw), np.asarray(want)):
            np.testing.assert_allclose(trans(N(got)), trans(ref), atol=T_TOL)


class TestDistributedPoseGraph:
    def test_matches_single_device_cg(self, meshes):
        """The sharded essential graph within 5e-3 (R and t) of the port's
        single-device CG solver and of the JAX package's mesh, and the loop
        gap closed as the JAX test requires."""
        jmesh, tmesh = meshes
        gt, _, args = drift_graph(5, 24, 8.0, 0.008, 0.04)
        pe = tdpg.pad_edges(N_SHARDS, *args[4:])
        reps, shds = tdpg.place_pose_graph(tmesh, args[:4], list(pe))
        got = tdpg.distributed_pose_graph(tmesh, *reps, *shds, cg_iters=128)
        ref = tpg.optimize_pose_graph_cg(*(convert.tensor_from_numpy(a, CPU)
                                           for a in args), cg_iters=128)
        jreps, jshds = jdpg.place_pose_graph(
            jmesh, args[:4], list(jdpg.pad_edges(N_SHARDS, *args[4:])))
        want = jdpg.distributed_pose_graph(jmesh, *jreps, *jshds, cg_iters=128)
        for R, t in ((N(ref.R), N(ref.t)), (np.asarray(want.R), np.asarray(want.t))):
            np.testing.assert_allclose(N(got.t), t, atol=PG_TOL)
            np.testing.assert_allclose(N(got.R), R, atol=PG_TOL)
        c_gt = centres(gt[:, :3, :3], gt[:, :3, 3])
        c = centres(N(got.R), N(got.t))
        assert np.linalg.norm(c[-1] - c_gt[-1]) < 0.25

    def test_pad_edges_matches_jax(self):
        _, _, args = drift_graph(5, 24, 8.0, 0.008, 0.04)
        for got, want in zip(tdpg.pad_edges(N_SHARDS, *args[4:]),
                             jdpg.pad_edges(N_SHARDS, *args[4:])):
            np.testing.assert_array_equal(got, want)


# ------------------------------------------ global BA on a System's map


@pytest.fixture(scope="module")
def system_map(synth_seq):
    """A JAX ``System`` over the first 12 frames of the cached sequence
    (loop closing off), its native index recounted, and its configs."""
    jc, tc = make_cfgs(synth_seq)
    jsys = jsystem.System(jc, landmark_capacity=1 << 15, keyframe_capacity=64,
                          enable_loop_closing=False)
    for i in range(12):
        jsys.track_stereo(synth_seq.left[i], synth_seq.right[i],
                          synth_seq.timestamps[i])
    jsys.map.rebuild_core()
    return jsys, tc


def live_problem(m):
    """All live keyframes and observed landmarks of map ``m``."""
    ks = m.keyframes
    live = [k for k in range(ks.n) if ks.alive[k]]
    return live, m.core.observed_landmarks(m.landmarks.n)


def test_run_ba_dist_rung(system_map):
    """``SlamMap._run_ba(engine="dist")`` on the carried map over the port's
    8-shard mesh: camera centres within 2 cm of the JAX package's ``dist``
    rung (its 8-device mesh) on the same map and of the port's ``cg``
    rung; the keyframe that anchors the gauge does not move."""
    jsys, tc = system_map
    runs = {}
    for engine in ("dist", "cg"):
        m = convert.system_from_numpy(jsys, tc, CPU).map
        live, pnt = live_problem(m)
        before = m.keyframes.Tcw[: m.keyframes.n].copy()
        mesh = tdist.device_mesh(CPU, N_SHARDS) if engine == "dist" else None
        info = m._run_ba(live, len(live), pnt, 2, 0, False, engine=engine,
                         mesh=mesh)
        assert info["ran"] and info["n_cams"] == len(live) >= 3
        runs[engine] = m.keyframes.Tcw[: m.keyframes.n].copy()
    jm = jsys.map
    live, pnt = live_problem(jm)
    assert jm._run_ba(live, len(live), pnt, 2, 0, False, engine="dist")["ran"]
    want = jm.keyframes.Tcw[: jm.keyframes.n]
    c_dist, c_jax, c_cg = (centres(T[:, :3, :3], T[:, :3, 3])
                           for T in (runs["dist"], want, runs["cg"]))
    assert np.linalg.norm(c_dist - c_jax, axis=1).max() < CENTRE_TOL
    assert np.linalg.norm(c_dist - c_cg, axis=1).max() < CENTRE_TOL
    np.testing.assert_array_equal(runs["dist"][0], before[0])


def test_dist_gba_at_system_scale(system_map):
    """``tests/test_dist_gba_scale.py`` at a smaller tiling: the carried
    map's problem in rigid copies around a ring (>= 64 cameras, >= 40k
    observations), poses noised by 3 cm; the 8-shard CG pulls them back
    (median centre error under 0.8x the start) and within 1.5x (+1 mm)
    of the single-device CG's."""
    jsys, tc = system_map
    m = convert.system_from_numpy(jsys, tc, CPU).map
    tiled = gba_tiling.tile(m, tc, min_cams=64, min_obs=40_000, pad_to=N_SHARDS)
    prob, true_c = tiled.prob, tiled.true_centres
    C = prob.cam_Tcw.shape[0]
    assert C >= 64 and prob.obs_cam.shape[0] >= 40_000
    mesh = tdist.device_mesh(CPU, N_SHARDS)
    iters = dict(iters1=3, iters2=0, cg_iters=48)
    cam, _, _ = tdist.distributed_bundle_adjust_cg(
        tdist.shard_problem(dryrun.group_for_shards(prob, N_SHARDS), mesh),
        mesh, n_cam=C, **iters)
    ref = tba_cg.bundle_adjust_cg(prob, **iters)
    err_before, err, ref_err = (
        np.linalg.norm(centres(T[:, :3, :3], T[:, :3, 3]) - true_c, axis=1)
        for T in (N(prob.cam_Tcw), N(cam), N(ref.cam_Tcw)))
    assert np.isfinite(N(cam)).all()
    assert np.median(err) < 0.8 * np.median(err_before), (
        np.median(err), np.median(err_before))
    assert np.median(err) < 1.5 * np.median(ref_err) + 1e-3, (
        np.median(err), np.median(ref_err))


def test_no_quiet_fallback(system_map):
    """``make_mesh()`` takes CUDA devices and raises where there are none
    (it never returns a CPU mesh); the ``dist`` rung on a CPU map with no
    mesh given raises instead of running elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: make_mesh() succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.make_mesh()
    jsys, tc = system_map
    m = convert.system_from_numpy(jsys, tc, CPU).map
    live, pnt = live_problem(m)
    with pytest.raises(ValueError, match="pass a mesh"):
        m._run_ba(live, len(live), pnt, 2, 0, False, engine="dist")
