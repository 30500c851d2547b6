"""The port's bench (``python3 -m pyorbslam_tpu_torch.bench``) against the
repository's ``bench.py``.

(a) The tracking program: the port's step chained over 8 frames of the
cached 512x160 straight sequence (1000 features) against the same chain
composed from the JAX package's public functions exactly as ``bench.py``
composes it (``build_stereo_frame``, ``unproject``,
``motion_track_step.__wrapped__`` under one ``jax.jit``).  Poses within
1 cm and 0.1 deg, inlier counts within 2% (the tolerance the port's
``Tracker`` is held to against the JAX one); the ``scan`` and ``stream`` modes give the same poses.
(b) Every ``BENCH_CONFIG`` on the CPU at that size with one timed pass:
the record's keys and their types are ``bench.py``'s for that mode (read
from its source), ``n_frames`` is the run's, every pose is finite.
(c) ``--device cuda`` without CUDA raises; the environment variables
reach the run as ``bench.py`` reads them.
(d) A BA problem cut at its largest bucket is counted in ``map.counters``.

``PYTHONPATH=. python tests/test_torch_bench.py --package jax|jax-rigid|port``
runs the bench's two windowed schedules at its own size (1241x376, 2000
features, W = 8, 64 frames), one pass each: the JAX package on the
platform ``JAX_PLATFORMS`` names (``PYORBSLAM_PALLAS=0`` off the TPU),
the same with every pose it sets projected onto SE(3) (``jax-rigid``: the
port's repair of fault F4, ROADMAP queue 3), or the port on the card.
One JSON line a run: ATE, keyframes, events.
"""

import argparse
import ast
import functools
import json
import os
import time
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyorbslam_tpu import config as jcfg_mod
from pyorbslam_tpu.geometry import se3 as jse3
from pyorbslam_tpu.io.synthetic import generate_sequence
from pyorbslam_tpu.slam import frame as jframe
from pyorbslam_tpu.slam.tracking import motion_track_step as jmotion_track_step

from pyorbslam_tpu_torch import bench
from pyorbslam_tpu_torch.slam import slam_map

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FEATURES = 1000
N_TRACK = 8
TRANS_TOL = 0.01                 # m
ROT_TOL = np.deg2rad(0.1)        # rad
INLIER_TOL = 0.02                # relative
# BENCH_CONFIG -> (frames, BENCH_WINDOW) of the CPU runs
RUNS = {"": (3, 8), "perframe": (3, 8), "pipeline": (3, 8),
        "highdensity_pipeline": (3, 8), "pipeline_window": (8, 4),
        "pipeline_pipelined": (8, 4), "tracking": (N_TRACK, 8),
        "highdensity": (3, 8)}
# the types of bench.py's record fields
TYPES = dict(metric=str, value=float, unit=str, vs_baseline=float,
             baseline_fps=float, baseline_source=str, config=str, mode=str,
             n_frames=int, n_keyframes=int, ate_rmse_m=float, fps_passes=list,
             device=str, tracking_only_fps=float, stages_s=dict,
             ba_stages_s=dict, ba_counters=dict, schedule_events=dict)


@pytest.fixture(scope="module")
def seq30(data_cache_dir):
    return generate_sequence(
        n_frames=30, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir)


def bench_py_keys(function: str) -> set:
    """The keys of the record ``function`` of the repository's bench.py
    prints: its dict literals' string keys and its ``rec["..."] =``
    assignments."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            keys |= {k.value for k in node.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


@pytest.fixture(scope="module", autouse=True)
def bench_features():
    """The bench's feature count at the tests' frame size (its 2000 are
    for 1241x376)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "N_FEATURES", N_FEATURES)
        yield


def run(config: str, seq, mode: str = "scan"):
    n, window = RUNS[config]
    return bench.run_config(config, CPU, n_frames=n, mode=mode, window=window,
                            passes=1, seq=seq)


@pytest.fixture(scope="module")
def port_tracking(seq30):
    return {mode: run("tracking", seq30, mode) for mode in ("scan", "stream")}


@pytest.fixture(scope="module")
def jax_tracking(seq30):
    """bench.py:104-117's chain over the same frames, from the JAX
    package's public functions; (poses, inlier counts) of frames 2..7."""
    jc = jcfg_mod.SlamConfig(
        camera=jcfg_mod.CameraConfig(
            fx=float(seq30.K[0, 0]), fy=float(seq30.K[1, 1]),
            cx=float(seq30.K[0, 2]), cy=float(seq30.K[1, 2]),
            width=512, height=160, bf=seq30.bf, th_depth=40.0),
        orb=jcfg_mod.OrbConfig(n_features=N_FEATURES))

    @functools.partial(jax.jit, static_argnames=("c",))
    def fused_step(left, right, prev_frame, Tlw, Tllw, c):
        frame = jframe.build_stereo_frame(left, right, c)
        q_pos = jframe.unproject(prev_frame, c, jse3.inverse(Tlw))
        vel = Tlw @ jse3.inverse(Tllw)
        res = jmotion_track_step.__wrapped__(
            frame, q_pos, prev_frame.desc, prev_frame.angle,
            prev_frame.octave, prev_frame.depth > 0, vel @ Tlw, Tlw, c)
        return frame, res.Tcw, res.n_inliers

    n_kp = jc.orb.max_keypoints
    dummy = jframe.StereoFrame(
        xy=jnp.zeros((n_kp, 2)), response=jnp.zeros(n_kp),
        angle=jnp.zeros(n_kp), octave=jnp.zeros(n_kp, jnp.int32),
        desc=jnp.zeros((n_kp, 8), jnp.uint32),
        desc_bits=jnp.zeros((n_kp, 256), jnp.int8),
        valid=jnp.zeros(n_kp, bool),
        u_right=jnp.full(n_kp, -1.0), depth=jnp.full(n_kp, -1.0))
    frames = [(jnp.asarray(seq30.left[i]), jnp.asarray(seq30.right[i]))
              for i in range(N_TRACK)]
    eye = jnp.eye(4, dtype=jnp.float32)
    frame, _, _ = fused_step(*frames[0], dummy, eye, eye, jc)
    frame, Tcw, _ = fused_step(*frames[1], frame, eye, eye, jc)
    prev, Tlw, Tllw = frame, Tcw, eye
    poses, n_ins = [], []
    for i in range(2, N_TRACK):
        frame, Tcw, n_in = fused_step(*frames[i], prev, Tlw, Tllw, jc)
        poses.append(np.asarray(Tcw))
        n_ins.append(int(n_in))
        prev, Tllw, Tlw = frame, Tlw, Tcw
    return np.stack(poses), np.asarray(n_ins)


class TestTrackingProgram:
    def test_follows_the_jax_chain(self, port_tracking, jax_tracking):
        poses_j, n_in_j = jax_tracking
        _, port = port_tracking["scan"]
        assert port.poses.shape == poses_j.shape == (N_TRACK - 2, 4, 4)
        for Tp, Tj in zip(port.poses.astype(np.float64), poses_j.astype(np.float64)):
            assert np.abs(Tp[:3, 3] - Tj[:3, 3]).max() < TRANS_TOL
            # ||Rp - Rj||_F is sqrt(2) times the angle between them
            assert np.linalg.norm(Tp[:3, :3] - Tj[:3, :3]) / np.sqrt(2.0) < ROT_TOL
        assert (n_in_j > 50).all()
        np.testing.assert_allclose(port.n_inliers, n_in_j, rtol=INLIER_TOL)

    def test_scan_equals_stream(self, port_tracking):
        (rec_scan, scan), (rec_stream, stream) = \
            port_tracking["scan"], port_tracking["stream"]
        np.testing.assert_array_equal(scan.poses, stream.poses)
        np.testing.assert_array_equal(scan.n_inliers, stream.n_inliers)
        assert (rec_scan["mode"], rec_stream["mode"]) == ("scan", "stream")
        assert rec_scan["n_frames"] == rec_stream["n_frames"] == N_TRACK - 2


@pytest.fixture(scope="module")
def runs(seq30, port_tracking):
    """``runs(config)``: the (record, detail) of that config's run, made
    once."""
    made = {"tracking": port_tracking["scan"]}

    def get(config):
        if config == "pipeline":
            # the same schedule as perframe (bench.py:37-62): one run serves both
            assert bench.FULL_CONFIGS["pipeline"] == bench.FULL_CONFIGS["perframe"]
            config = "perframe"
        if config not in made:
            made[config] = run(config, seq30)
        return made[config]
    return get


@pytest.mark.parametrize("config", list(RUNS))
def test_every_config(config, runs):
    rec, detail = runs(config)
    json.dumps(rec)
    n, window = RUNS[config]
    if config in bench.TRACKING_CONFIGS:
        want = bench_py_keys("bench_tracking_scan")
        assert rec["n_frames"] == n - 2
        poses = detail.poses
        assert rec["mode"] == "scan"
    else:
        want = bench_py_keys("bench_full_pipeline")
        if config != "":
            want.discard("tracking_only_fps")
        windowed = bench.FULL_CONFIGS[config].get("windowed", False)
        n_used = n - (n % window if windowed else 0)
        assert rec["n_frames"] == n_used
        poses = detail.corrected_trajectory()
        assert len(poses) == n_used and len(rec["fps_passes"]) == 1
        assert rec["n_keyframes"] == detail.map.keyframes.n >= 1
        assert all(isinstance(k, str) for k in rec["schedule_events"])
        assert rec["stages_s"] and all(
            isinstance(t, float) and isinstance(c, int)
            for t, c in rec["stages_s"].values())
        assert ("window=4" in rec["config"]) == windowed
    assert set(rec) == want
    for key, value in rec.items():
        assert isinstance(value, TYPES[key]), (key, value)
    features = N_FEATURES * (bench.DENSITY if "highdensity" in config else 1)
    assert rec["config"].startswith(f"512x160 stereo, {features} ORB features")
    assert rec["device"] == "cpu" and rec["value"] > 0
    assert np.isfinite(poses).all()


def test_ba_cuts_are_counted(runs, monkeypatch):
    """A BA problem beyond its largest bucket is cut, as in the JAX package
    (``slam_map.py:369``); the cut cameras and points, and a gather that
    stopped at its capacity, are counted in ``map.counters``."""
    _, sysm = runs("pipeline_window")
    smap = sysm.map
    cams = np.arange(smap.keyframes.n, dtype=np.int32)
    pnt_ids = np.nonzero(smap.landmarks.alive)[0].astype(np.int32)
    assert len(cams) >= 2 and len(pnt_ids) > 64
    before = Counter(smap.counters)
    monkeypatch.setattr(slam_map, "CAM_BUCKETS", (len(cams) - 1,))
    monkeypatch.setattr(slam_map, "PNT_BUCKETS", (64,))
    monkeypatch.setattr(slam_map, "OBS_BUCKETS", (32,))
    # split: dispatched and never applied, so the run's map stays as it is
    info = smap._run_ba(cams, len(cams) - 1, pnt_ids, 1, 1,
                        erase_outliers=False, split=True)
    assert info["n_cams"] == len(cams) - 1 and info["n_obs"] == 32
    assert Counter(smap.counters) - before == Counter({
        "ba.truncated_cams": 1, "ba.truncated_points": len(pnt_ids) - 64,
        "ba.obs_at_capacity": 1})


class TestEntryPoint:
    def test_no_cuda_raises(self, monkeypatch):
        """The default ``--device cuda`` fails where CUDA is missing: no
        fall-back to the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.main([])

    def test_environment(self, seq30, monkeypatch, capsys):
        """BENCH_CONFIG, BENCH_FRAMES, BENCH_MODE and BENCH_WINDOW reach
        the run; one JSON line is printed; an unknown config is refused."""
        seen = []

        def fake(config, device, **kw):
            seen.append((config, device, kw))
            return {"metric": config}, None

        monkeypatch.setattr(bench, "run_config", fake)
        for name, value in (("BENCH_CONFIG", "pipeline_window"),
                            ("BENCH_FRAMES", "16"), ("BENCH_MODE", "stream"),
                            ("BENCH_WINDOW", "4")):
            monkeypatch.setenv(name, value)
        bench.main(["--device", "cpu"])
        assert seen == [("pipeline_window", CPU,
                         dict(n_frames=16, mode="stream", window=4))]
        assert json.loads(capsys.readouterr().out) == {"metric": "pipeline_window"}
        for name in ("BENCH_CONFIG", "BENCH_FRAMES", "BENCH_MODE", "BENCH_WINDOW"):
            monkeypatch.delenv(name)
        bench.main(["--device", "cpu"])
        assert seen[-1] == ("", CPU, dict(n_frames=None, mode="scan", window=8))
        monkeypatch.undo()
        with pytest.raises(ValueError, match="BENCH_CONFIG"):
            bench.run_config("tracking_only", CPU)
        with pytest.raises(ValueError, match="BENCH_MODE"):
            bench.run_config("tracking", CPU, n_frames=3, mode="graph", seq=seq30)


def full_width_windows(package: str, cache_dir: str) -> None:
    """The bench's ``pipeline_window`` and ``pipeline_pipelined`` at its
    own size, one pass each, through the JAX package or the port."""
    from test_torch_mapping import make_cfgs

    from pyorbslam_tpu.slam import system as jsystem
    from pyorbslam_tpu.utils.metrics import ate_rmse

    from pyorbslam_tpu_torch.slam import system as tsystem

    class RigidSystem(jsystem.System):
        """The JAX ``System`` whose pose is made rigid wherever it is set."""

        @property
        def Tcw(self):
            return self._rigid_Tcw

        @Tcw.setter
        def Tcw(self, T):
            self._rigid_Tcw = tsystem._rigid(T)

    window = 8
    seq = generate_sequence(
        n_frames=bench.PIPELINE_FRAMES, width=bench.WIDTH, height=bench.HEIGHT,
        trajectory="straight", speed=0.8, seed=3, cache_dir=cache_dir)
    n = bench.PIPELINE_FRAMES - bench.PIPELINE_FRAMES % window
    jc, tc = make_cfgs(seq, n_features=bench.N_FEATURES)
    for pipelined in (False, True):
        if package != "port":
            make = RigidSystem if package == "jax-rigid" else jsystem.System
            sysm, where = make(jc), jax.default_backend()
        else:
            sysm, where = tsystem.System(tc, torch.device("cuda")), "cuda"
        t0 = time.perf_counter()
        for w0 in range(0, n, window):
            frames = (seq.left[w0: w0 + window], seq.right[w0: w0 + window],
                      seq.timestamps[w0: w0 + window])
            if pipelined:
                sysm.window_feed(*frames)
            else:
                sysm.track_stereo_window(*frames)
        if pipelined:
            sysm.window_flush()
        seconds = time.perf_counter() - t0
        est = np.linalg.inv(np.asarray(sysm.corrected_trajectory(), np.float64))
        print(json.dumps(dict(
            package=package, platform=where,
            config="pipeline_pipelined" if pipelined else "pipeline_window",
            frames=len(sysm.trajectory), window=window,
            ate_rmse_m=float(ate_rmse(est, seq.poses_wc[: len(est)])),
            n_keyframes=int(sysm.map.keyframes.n),
            events=dict(Counter(e for e in sysm.events if isinstance(e, str))),
            seconds=seconds)), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "jax-rigid", "port"), required=True)
    full_width_windows(ap.parse_args().package,
                       os.path.join(REPO, "tests", "_data"))
