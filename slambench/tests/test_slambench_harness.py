"""CPU tests of the benchmark harness: the file's names and units, every
cell's files found by name, the metric readers on a canned record, the
frozen generator against the port's, and the imports of the folder."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

import harness  # noqa: E402
import tracing  # noqa: E402
import world  # noqa: E402

torch.set_num_threads(2)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "pyorbslam_tpu"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["slambench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]] \
        + [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]] \
        + [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for text in [c["source"] for c in bench["configs"]] + [w["why"] for w in bench["workloads"]] \
            + [m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"fps", "frame_latency_p90_ms", "setup_s"} <= e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline_pct") or m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("kind", ["configs", "traffic", "schedules", "limits", "metrics"])
def test_every_cell_finds_its_files(bench, kind):
    for w in bench["workloads"]:
        cell = harness.resolve_cell(bench, w["name"])
        if kind == "configs":
            assert os.path.exists(cell.settings_path)
            assert cell.entry["name"] == w["config"]
        elif kind == "traffic":
            assert cell.traffic["name"] == w["traffic"]
        elif kind == "schedules":
            mod = harness.load_module("schedules", cell.entry["schedule"])
            assert callable(mod.feed) and callable(mod.finish) and mod.SPANS
        elif kind == "limits":
            limits = harness.load_json("limits", w["name"] + ".json")
            assert set(limits) == {"frontend_bad_pct", "pose_ate_pct", "kf_ate_pct", "lm_gap_m"}
        else:
            for name in cell.metrics:
                assert callable(harness.load_module("metrics", name).read)


def test_config_files(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            entry = json.load(f)
        assert entry["source"] == c["source"]
        assert entry["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in entry


def canned_record(cfg, trace=True):
    kernels = {"fast_score_kernel(FastTable)": [8, 8 * 65e-6],
               "brief_canvas_kernel(float const*, int, int const*)": [8, 8 * 6e-6],
               "void at::native::elementwise_kernel<128>": [139_992, 3.2]}
    return dict(
        times={"async.dispatch": 30.0, "async.commit": 2.0, "kf.insert_total": 1.5,
               "kf.snapshot_read": 0.25, "kf.ba_dispatch": 1.0},
        times_frames=100, cfg=cfg,
        trace=dict(frames=8, window_s=4.0, busy_s=0.3, kernels=kernels,
                   launches=sum(v[0] for v in kernels.values()), device_ops=[], idle_gaps=[],
                   pace_ms=dict(untraced=375.0, device_traced=500.0, host_traced=650.0))
        if trace else None)


@pytest.mark.parametrize("name,expected", [
    ("dispatch_ms.live", 300.0),
    ("keyframe_ms.live", 25.0),
    ("launches_per_frame", 140_008 / 8),
    ("k1_roofline_pct", 100 * 0.013143385791044777e-3 / 65e-6),
    ("k2_roofline_pct", 100 * 0.0025039092537313436e-3 / 6e-6),
    ("device_idle_pct", 90.0),
])
def test_metric_readers(bench, name, expected):
    cell = harness.resolve_cell(bench, bench["workloads"][0]["name"])
    cfg = harness.slam_config(cell)
    mod = harness.load_module("metrics", name)
    assert mod.read(canned_record(cfg)) == pytest.approx(expected, rel=1e-9)
    empty = canned_record(cfg, trace=False)
    empty["times"], empty["times_frames"] = {}, 0
    assert mod.read(empty) is None


def test_generator_matches_the_port():
    from pyorbslam_tpu_torch.io import synthetic
    from pyorbslam_tpu_torch.io.render_torch import TorchRenderer
    np.testing.assert_array_equal(world.straight_trajectory(40, speed=0.8),
                                  synthetic.straight_trajectory(40, speed=0.8))
    for a, b in zip(world.corridor_scene(20.0, tex_px_per_m=30.0),
                    synthetic.corridor_scene(20.0, tex_px_per_m=30.0)):
        for key in ("p0", "n", "e1", "e2", "tex_scale", "ext1", "ext2"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    traffic = dict(trajectory="straight", scene="corridor", speed_m_per_frame=0.8,
                   yaw_amp=0.04, camera_hz=10.0)
    poses = world.route_poses(traffic, 12)
    planes = world.route_scene(traffic, poses)
    tex = world.make_texture(3, "cpu", 256)
    assert float(tex.min()) == 30.0 and float(tex.max()) == 230.0
    cam = world.Camera(fx=300.0, fy=300.0, cx=250.0, cy=75.0, width=512, height=160,
                       baseline=0.54)
    mine = world.Renderer(planes, tex)
    port = TorchRenderer(planes, tex.numpy(), "cpu")
    for Twc in poses[[0, 5, 11]]:
        np.testing.assert_array_equal(mine.render(Twc, cam).numpy(),
                                      port.render(Twc, cam.K, cam.width, cam.height))
    route = world.make_route(traffic, cam, 3, seed=3, device="cpu", tex_size=256)
    again = world.make_route(traffic, cam, 3, seed=3, device="cpu", tex_size=256)
    np.testing.assert_array_equal(route.left, again.left)
    np.testing.assert_array_equal(route.right, again.right)


class Event:
    """A profiler event as ``tracing`` reads one."""

    def __init__(self, a, b, name, cuda):
        self.a, self.b, self.n, self.cuda = a, b, name, cuda

    def name(self):
        return self.n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.cuda else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b


DEVICE_OPS = [Event(0, 10, "fast_score_kernel", True), Event(5, 20, "elementwise_kernel", True),
              Event(30, 40, "Memcpy HtoD", True),
              Event(25, 60, tracing.SPAN_PREFIX + "_dispatch_chain", True)]


def test_device_summary_takes_the_union():
    got = tracing.device_summary(DEVICE_OPS, frames=8, window_s=4e-7)
    assert got["busy_s"] == pytest.approx(30e-9)
    assert got["launches"] == 2 and got["window_s"] == 4e-7 and got["frames"] == 8
    assert got["kernels"]["fast_score_kernel"] == [1, pytest.approx(10e-9)]
    assert [n for n, _ in got["device_ops"]] == ["elementwise_kernel", "fast_score_kernel",
                                                 "Memcpy HtoD"]


def test_idle_gaps_are_named_by_the_open_span():
    host = [Event(0, 100, tracing.WINDOW_SPAN, False),
            Event(25, 60, tracing.SPAN_PREFIX + "_dispatch_chain", False)]
    got = tracing.idle_gaps(DEVICE_OPS + host)
    assert got["window_s"] == pytest.approx(100e-9)
    gaps = dict(got["idle_gaps"])
    assert gaps == {"_dispatch_chain": pytest.approx(60e-9), "harness": pytest.approx(10e-9)}
    assert tracing.idle_gaps(DEVICE_OPS) is None


@pytest.fixture(scope="module")
def small_route():
    traffic = dict(trajectory="straight", scene="corridor", speed_m_per_frame=0.8,
                   yaw_amp=0.04, camera_hz=10.0)
    cam = world.Camera(fx=300.0, fy=300.0, cx=250.0, cy=75.0, width=512, height=160,
                       baseline=0.54)
    return world.make_route(traffic, cam, 4, seed=5, device="cpu", tex_size=256)


def canned_session(route):
    """A session that gave back the route's own poses, three keyframes of
    two keypoints (no stereo) and a few landmarks."""
    n, kfs = len(route.poses_wc), np.array([0, 1, 2])
    return dict(poses=np.linalg.inv(route.poses_wc), n_handed=n, states=["OK"] * n,
                kf_Tcw=np.linalg.inv(route.poses_wc[kfs]), kf_frame=kfs,
                kf_xy=np.tile(np.array([[100.0, 80.0], [200.0, 60.0]], np.float32), (3, 1, 1)),
                kf_octave=np.zeros((3, 2), np.int32), kf_desc=np.zeros((3, 2, 8), np.int32),
                kf_valid=np.ones((3, 2), bool), kf_depth=-np.ones((3, 2), np.float32),
                lm_pos=route.poses_wc[:3, :3, 3] + np.array([0.0, 0.0, 5.0]))


def poison(ses, fault):
    if fault == "pose":
        ses["poses"][2, 0, 3] = np.nan
    elif fault == "kf_pose":
        ses["kf_Tcw"][1, 1, 3] = np.inf
    elif fault == "keypoint":
        ses["kf_xy"][1, 0, 0] = np.nan
    elif fault == "depth":
        ses["kf_depth"][2, 1] = np.nan
    elif fault == "landmark":
        ses["lm_pos"][0, 2] = np.nan
    return ses


@pytest.mark.parametrize("fault,number", [
    ("pose", "pose_ate_pct"), ("kf_pose", "kf_ate_pct"), ("keypoint", "frontend_bad_pct"),
    ("depth", "frontend_bad_pct"), ("landmark", "lm_gap_m")])
def test_check_reads_inf_on_a_broken_session(bench, small_route, fault, number):
    """A session that gave back a number that is not finite reads inf on
    what it feeds, beside a sound one, and ``correct`` is false."""
    from reference import check
    cell = harness.resolve_cell(bench, bench["workloads"][0]["name"])
    settings = check.read_settings(cell.settings_path)
    limits = {k: {"limit": 1e9} for k in ("frontend_bad_pct", "pose_ate_pct",
                                           "kf_ate_pct", "lm_gap_m")}
    sound = check.numbers([canned_session(small_route)], small_route, settings, 7, "cpu")
    assert np.isfinite(list(sound.values())).all()
    assert check.judge(sound, limits)[0]
    sessions = [canned_session(small_route), poison(canned_session(small_route), fault)]
    got = check.numbers(sessions, small_route, settings, 7, "cpu")
    assert got[number] == float("inf")
    assert not check.judge(got, limits)[0]


def test_check_counts_a_keypoint_off_its_level_as_bad(bench, small_route):
    from reference import check
    cell = harness.resolve_cell(bench, bench["workloads"][0]["name"])
    settings = check.read_settings(cell.settings_path)
    ses = canned_session(small_route)
    ses["kf_xy"][0, 0] = (5000.0, -40.0)
    ses["kf_octave"][0, 1] = 9
    assert check.frontend_bad(ses, 0, small_route, settings, "cpu") == (2, 2)
    assert np.isfinite(check.numbers([ses], small_route, settings, 7, "cpu")["frontend_bad_pct"])


def imports_of(path: str):
    """(top-level module names, relative imports) of one source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def sources(sub=""):
    top = os.path.join(BENCH_DIR, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_imports():
    for path in sources():
        found = imports_of(path) & FORBIDDEN
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        names = imports_of(path)
        assert "pyorbslam_tpu_torch" not in names and not names & FORBIDDEN, (path, names)
        assert names <= {"__future__", "os", "numpy", "torch"}, (path, names)


def test_nothing_loads_jax_in_a_run():
    """The harness, the port and the reference in one process load no JAX."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, harness, world, tracing, bounds, control\n"
        "from reference import check\n"
        "import pyorbslam_tpu_torch.slam.system\n"
        "print(run.forbidden_modules())\n" % (BENCH_DIR, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
