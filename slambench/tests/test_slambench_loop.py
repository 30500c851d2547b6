"""CPU tests of the loop route and of what a loop cell reads: the straight
routes as they were before route shapes were found by name, the loop
route and its frames against the port's generator and renderer, the
faces' texture origins (no two faces sample overlapping rectangles, an
unbounded plane carries none, an origin shifts what a face shows and not
its outline), the distance to a bounded face, ``false_loops`` on
hand-made sessions, the ``loop_ms.live`` reader, and a small loop
session through ``run.measure`` that closes its loop and corrects no
false one, beside one whose program closes none.  The loop cell
(``kitti00-02.live`` under ``traffic/loop.json``) is made here from its
files, whether ``BENCHMARK.json`` lists it or not, and so is the one
limit these tests compare: the cell's limits file waits for sound
readings of the other four numbers."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

import harness  # noqa: E402
import run  # noqa: E402
import world  # noqa: E402
from reference import check, geometry  # noqa: E402

torch.set_num_threads(2)

CELL = "kitti00-02.live.loop"
SEED = 3_000_000_021
FX = 0.58 * 512
SMALL = dict(overrides=dict(camera=dict(width=512, height=160, fx=FX, fy=FX, cx=256.0,
                                        cy=70.0, bf=FX * 0.54),
                            orb=dict(n_features=1000)),
             session_frames=92, tex_size=2048)
# every session of the loop traffic drives back past its start
LIMITS = {"open_loop_sessions": {"limit": 0}}

# sha256 of each straight route (frames, poses, timestamps, planes) at a
# 160x48 camera, a 256-px texture, 66 frames and seed 4_000_000_007,
# recorded before route shapes were found by name
STRAIGHT_ROUTES = {
    "kitti00-02.live.cruise": "c6ed40862c204b379397b661d7c1c49a8890825999214e5ed1efb9fd507dd0be",
    "kitti00-02.live.highway": "937c024ba6409003725babaee9f5e47993afa24aeca4f6364484530cdbcd024e",
    "kitti04-12.offline-pipelined.cruise":
        "c6ed40862c204b379397b661d7c1c49a8890825999214e5ed1efb9fd507dd0be",
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def loop_cell() -> harness.Cell:
    return harness.Cell(name=CELL, entry=harness.load_json("configs", "kitti00-02.live.json"),
                        traffic=harness.load_json("traffic", "loop.json"),
                        metrics=["loop_ms.live"])


def route_hash(route) -> str:
    h = hashlib.sha256()
    for a in (route.left, route.right, route.poses_wc, route.timestamps):
        h.update(np.ascontiguousarray(a).tobytes())
    for p in route.planes:
        for key in ("p0", "n", "e1", "e2", "tex_scale", "ext1", "ext2"):
            h.update(np.asarray(getattr(p, key), np.float64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell_name", sorted(STRAIGHT_ROUTES))
def test_straight_routes_unchanged(bench, cell_name):
    cell = harness.resolve_cell(bench, cell_name)
    assert "session_frames" not in cell.traffic and "trace_session" not in cell.traffic
    cam = world.Camera(fx=92.8, fy=92.8, cx=80.0, cy=22.0, width=160, height=48,
                       baseline=0.54)
    route = world.make_route(cell.traffic, cam, 66, 4_000_000_007, "cpu", 256)
    assert route_hash(route) == STRAIGHT_ROUTES[cell_name]


def test_loop_route_matches_the_port():
    from pyorbslam_tpu_torch.io import synthetic
    t = loop_cell().traffic
    route = world.route_module("loop")
    np.testing.assert_array_equal(route.loop_trajectory(50, radius=25.0, laps=1.3),
                                  synthetic.loop_trajectory(50, radius=25.0, laps=1.3))
    n = t["session_frames"]
    poses = world.route_poses(t, n)
    np.testing.assert_array_equal(
        poses, synthetic.loop_trajectory(n, radius=t["loop_radius_m"], laps=t["laps"]))
    planes = world.route_scene(t, poses)
    port = synthetic.interior_loop_scene(t["loop_radius_m"],
                                         tex_px_per_m=4096.0 / (4.0 * t["loop_radius_m"] + 16.0),
                                         seed=t["layout_seed"])
    assert len(planes) == len(port) == 1 + 2 * 16 * 4
    for a, b in zip(planes, port):
        for key in ("p0", "n", "e1", "e2", "tex_scale", "ext1", "ext2"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    # 0.8 m a frame, as the traffic states
    step = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    assert step.mean() == pytest.approx(t["speed_m_per_frame"], abs=0.01)


def test_batched_render_equals_view_by_view():
    """``render_many``'s batches on the pillar world (bounded faces): bit
    for bit the port's renderer, view by view.  The port's planes have no
    texture origin, so both render the faces without theirs."""
    from pyorbslam_tpu_torch.io.render_torch import TorchRenderer
    t = loop_cell().traffic
    poses = world.route_poses(t, 40)
    planes = [dataclasses.replace(p, tex_origin=(0.0, 0.0))
              for p in world.route_scene(t, poses)]
    tex = world.make_texture(3, "cpu", 256)
    cam = world.Camera(fx=148.5, fy=148.5, cx=128.0, cy=35.0, width=256, height=80,
                       baseline=0.54)
    port = TorchRenderer(planes, tex.numpy(), "cpu")
    views = poses[[0, 9, 17, 31, 39]]
    got = world.Renderer(planes, tex).render_many(views, cam, batch=3).numpy()
    for Twc, view in zip(views, got):
        np.testing.assert_array_equal(view, port.render(Twc, cam.K, cam.width, cam.height))


def test_no_two_faces_sample_overlapping_texture():
    """Each pillar face's rectangle of the texture, origin ± ext ×
    tex_scale on each axis in level-0 pixels modulo the texture's size,
    overlaps no other face's."""
    t = loop_cell().traffic
    faces = world.route_scene(t, world.route_poses(t, t["session_frames"]))[1:]
    assert len(faces) == 2 * 16 * 4
    centre = np.array([f.tex_origin for f in faces], np.float64)
    half = np.array([[f.ext1 * f.tex_scale, f.ext2 * f.tex_scale] for f in faces])
    assert np.isfinite(half).all()
    d = np.abs(centre[:, None] - centre[None]) % world.TEX_SIZE
    d = np.minimum(d, world.TEX_SIZE - d)
    overlap = (d < half[:, None] + half[None]).all(axis=2)
    np.fill_diagonal(overlap, False)
    assert not overlap.any(), np.argwhere(overlap)[:5]


def test_unbounded_planes_carry_no_origin(bench):
    """The loop's ground and the straight routes' corridor planes keep
    texture origin (0, 0), so they render as before."""
    t = loop_cell().traffic
    ground = world.route_scene(t, world.route_poses(t, 10))[0]
    assert np.isinf(ground.ext1) and ground.tex_origin == (0.0, 0.0)
    for name in STRAIGHT_ROUTES:
        traffic = harness.resolve_cell(bench, name).traffic
        planes = world.route_scene(traffic, world.route_poses(traffic, 66))
        assert [p.tex_origin for p in planes] == [(0.0, 0.0)] * len(planes)


def test_texture_origin_shifts_what_a_face_shows():
    """A face with origin (o1, o2) shows, inside the same outline, what the
    face without one shows on the texture rolled by (-o2, -o1): to
    rounding, where the face is sampled at level 0."""
    tex = world.make_texture(5, "cpu", 256)
    face = world.Plane(np.array([0.0, 0.0, 4.0]), np.array([0.0, 0.0, -1.0]),
                       np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]), 20.0,
                       ext1=1.0, ext2=0.6)
    cam = world.Camera(fx=148.5, fy=148.5, cx=64.0, cy=40.0, width=128, height=80,
                       baseline=0.54)
    view = np.eye(4)[None]
    plain = world.Renderer([face], tex).render_many(view, cam)[0].int()
    shifted = world.Renderer([dataclasses.replace(face, tex_origin=(37.0, 101.0))],
                             tex).render_many(view, cam)[0].int()
    rolled = world.Renderer([face], torch.roll(tex, shifts=(-101, -37), dims=(0, 1))) \
        .render_many(view, cam)[0].int()
    assert (shifted - rolled).abs().max() <= 1
    # the outline, from the face on a blank texture: the background is 90
    outline = world.Renderer([face], torch.full_like(tex, 200.0)).render_many(view, cam)[0] != 90
    assert 0.1 < outline.float().mean() < 0.9
    assert (shifted[~outline] == 90).all()
    assert (shifted != plain)[outline].float().mean() > 0.5


def test_false_loops():
    """A correction between frames 40 m apart is false, one 2 m apart is
    not, and a session with no correction has none."""
    poses = np.tile(np.eye(4), (50, 1, 1))
    poses[:, 2, 3] = np.arange(50, dtype=np.float64)      # 1 m a frame
    assert check.false_loops(dict(loop_pairs=[(45, 5)]), poses) == 1
    assert check.false_loops(dict(loop_pairs=[(45, 43)]), poses) == 0
    assert check.false_loops(dict(loop_pairs=[(45, 5), (45, 43), (49, 1)]), poses) == 2
    assert check.false_loops(dict(loop_pairs=[]), poses) == 0
    assert check.false_loops({}, poses) == 0


def test_surface_distance_on_bounded_and_unbounded_planes():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-30.0, 30.0, (200, 3))
    corridor = world.corridor_scene(20.0, tex_px_per_m=30.0)
    before = np.stack([np.abs((pts - pl.p0) @ pl.n) for pl in corridor], axis=1).min(axis=1)
    np.testing.assert_array_equal(geometry.surface_distance(corridor, pts), before)
    # a pillar face at x = 1, 2 m wide (z in [-1, 1]) and 4 m tall (y in [-2, 2])
    face = world.Plane(np.array([1.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]),
                       np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0]), 48.0,
                       ext1=1.0, ext2=2.0)
    probe = np.array([[1.0, 0.0, 4.0],      # in the face's plane, 3 m past its edge
                      [1.5, 0.0, 0.5],      # in front of the face
                      [1.3, 2.4, -1.4]])    # past both edges and in front
    np.testing.assert_allclose(geometry.surface_distance([face], probe),
                               [3.0, 0.5, np.sqrt(0.09 + 0.16 + 0.16)], rtol=1e-12)


def test_loop_ms_reader():
    read = harness.load_module("metrics", "loop_ms.live").read
    record = dict(times={"kf.loop": 3.0, "kf.gba_slice": 0.5, "kf.local_ba": 9.0,
                         "async.dispatch": 4.0}, times_frames=200, cfg=None, trace=None)
    assert read(record) == pytest.approx(17.5, rel=1e-12)
    assert read(dict(record, times={"kf.loop": 0.25})) == pytest.approx(1.25, rel=1e-12)
    assert read(dict(record, times={"async.dispatch": 4.0})) is None
    assert read(dict(record, times={}, times_frames=0)) is None


def test_the_loop_traffic():
    """The session is the traffic's, longer than the configuration's, and
    traced from the second session on, so that the program clocks hold
    the first session whole."""
    t = loop_cell().traffic
    assert t["trajectory"] == "loop" and t["scene"] == "interior"
    assert t["session_frames"] > loop_cell().entry["session_frames"]
    assert t["trace_session"] == 1
    # 1.15 laps at 0.8 m a frame
    arc = 2 * np.pi * t["loop_radius_m"] * t["laps"]
    assert arc / t["session_frames"] == pytest.approx(t["speed_m_per_frame"], abs=0.01)


def no_loop_closer(system):
    """A program that closes no loop: the System makes no loop closer."""
    system.enable_loop_closing = False


@pytest.fixture(scope="module")
def rendered_once():
    """``world.make_route`` rendering each route once for this module's
    runs (the pillar world takes about a minute a route on the CPU)."""
    real, memo = world.make_route, {}

    def make_route(traffic, camera, n_frames, seed, device, tex_size=world.TEX_SIZE):
        key = (json.dumps(traffic, sort_keys=True), camera, n_frames, seed, str(device), tex_size)
        if key not in memo:
            memo[key] = real(traffic, camera, n_frames, seed, device, tex_size)
        return memo[key]

    world.make_route = make_route
    yield
    world.make_route = real


def small_run(monkeypatch, **kwargs):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    real = harness.load_json
    monkeypatch.setattr(harness, "load_json", lambda *parts: LIMITS
                        if parts == ("limits", CELL + ".json") else real(*parts))
    cell = loop_cell()
    cell.entry = dict(cell.entry, warm_frames=6)
    # the loop route at the radius where this size closes its loop: 1.15
    # laps of 18 m in 92 frames
    cell.traffic = dict(cell.traffic, loop_radius_m=18.0)
    line, err = run.measure(bench, cell, SEED, 1e-3, False, torch.device("cpu"),
                            **SMALL, **kwargs)
    side = json.loads(err[0][len("slambench: "):])
    return line, side


@pytest.mark.parametrize("closer", ["sound", "none"])
def test_every_session_closes_its_loop(rendered_once, monkeypatch, closer):
    line, side = small_run(monkeypatch, **({"on_system": no_loop_closer} if closer == "none" else {}))
    got = line["checks"]["open_loop_sessions"]
    assert got["limit"] == 0
    if closer == "sound":
        assert side["loops"][0][0] >= 1
        assert got["value"] == 0
        assert side["values"]["false_loops"] == 0 and side["false_loops"] == [0]
    else:
        assert side["loops"] == [[0, 0, 0]] * side["sessions"]
        assert got["value"] == side["sessions"] == 1
        assert line["correct"] is False
