"""One run of one cell: set-up, the measured window of back-to-back drive
sessions, the session left in progress finished, the record.

Everything that belongs to one configuration, traffic mix, schedule or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``configs/<config>.json`` (+ the settings YAML it names),
* ``traffic/<traffic>.json``,
* ``schedules/<schedule>.py`` (``feed``, ``finish``, ``SPANS``),
* ``metrics/<metric>.py`` (``read(record)``),
* ``limits/<cell>.json`` (the limits of the correctness check).

The program is reached only through ``pyorbslam_tpu_torch.SlamConfig``,
``place.vocabulary.load_default`` and ``slam.system.System``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import tracing
import world

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The traced stretches start here in the first session: TRACE_FROM_FRAME
# frames, the device's activity alone (the metrics), then NAMED_FRAMES
# with the host's too (the idle stretches' names).  A traced run's
# program-span metrics come from the calls before them: the profiler's
# hooks may stay on the launch path after it stops.
TRACE_FROM_FRAME = 40
TRACE_MIN_FRAMES = 8
NAMED_FRAMES = 8
PACE_FROM_FRAME = 8     # the untraced pace: frames 8 to 40 of that session


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots and dashes)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"slambench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload entry with its configuration and traffic resolved."""

    name: str
    entry: dict          # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    metrics: List[str]   # per-layer metric names that apply to the cell

    @property
    def settings_path(self) -> str:
        return os.path.join(HERE, "configs", self.entry["settings"])


def resolve_cell(bench: dict, workload: str) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        entry = json.load(f)
    traffic = load_json("traffic", w["traffic"] + ".json")
    metrics = [m["name"] for m in bench["per_layer"]
               if workload in m.get("workloads", cells)]
    return Cell(name=workload, entry=entry, traffic=traffic, metrics=metrics)


def slam_config(cell: Cell, overrides: Optional[dict] = None):
    """The configuration as it is run: the settings YAML through the
    port's ``SlamConfig.from_yaml``.  ``overrides`` (tests only) replace
    camera / ORB fields to run the harness at a small size."""
    from pyorbslam_tpu_torch import SlamConfig
    cfg = SlamConfig.from_yaml(cell.settings_path)
    if overrides:
        cfg = dataclasses.replace(
            cfg,
            camera=dataclasses.replace(cfg.camera, **overrides.get("camera", {})),
            orb=dataclasses.replace(cfg.orb, **overrides.get("orb", {})))
    return cfg


def camera_of(cfg) -> world.Camera:
    c = cfg.camera
    return world.Camera(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width,
                        height=c.height, baseline=c.bf / c.fx)


@dataclasses.dataclass
class Frame:
    """One frame handed in: when, whether inside the window, when its
    pose came back."""

    session: int
    index: int
    handed: float
    in_window: bool
    returned: Optional[float] = None


def capture(system, n_handed: int, states: List[str]) -> dict:
    """What the correctness check reads of a finished session, as host
    arrays: the poses it gave back (Tcw, one a frame), its keyframes
    after local BA with their features, its live landmarks."""
    ks, lm = system.map.keyframes, system.map.landmarks
    alive = np.nonzero(ks.alive[: ks.n])[0]
    poses = np.stack(system.trajectory) if system.trajectory else np.zeros((0, 4, 4))
    return dict(
        poses=poses.astype(np.float64), n_handed=n_handed, states=states,
        kf_Tcw=ks.Tcw[alive].astype(np.float64), kf_frame=ks.frame_id[alive].copy(),
        kf_xy=ks.kp_xy[alive].copy(), kf_octave=ks.kp_octave[alive].copy(),
        kf_desc=ks.kp_desc[alive].copy(), kf_valid=ks.kp_valid[alive].copy(),
        kf_depth=ks.depth[alive].copy(),
        lm_pos=lm.pos[: lm.n][lm.alive[: lm.n]].astype(np.float64),
        n_keyframes_made=int(ks.n),
        events=[e for e in system.events if isinstance(e, str)],
        counters=dict(system.map.counters),
    )


@contextlib.contextmanager
def spans(system, names):
    """Wrap the named System (and ``map.``) methods of this instance in
    ``record_function`` spans; restore them on exit."""
    from torch.profiler import record_function
    undo = []
    for name in names:
        owner, attr = (system.map, name[4:]) if name.startswith("map.") else (system, name)
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _label="slambench." + name, **k):
            with record_function(_label):
                return _fn(*a, **k)

        setattr(owner, attr, functools.wraps(fn)(wrapped))
        undo.append((owner, attr))
    try:
        yield
    finally:
        for owner, attr in undo:
            delattr(owner, attr)


def drive(cell: Cell, make_system: Callable, route: world.Route, schedule,
          seconds: float, traced: bool, device) -> dict:
    """Drive sessions back to back for ``seconds``; finish the session in
    progress at the close (at least one session: ``seconds`` 0 drives one
    session outside any window, the warm-up).  Returns the frames, the
    sessions' captures, the program's stage clocks over the window's
    calls (in a traced run, those before the traced stretches), and the
    trace, reduced once the window has closed."""
    n = len(route.timestamps)
    frames: List[Frame] = []
    sessions: List[dict] = []
    times: Dict[str, float] = defaultdict(float)
    times_frames = 0
    tracer = named = None
    trace_frames = named_frames = 0
    pace = None
    t_end = time.perf_counter() + seconds
    while not sessions or time.perf_counter() < t_end:
        s = len(sessions)
        system = make_system()
        mine: List[Frame] = []
        states: List[str] = []
        i = 0

        def call(fn, first: int, k: int):
            """One call into the program: ``k`` frames from ``first``
            handed in, the poses it gives back stamped."""
            nonlocal times_frames
            before = dict(system.times)
            t_hand = time.perf_counter()
            for j in range(first, first + k):
                mine.append(Frame(s, j, t_hand, t_hand < t_end))
            fn()
            t_ret = time.perf_counter()
            have = len(system.trajectory)
            for f in mine[len(states):have]:
                f.returned = t_ret
            states.extend([system.state] * max(0, have - len(states)))
            if t_hand < t_end and tracer is None:
                for key, v in system.times.items():
                    times[key] += v - before.get(key, 0.0)
                times_frames += k

        def feed(i):
            k = min(cell.entry.get("window", 1), n - i)
            call(functools.partial(schedule.feed, system, route, i, cell.entry), i, k)
            return i + k

        while i < n:
            if traced and tracer is None and s == 0 and i >= TRACE_FROM_FRAME \
                    and time.perf_counter() < t_end:
                pace = (time.perf_counter() - mine[PACE_FROM_FRAME].handed) \
                    / (i - PACE_FROM_FRAME)
                with tracing.Tracer(device) as tracer:
                    while trace_frames < TRACE_MIN_FRAMES and i < n:
                        i0, i = i, feed(i)
                        trace_frames += i - i0
                with tracing.Tracer(device, host=True) as named, spans(system, schedule.SPANS):
                    while named_frames < NAMED_FRAMES and i < n:
                        i0, i = i, feed(i)
                        named_frames += i - i0
                continue
            i = feed(i)
        call(functools.partial(schedule.finish, system), n, 0)
        call(system.shutdown, n, 0)
        sessions.append(capture(system, n, states))
        frames.extend(mine)
        del system
    trace = None
    if tracer is not None:
        trace = tracing.device_summary(tracer.events(), trace_frames, tracer.wall_s)
        gaps = tracing.idle_gaps(named.events()) if named_frames else None
        trace.update(idle_gaps=gaps["idle_gaps"] if gaps else [],
                     pace_ms=dict(untraced=pace * 1e3,
                                  device_traced=1e3 * tracer.wall_s / trace_frames,
                                  host_traced=1e3 * gaps["window_s"] / named_frames
                                  if gaps else None))
    return dict(frames=frames, sessions=sessions, t_end=t_end, times=dict(times),
                times_frames=times_frames, trace=trace)


def window_metrics(frames: List[Frame], seconds: float, t_end: float) -> dict:
    """fps over the whole window; p90 latency over every frame handed in
    inside it (a frame whose pose came after the close still counts with
    its whole wait)."""
    handed = [f for f in frames if f.in_window]
    done = [f for f in handed if f.returned is not None and f.returned <= t_end]
    lat = np.array([f.returned - f.handed for f in handed if f.returned is not None])
    return dict(
        fps=len(done) / seconds,
        frame_latency_p90_ms=float(np.percentile(lat, 90)) * 1e3 if len(lat) else None,
        frames_done=len(done), frames_handed=len(handed),
        latency_median_ms=float(np.median(lat)) * 1e3 if len(lat) else None,
    )


def failed_frames(frames: List[Frame], sessions: List[dict]) -> int:
    """Frames handed in inside the window with no pose, a non-finite pose,
    or a lost state after the call that gave it."""
    bad = 0
    for f in frames:
        if not f.in_window:
            continue
        ses = sessions[f.session]
        if f.index >= len(ses["poses"]):
            bad += 1
            continue
        if not np.isfinite(ses["poses"][f.index]).all() \
                or ses["states"][f.index] not in ("OK", "MARGINAL"):
            bad += 1
    return bad


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        overrides: Optional[dict] = None, session_frames: Optional[int] = None,
        tex_size: int = world.TEX_SIZE, on_system: Optional[Callable] = None,
        program_cfg: Optional[Callable] = None) -> dict:
    """Set-up, window and the finished sessions of one run.  The keyword
    arguments past ``device`` are for tests and the control:
    ``overrides`` and ``session_frames`` shrink the run, ``on_system``
    sees every System made (a fault planted by a test), ``program_cfg``
    maps the configuration the program is given (the route is rendered
    with the one the settings state)."""
    device = torch.device(device)
    t0 = time.perf_counter()
    from pyorbslam_tpu_torch.place.vocabulary import load_default
    from pyorbslam_tpu_torch.slam.system import System

    cfg = slam_config(cell, overrides)
    voc = load_default()
    n = session_frames or cell.entry["session_frames"]
    route = world.make_route(cell.traffic, camera_of(cfg), n, seed, device, tex_size)
    schedule = load_module("schedules", cell.entry["schedule"])

    run_cfg = program_cfg(cfg) if program_cfg else cfg

    def make_system():
        system = System(run_cfg, device, vocabulary=voc)
        if on_system is not None:
            on_system(system)
        return system

    if device.type == "cuda":
        # the peak is the program's, from its warm-up on: not the texture's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    warm = cell.entry["warm_frames"]
    drive(cell, make_system,
          route._replace(left=route.left[:warm], right=route.right[:warm],
                         timestamps=route.timestamps[:warm]),
          schedule, 0.0, False, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    setup_s = time.perf_counter() - t0

    out = drive(cell, make_system, route, schedule, seconds, traced, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    win = window_metrics(out["frames"], seconds, out["t_end"])
    record = dict(cfg=run_cfg, times=out["times"], times_frames=out["times_frames"],
                  trace=out["trace"])
    return dict(setup_s=setup_s, window=win, sessions=out["sessions"],
                failed=failed_frames(out["frames"], out["sessions"]),
                record=record, peak=peak, route=route)
