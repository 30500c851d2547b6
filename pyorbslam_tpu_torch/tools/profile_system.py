"""Where a frame of ``System.track_stereo`` goes on one NVIDIA GPU.

    python3 -m pyorbslam_tpu_torch.tools.profile_system [--frames 16] [--warm 8]
        [--pipelined | --window W] [--width 1241 --height 376] [--speed 0.8]

Runs the port's ``System`` (default configuration, loop closing on) over
the first frames of the 1241x376 / 2000-feature synthetic sequence that
``chip_smoke.py`` uses (another image size with ``--width`` /
``--height``; ``--speed`` metres a frame, 2.0 for a highway's pace), in
fresh ``System``s, after a warm-up pass of one more: a benchmark process
runs sessions back to back, so the programs replayed from CUDA graphs
have met their keys before; frames after ``--warm`` count.  With
``--pipelined`` every run goes through ``System.track_stereo_async``; with
``--window W`` through ``System.window_feed`` in windows of W frames (the
warm frames and the measured ones each end with ``window_flush``; a
``--warm`` that W divides keeps every window whole).

1. **Spans.**  A run with the program's span recorder
   (``utils/trace.py``) on: wall ms a frame, and its spans by name:
   calls, host ms a frame (a span's time holds the spans inside it) and
   the means of their counters; and for each program replayed from CUDA
   graphs (``frontend``: ``track.frontend``; ``step``: ``track.step``;
   ``snapshot``: ``track.prefetch``; ``maintenance``:
   ``kf.maintain_dispatch``; ``ba_solve``: ``ba.solve``) the share of its
   measured spans that replayed a graph (``graph`` = 1), and its capture
   spans in the warm frames and in the measured ones.
2. **Profiler.**  One more run with the recorder on and ``torch.profiler``
   recording the device's activity alone: launches, kernel time and busy
   time a frame (the union of the device's operation intervals, so
   overlapping streams count once), the idle share of the window (the
   profiler slows the host's launches, so it is an upper bound), the ten
   kernels with the most device time, and ``by_span``: each kernel put
   down to the innermost span open when its ``cudaLaunchKernel`` record
   was taken (matched by correlation id), each idle gap to the innermost
   span open when it began.

Prints the card's ``nvidia-smi`` name and power limit first and one JSON
object last.  It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import subprocess
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.slam import system
from pyorbslam_tpu_torch.utils import trace
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls

WIDTH, HEIGHT, N_FEATURES = 1241, 376, 2000
COPY_PREFIXES = ("Memcpy", "Memset")
OUTSIDE = "outside"        # no program span open
UNMATCHED = "unmatched"    # a kernel with no launch record in the trace


def make_run(n_frames: int, width: int = WIDTH, height: int = HEIGHT,
             speed: float = 0.8):
    seq = generate_sequence(n_frames=n_frames, width=width, height=height,
                            trajectory="straight", speed=speed, seed=3)
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=width, height=height, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=N_FEATURES))
    return seq, cfg


def new_system(cfg, device):
    return system.System(cfg, device, keyframe_capacity=256)


# ------------------------------------------------------------- attribution


def innermost(spans: List[Tuple[int, int, str]]):
    """Cut a host timeline of nesting spans (start_ns, end_ns, name) into
    stretches with one innermost open span: (starts, names), sorted by
    start; ``OUTSIDE`` where none is open."""
    marks = sorted([(a, 1, -b, i) for i, (a, b, _) in enumerate(spans)]
                   + [(b, 0, -a, i) for i, (a, b, _) in enumerate(spans)])
    stack: List[int] = []
    starts, names = [], []
    for t, opening, _, i in marks:
        if opening:
            stack.append(i)
        else:
            stack.remove(i)
        starts.append(t)
        names.append(spans[stack[-1]][2] if stack else OUTSIDE)
    return starts, names


def attribute(spans: List[Tuple[int, int, str]], launches: Dict[int, int],
              kernels: List[Tuple[int, int, int]],
              ops: List[Tuple[int, int]], window: Tuple[int, int]) -> dict:
    """Put the device's work and idle time down to the program's spans,
    all on one clock (ns): each kernel (start, end, correlation id) to the
    innermost span open at its launch record's time (``launches``:
    correlation id -> host ns), ``UNMATCHED`` without one; each stretch
    of ``window`` in which no operation of ``ops`` (start, end) ran to
    the innermost span open when it began.  Returns {name: {launches,
    device_s, idle_s}}."""
    starts, names = innermost(spans)

    def at(t):
        k = bisect.bisect_right(starts, t) - 1
        return names[k] if k >= 0 else OUTSIDE

    out: Dict[str, dict] = defaultdict(
        lambda: dict(launches=0, device_s=0.0, idle_s=0.0))
    for a, b, corr in kernels:
        t = launches.get(corr)
        row = out[at(t) if t is not None else UNMATCHED]
        row["launches"] += 1
        row["device_s"] += (b - a) * 1e-9
    w0, w1 = window
    edges = [w0]
    for a, b in union([(max(a, w0), min(b, w1)) for a, b in ops
                       if min(b, w1) > max(a, w0)]):
        edges += [a, b]
    edges.append(w1)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            out[at(g0)]["idle_s"] += (g1 - g0) * 1e-9
    return dict(out)


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def device_events(events):
    """A device-only trace's records: the launch records' host times by
    correlation id, the kernels (start, end, correlation id, name) and
    every device operation (start, end)."""
    launches, kernels, ops = {}, [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((e.start_ns(), e.end_ns()))
            if not e.name().startswith(COPY_PREFIXES):
                kernels.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                                e.name()))
        elif "Launch" in e.name():
            launches[e.correlation_id()] = e.start_ns()
    return launches, kernels, ops


# ------------------------------------------------------------------- runs


def drive(seq, cfg, device, warm: int, pipelined: bool,
          profiler: bool = False, window: int = 0) -> dict:
    """One fresh ``System`` over the sequence; the frames after ``warm``
    measured (with ``pipelined`` or ``window`` flushed inside the window,
    so every measured frame's work is in it)."""
    from torch.profiler import ProfilerActivity, profile

    sysm = new_system(cfg, device)
    n = seq.left.shape[0]

    def feed(lo: int, hi: int):
        """Frames ``lo`` to ``hi`` through the schedule, then the flush."""
        if window:
            for i in range(lo, hi, window):
                j = min(i + window, hi)
                sysm.window_feed(seq.left[i:j], seq.right[i:j], seq.timestamps[i:j])
            sysm.window_flush()
            return
        track = sysm.track_stereo_async if pipelined else sysm.track_stereo
        for i in range(lo, hi):
            track(seq.left[i], seq.right[i], seq.timestamps[i])
        sysm.flush_async()

    trace.drain()
    trace.enable()
    try:
        feed(0, warm)
        torch.cuda.synchronize()
    finally:
        trace.disable()
    kfs0 = sysm.map.keyframes.n
    warm_spans = trace.drain().spans
    with profile(activities=[ProfilerActivity.CUDA]) if profiler \
            else contextlib.nullcontext() as prof:
        trace.enable()
        try:
            w0, t0 = time.time_ns(), time.perf_counter()
            feed(warm, n)
            torch.cuda.synchronize()
            wall, w1 = time.perf_counter() - t0, time.time_ns()
        finally:
            trace.disable()
    frames = n - warm
    return dict(frames=frames, keyframes=sysm.map.keyframes.n - kfs0,
                ms_per_frame=1e3 * wall / frames, warm_spans=warm_spans,
                drained=trace.drain(), window=(w0, w1),
                events=prof.profiler.kineto_results.events() if prof else None)


def span_table(drained: trace.Drained, frames: int) -> dict:
    """By span name: calls and host ms a frame, and each counter's mean."""
    rows: Dict[str, dict] = {}
    for s in drained.spans:
        r = rows.setdefault(s.name, dict(calls=0, host_ms=0.0, args=defaultdict(list)))
        r["calls"] += 1
        r["host_ms"] += (s.t1_ns - s.t0_ns) * 1e-6
        for k, v in s.args.items():
            r["args"][k].append(v)
    return {name: dict(calls_per_frame=r["calls"] / frames,
                       host_ms_per_frame=r["host_ms"] / frames,
                       counters={k: sum(v) / len(v) for k, v in r["args"].items()})
            for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["host_ms"])}


# the device programs replayed from CUDA graphs: (span, capture span)
GRAPHED = dict(frontend=("track.frontend", "track.frontend_capture"),
               step=("track.step", "track.step_capture"),
               snapshot=("track.prefetch", "track.snapshot_capture"),
               maintenance=("kf.maintain_dispatch", "kf.maintain_capture"),
               ba_solve=("ba.solve", "ba.solve_capture"))


def graph_summary(warm_spans: List[trace.Span], spans: List[trace.Span],
                  name: str, capture: str) -> dict:
    """How often a program replayed its CUDA graph: the measured spans
    called ``name``, the share of them with ``graph`` = 1 (None without
    one), and the ``capture`` spans of the warm frames and of the
    measured ones."""
    graph = [s.args.get("graph", 0) for s in spans if s.name == name]

    def captures(of):
        return sum(s.name == capture for s in of)

    return dict(spans=len(graph),
                graph_share=sum(graph) / len(graph) if graph else None,
                captures_warm=captures(warm_spans), captures_measured=captures(spans))


def profiled(run: dict, top_n: int = 10) -> dict:
    """The profiled run's numbers, a frame."""
    frames = run["frames"]
    launches, kernels, ops = device_events(run["events"])
    if not ops:
        raise RuntimeError("torch.profiler recorded no device event")
    w0, w1 = run["window"]
    busy_s = sum(b - a for a, b in union(
        [(max(a, w0), min(b, w1)) for a, b in ops if min(b, w1) > max(a, w0)])) * 1e-9
    window_s = (w1 - w0) * 1e-9
    spans = [(s.t0_ns, s.t1_ns, s.name) for s in run["drained"].epoch_spans()]
    by = attribute(spans, launches, [(a, b, c) for a, b, c, _ in kernels], ops,
                   run["window"])
    by_name: Dict[str, List] = defaultdict(lambda: [0, 0.0])
    for a, b, _, name in kernels:
        by_name[name][0] += 1
        by_name[name][1] += (b - a) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    return dict(
        frames=frames, wall_ms_per_frame=run["ms_per_frame"],
        launches_per_frame=len(kernels) / frames,
        kernel_ms_per_frame=1e3 * sum(v[1] for v in by_name.values()) / frames,
        busy_ms_per_frame=1e3 * busy_s / frames,
        idle_share=1.0 - busy_s / window_s,
        launch_records=len(launches),
        by_span={name: dict(launches_per_frame=r["launches"] / frames,
                            device_ms_per_frame=1e3 * r["device_s"] / frames,
                            idle_ms_per_frame=1e3 * r["idle_s"] / frames)
                 for name, r in sorted(by.items(), key=lambda kv: -kv[1]["idle_s"])},
        sums=dict(launches=sum(r["launches"] for r in by.values()),
                  kernels=len(kernels),
                  idle_s=sum(r["idle_s"] for r in by.values()),
                  window_minus_busy_s=window_s - busy_s),
        top_kernels=[dict(name=n[:80], launches_per_frame=v[0] / frames,
                          ms_per_frame=1e3 * v[1] / frames) for n, v in top])


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--warm", type=int, default=8)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--pipelined", action="store_true",
                      help="run System.track_stereo_async instead of track_stereo")
    mode.add_argument("--window", type=int, default=0, metavar="W",
                      help="run System.window_feed in windows of W frames")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--speed", type=float, default=0.8,
                    help="metres a frame along the route")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_system needs a CUDA device; none is available")
    if not 0 < args.warm < args.frames:
        raise SystemExit("--warm must lie inside --frames")
    device = torch.device("cuda", 0)
    use_f32_matmuls()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    seq, cfg = make_run(args.frames, args.width, args.height, args.speed)
    t0 = time.perf_counter()
    drive(seq, cfg, device, args.warm, args.pipelined, window=args.window)
    print(f"warm-up pass: {time.perf_counter() - t0:.1f} s", flush=True)
    run = drive(seq, cfg, device, args.warm, args.pipelined, window=args.window)
    spans = span_table(run["drained"], run["frames"])
    schedule = (f" (windows of {args.window})" if args.window else
                " (pipelined schedule)" if args.pipelined else "")
    print(f"recorder on, frames {args.warm}-{args.frames - 1}{schedule} at "
          f"{args.width}x{args.height}, {args.speed} m a frame: "
          f"{run['ms_per_frame']:.1f} ms/frame", flush=True)
    graphs = {}
    for program, (name, capture) in GRAPHED.items():
        g = graphs[program] = graph_summary(run["warm_spans"], run["drained"].spans,
                                            name, capture)
        print(f"{program}: {g['spans']} {name} spans measured, graph replayed "
              f"in a share of {g['graph_share']}; captures: {g['captures_warm']} "
              f"warm, {g['captures_measured']} measured", flush=True)
    prof = profiled(drive(seq, cfg, device, args.warm, args.pipelined,
                          profiler=True, window=args.window))
    print(f"profiler (device only, recorder on): {prof['launches_per_frame']:.0f} "
          f"launches/frame, {prof['kernel_ms_per_frame']:.2f} ms kernel time/frame, "
          f"busy {prof['busy_ms_per_frame']:.2f} ms of {prof['wall_ms_per_frame']:.1f} "
          f"ms/frame, idle share {prof['idle_share']:.4f}", flush=True)
    print(f"{'span':24s} {'calls/f':>8s} {'host ms/f':>10s} {'launch/f':>9s} "
          f"{'dev ms/f':>9s} {'idle ms/f':>10s}  counters", flush=True)
    for name in list(dict.fromkeys(list(prof["by_span"]) + list(spans))):
        h, d = spans.get(name, {}), prof["by_span"].get(name, {})
        counters = " ".join(f"{k}={v:.1f}" for k, v in h.get("counters", {}).items())
        print(f"{name:24s} {h.get('calls_per_frame', 0):8.2f} "
              f"{h.get('host_ms_per_frame', 0):10.2f} "
              f"{d.get('launches_per_frame', 0):9.1f} "
              f"{d.get('device_ms_per_frame', 0):9.3f} "
              f"{d.get('idle_ms_per_frame', 0):10.2f}  {counters}", flush=True)
    for k in prof["top_kernels"]:
        print(f"  {k['ms_per_frame']:.3f} ms/frame  {k['launches_per_frame']:.0f}x  "
              f"{k['name']}", flush=True)
    print(json.dumps(dict(card=smi, device=torch.cuda.get_device_name(0),
                          pipelined=args.pipelined, window=args.window,
                          size=[args.width, args.height], speed=args.speed,
                          ms_per_frame=run["ms_per_frame"], spans=spans,
                          **graphs,
                          frameless_spans=sum(s.frame < 0 for s in run["drained"].spans),
                          profiler=prof)))


if __name__ == "__main__":
    main()
