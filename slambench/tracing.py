"""The traced stretches of a ``--trace 1`` run: ``torch.profiler`` over a
few calls, reduced to what the per-layer metrics and the breakdown read.

The first stretch records the device's activity alone, so the host issues
its launches at nearly the untraced pace: its kernels, launches, busy time
and window are what the metrics and ``device`` read.  Device busy time is
the union of the intervals in which any operation (kernel, copy, fill) ran
on the device, so overlapping streams count once.  The second stretch
records the host too (every operator and the benchmark's spans), which
slows each launch: it only names each idle stretch of the device by the
innermost benchmark span (``slambench.<layer>``) open on the host when it
began, for the breakdown.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

SPAN_PREFIX = "slambench."
WINDOW_SPAN = SPAN_PREFIX + "traced"
COPY_PREFIXES = ("Memcpy", "Memset")
TOP = 10


class Tracer:
    """Profile the calls made inside the ``with`` block: the device's
    activity, and with ``host`` (or without a CUDA device) the host's
    operators and spans as well."""

    def __init__(self, device, host: bool = False):
        self.device = torch.device(device)
        self.host = host or self.device.type != "cuda"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] if self.host else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.span = record_function(WINDOW_SPAN) if self.host else None
        if self.span is not None:
            self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self.t0
        if self.span is not None:
            self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def events(self):
        return self.prof.profiler.kineto_results.events()


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def innermost_segments(spans: List[Tuple[int, int, str]]):
    """Cut the host timeline into stretches with one innermost open span
    (spans of one thread nest): (starts, names), sorted by start."""
    marks = sorted([(a, 1, -a, n) for a, b, n in spans]
                   + [(b, 0, -a, n) for a, b, n in spans])
    stack: List[str] = []
    starts, names = [], []
    for t, opening, _, name in marks:
        if opening:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
        starts.append(t)
        names.append(stack[-1] if stack else "")
    return starts, names


def split(events):
    """(host spans, device operations) of a trace, each (start_ns, end_ns,
    name); the device side of a span is neither."""
    spans, device_ops = [], []
    for e in events:
        name = e.name()
        is_cuda = e.device_type() == torch.autograd.DeviceType.CUDA
        if name.startswith(SPAN_PREFIX):
            if not is_cuda:
                spans.append((e.start_ns(), e.end_ns(), name))
        elif is_cuda:
            device_ops.append((e.start_ns(), e.end_ns(), name))
    return spans, device_ops


def top(d: Dict[str, float]) -> list:
    return [[n[:160], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def device_summary(events, frames: int, window_s: float) -> dict:
    """A device-only stretch as numbers: frames traced, its wall window,
    the device's busy seconds in it, kernels by name (launches, seconds),
    launches, and the top device operations."""
    _, device_ops = split(events)
    kernels: Dict[str, List] = defaultdict(lambda: [0, 0.0])
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name in device_ops:
        dur = (b - a) * 1e-9
        by_name[name] += dur
        if not name.startswith(COPY_PREFIXES):
            kernels[name][0] += 1
            kernels[name][1] += dur
    busy_s = sum(b - a for a, b in union([(a, b) for a, b, _ in device_ops])) * 1e-9
    return dict(frames=frames, window_s=window_s, busy_s=busy_s,
                kernels={n: list(v) for n, v in kernels.items()},
                launches=sum(v[0] for v in kernels.values()), device_ops=top(by_name))


def idle_gaps(events) -> dict:
    """A stretch traced with the host: its window (the ``WINDOW_SPAN``)
    and the device's idle stretches in it, summed by the innermost span
    open on the host when each began ("harness" where none of the
    program's is)."""
    spans, device_ops = split(events)
    window = [(a, b) for a, b, n in spans if n == WINDOW_SPAN]
    if not window:
        return None
    w0, w1 = window[0]
    busy = union([(max(a, w0), min(b, w1)) for a, b, _ in device_ops if min(b, w1) > max(a, w0)])
    starts, names = innermost_segments(spans)
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        k = bisect.bisect_right(starts, g0) - 1
        name = names[k] if k >= 0 else ""
        label = name[len(SPAN_PREFIX):] if name and name != WINDOW_SPAN else "harness"
        idle[label] += (g1 - g0) * 1e-9
    return dict(window_s=(w1 - w0) * 1e-9, idle_gaps=top(idle))
