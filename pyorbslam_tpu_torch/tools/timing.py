"""Three clocks for a kernel on the card, all from CUDA events.

``time_ms`` holds one call between two events; ``time_stream_ms`` times a
stream of calls as the host enqueues them; ``time_graph_ms`` replays the
calls from a CUDA graph, with the host out of the way.  They need a CUDA
device.
"""

from __future__ import annotations

import numpy as np
import torch

TIMING_REPS = 25


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of one call, CUDA events around each call,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_stream_ms(fn, n: int = 200) -> float:
    """Device time per call of ``fn`` in a stream of calls: two CUDA events
    around ``n`` back-to-back calls on the current stream, after a warm-up
    batch; the median of 5 such batches over ``n``.  Unlike
    :func:`time_ms` it does not hold one small launch between two events,
    so it resolves kernels below the ~0.04 ms that a single bracketed
    launch reads; where the host enqueues slower than the card runs, it
    reads the enqueue rate."""
    for _ in range(max(2, n // 10)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def time_graph_ms(fn, n: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn`` with the host out of the way: ``n``
    calls are captured into one CUDA graph (outputs come from the graph's
    own pool), and two events bracket ``replays`` replays; the median of 5
    such measurements over ``n * replays``.  This is the card's time for
    the launch itself when launches follow each other without a gap."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (n * replays))
    return float(np.median(times))
