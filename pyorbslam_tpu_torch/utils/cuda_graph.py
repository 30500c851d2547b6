"""Device programs replayed from CUDA graphs, one per key.

A device program such as the frame's tracking step, the keyframe
snapshot, the maintenance step or the dense local-BA solve is hundreds to
thousands of small launches, and the host's time to enqueue them sets
the pace.  :class:`GraphedProgram` runs such a program's body on a CUDA
device as a graph: a key's first call runs the body eagerly, which fills
the device constants it reads and warms the allocator; its second call
captures the body on static copies of its inputs, then replays it; every
later call copies its inputs into those copies and replays.  A key met
once holds no graph.  CPU tensors always take the eager body.  The same
kernels run with the same launch parameters, so a replay is bit-equal to
the eager body.

The body takes its inputs as positional tensors and returns one tensor.
It may read other tensors only if they live as long as the process
(``device_constant`` tables), and it may neither read back nor upload.
A key is the device, each input's shape and dtype, and the caller's
``settings``: whatever else fixes the body's work (iteration counts, the
configuration it reads).

The output of a replay is the graph's own tensor, and the next replay of
any graph of the program may overwrite it: the caller copies it out on
the current stream (``HostRead``) before it calls the program again.
Stream order then gives two calls in flight their own results, and the
graphs of one program can share one memory pool.

A graph adds the launches of the hand-written kernels it holds (counted
by their wrappers while it was captured, and taken off again, since a
capture enqueues nothing) to ``kernels.launch_counts()`` at every
replay, as the eager body's wrappers would: the launch gates of
``chip_smoke.py`` read them.

The frontend's graph (``slam/frame.py::FrontendGraph``) does the same job
with rules of its own: it returns a frame of several tensors, cloned
because callers keep frames across replays.  Routing it through this
class needs tuple outputs here first.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.utils import trace
from pyorbslam_tpu_torch.utils.host_read import upload


def _dtype(a) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype \
        if isinstance(a, np.ndarray) else a.dtype


def _to_device(a, device: torch.device) -> torch.Tensor:
    return upload(np.ascontiguousarray(a), device) \
        if isinstance(a, np.ndarray) else a


def _fill(dst: torch.Tensor, src) -> None:
    """A host array through pinned memory, a device tensor as it is."""
    if isinstance(src, np.ndarray):
        src = torch.from_numpy(np.ascontiguousarray(src)).pin_memory()
    dst.copy_(src, non_blocking=True)


class _Graph:
    """The body captured once: static inputs, the graph, its output, and
    the hand-written kernels' launches it holds."""

    def __init__(self, body: Callable[..., torch.Tensor], inputs: Sequence,
                 device: torch.device, program: "GraphedProgram"):
        with torch.cuda.device(device):
            pool, stream = program.capture_resources(device)
            self.inputs = [torch.empty(tuple(a.shape), dtype=_dtype(a), device=device)
                           for a in inputs]
            self.graph = torch.cuda.CUDAGraph()
            before = kernels.launch_counts()
            # a side stream, as torch.cuda.graph captures on, but without its
            # device-wide synchronize: a capture comes in the middle of a
            # pipelined schedule whose work stays in flight, and a capture
            # runs nothing
            with torch.cuda.stream(stream):
                # thread_local: another thread (the live viewer's) may call CUDA
                self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self.out = body(*self.inputs)
                finally:
                    self.graph.capture_end()
            self.launches = kernels.take_captured(before)

    def __call__(self, inputs: Sequence) -> torch.Tensor:
        with torch.cuda.device(self.out.device):
            for dst, src in zip(self.inputs, inputs):
                _fill(dst, src)
            self.graph.replay()
        kernels.count_launches(self.launches)
        return self.out


class GraphedProgram:
    """One device program's graphs, by key, for the life of the process
    (sessions run back to back and each builds its own ``System``).  Each
    capture opens a span named ``capture_span`` with the counters the
    call is given."""

    def __init__(self, capture_span: str):
        self.capture_span = capture_span
        self.seen: Set[tuple] = set()
        self.graphs: Dict[tuple, _Graph] = {}
        self._resources: Dict[torch.device, tuple] = {}

    def capture_resources(self, device: torch.device) -> tuple:
        """The device's (memory pool, capture stream), made at its first
        capture."""
        if device not in self._resources:
            self._resources[device] = (torch.cuda.graph_pool_handle(),
                                       torch.cuda.Stream(device))
        return self._resources[device]

    @staticmethod
    def key(inputs: Sequence, device: torch.device, settings: tuple) -> tuple:
        return (device, tuple((tuple(a.shape), _dtype(a)) for a in inputs), settings)

    def __call__(self, body: Callable[..., torch.Tensor], inputs: Sequence,
                 device: torch.device, settings: tuple = (),
                 counters: Optional[dict] = None) -> Tuple[torch.Tensor, bool]:
        """(output, replayed): ``body`` on ``inputs`` (device tensors, or
        host arrays, which go up through pinned memory), eagerly or
        replayed from its key's graph."""
        if device.type != "cuda":
            return body(*(_to_device(a, device) for a in inputs)), False
        key = self.key(inputs, device, settings)
        graph = self.graphs.get(key)
        if graph is None:
            if key not in self.seen:
                self.seen.add(key)
                return body(*(_to_device(a, device) for a in inputs)), False
            with trace.span(self.capture_span) as sp:
                if sp is not None and counters:
                    sp.args.update(counters)
                graph = self.graphs[key] = _Graph(body, inputs, device, self)
        return graph(inputs), True
