"""Device results on their way to the host, and host arrays on their way
to the device, without stalling the host.

:class:`HostRead` starts a read and waits only when asked;
:func:`upload` sends a host array through pinned memory;
:func:`device_constant` uploads a constant table once and reuses it.

The JAX package starts a read with ``copy_to_host_async()`` and asks
``is_ready()`` before it blocks.  Here a :class:`HostRead` copies a CUDA
tensor into a pinned host buffer with ``copy_(non_blocking=True)`` and
records a ``torch.cuda.Event`` behind the copy: ``pending()`` is the
event's ``query()``, ``numpy()`` waits for the event only.  A CPU tensor
is ready at once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


class HostRead:
    """One device tensor being copied to the host."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._buf = t
            self._event = None

    def pending(self) -> bool:
        """True while the copy has NOT landed on the host yet."""
        return self._event is not None and not self._event.query()

    def numpy(self) -> np.ndarray:
        """The result on the host; waits for the copy if it is pending."""
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()


@functools.lru_cache(maxsize=512)
def _constant(data: bytes, np_dtype: str, shape: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    a = np.frombuffer(data, dtype=np_dtype).reshape(shape)
    return upload(torch.as_tensor(a.copy(), dtype=dtype), device)


def device_constant(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant host array as a ``dtype`` tensor on ``device``,
    uploaded once per (values, dtype, device) and handed out again after
    that: a device program that needs a table (camera intrinsics, level
    scales, a pattern) does not pay an upload, and the stall that an upload
    from pageable memory brings, every time it runs.  The tensor is shared:
    callers never write to it."""
    a = np.ascontiguousarray(a)
    return _constant(a.tobytes(), a.dtype.str, a.shape, dtype,
                     torch.device(device))


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  For a CUDA device the
    array is copied into pinned memory first and sent with a non-blocking
    copy, so the host neither waits for the stream's earlier work nor for
    the transfer, and may change ``a`` as soon as this returns."""
    t = torch.as_tensor(a)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
