"""The program's host spans: one recorder for the process.

One, because spans open in free functions that no ``System`` reaches
(``build_stereo_frame``, the tracking steps, ``pose_optimization``) and
the program runs one host thread; whoever enables it drains it.

A span is one stretch of host work: its name, the id of the frame that
caused it, the span open when it began (``parent``; the program runs one
host thread, so spans nest), its start and end on ``time.perf_counter_ns``
and ``args``, counters the host already held at that boundary.  Spans are
kept in memory in a bounded buffer that counts what it drops; the caller
takes them with :func:`drain` when its run ends.  Nothing is written out.

Recording is off unless :func:`enable` turns it on.  Off, a span costs
one flag check: no clock read, no allocation.  A call site builds its
``args`` only when it was handed a span (``if sp is not None``), and no
span reads a device tensor or synchronizes.

:func:`enable` also takes one anchor pair, ``(time.time_ns(),
time.perf_counter_ns())``: :meth:`Drained.epoch_spans` moves the spans onto
the Unix epoch clock that ``torch.profiler`` stamps its host and device
records with, so the program's spans line up with a device trace.

:func:`stage` is the program's stage clock: it adds a stage's host
seconds to a ``times`` dict (and its calls to a ``counts`` dict) whether
or not recording is on, and records the stage as a span when it is.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

DEFAULT_CAPACITY = 1 << 20


class Span:
    """One span; ``t1_ns`` is 0 while it is open."""

    __slots__ = ("id", "name", "frame", "parent", "t0_ns", "t1_ns", "args")

    def __init__(self, id, name, frame, parent, t0_ns, t1_ns=0, args=None):
        self.id = id
        self.name = name
        self.frame = frame
        self.parent = parent
        self.t0_ns = t0_ns
        self.t1_ns = t1_ns
        self.args = {} if args is None else args

    def __repr__(self):
        return (f"Span({self.id}, {self.name!r}, frame={self.frame}, "
                f"parent={self.parent}, {self.t0_ns}..{self.t1_ns}, {self.args})")


class Drained(NamedTuple):
    """What :func:`drain` hands back: the closed spans (perf_counter ns),
    how many the bound dropped, and the anchor ``(time_ns,
    perf_counter_ns)`` taken when recording was enabled."""

    spans: List[Span]
    dropped: int
    anchor: Optional[Tuple[int, int]]

    def epoch_spans(self) -> List[Span]:
        """The spans with their times on the Unix epoch clock."""
        if self.anchor is None:
            return []
        shift = self.anchor[0] - self.anchor[1]
        return [Span(s.id, s.name, s.frame, s.parent, s.t0_ns + shift,
                     s.t1_ns + shift, s.args) for s in self.spans]


class Recorder:
    """The spans of one process.  Use the module's functions."""

    def __init__(self):
        self.on = False
        self.capacity = DEFAULT_CAPACITY
        self.spans: List[Span] = []
        self.dropped = 0
        self.anchor: Optional[Tuple[int, int]] = None
        self._open: List[Span] = []
        self._next_id = 0

    def open(self, name: str, frame: Optional[int], t0_ns: int) -> Span:
        parent = self._open[-1] if self._open else None
        if frame is None:
            frame = parent.frame if parent is not None else -1
        s = Span(self._next_id, name, frame,
                 parent.id if parent is not None else -1, t0_ns)
        self._next_id += 1
        self._open.append(s)
        return s

    def close(self, s: Span, t1_ns: int) -> None:
        s.t1_ns = t1_ns
        self._open.pop()    # spans close in the order ``with`` gives
        if len(self.spans) < self.capacity:
            self.spans.append(s)
        else:
            self.dropped += 1


RECORDER = Recorder()


def enable() -> None:
    """Start recording (at most ``DEFAULT_CAPACITY`` spans until the next
    drain) and take the clock anchor."""
    RECORDER.anchor = (time.time_ns(), time.perf_counter_ns())
    RECORDER.on = True


def disable() -> None:
    """Stop recording; spans already open still close into the buffer."""
    RECORDER.on = False


def drain() -> Drained:
    """Take the closed spans and the drop count, and empty the buffer."""
    out = Drained(RECORDER.spans, RECORDER.dropped, RECORDER.anchor)
    RECORDER.spans = []
    RECORDER.dropped = 0
    return out


class _Span:
    __slots__ = ("name", "frame", "span")

    def __init__(self, name, frame):
        self.name = name
        self.frame = frame

    def __enter__(self) -> Span:
        self.span = RECORDER.open(self.name, self.frame, time.perf_counter_ns())
        return self.span

    def __exit__(self, *exc):
        RECORDER.close(self.span, time.perf_counter_ns())
        return False


def current() -> Optional[Span]:
    """The innermost open span, or None while recording is off."""
    return RECORDER._open[-1] if RECORDER.on and RECORDER._open else None


_OFF = contextlib.nullcontext()


def span(name: str, frame: Optional[int] = None):
    """A span around a ``with`` block; ``frame`` None takes the parent's.
    The block gets the :class:`Span` (to fill its ``args``), or None when
    recording is off."""
    if not RECORDER.on:
        return _OFF
    return _Span(name, frame)


def spanned(name: str):
    """Decorate a function so that each call is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not RECORDER.on:
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return traced
    return wrap


class stage:
    """Wall-clock a stage: add its host seconds to ``times[label]`` and,
    given ``counts``, one to ``counts[label]``; ``sync``, when given, runs
    before the clock stops (a device wait, so the stage's queued work
    counts as the stage's).  Records the stage as a span while recording
    is on; the block gets the span or None (a block that sets the span's
    ``frame`` first, before any span opens inside it, hands its frame to
    those)."""

    __slots__ = ("times", "label", "counts", "sync", "t0", "span")

    def __init__(self, times: Dict[str, float], label: str,
                 counts: Optional[Dict[str, int]] = None,
                 sync: Optional[Callable[[], None]] = None):
        self.times = times
        self.label = label
        self.counts = counts
        self.sync = sync

    def __enter__(self) -> Optional[Span]:
        self.t0 = time.perf_counter_ns()
        self.span = RECORDER.open(self.label, None, self.t0) \
            if RECORDER.on else None
        return self.span

    def __exit__(self, *exc):
        if self.sync is not None:
            self.sync()
        t1 = time.perf_counter_ns()
        self.times[self.label] += (t1 - self.t0) * 1e-9
        if self.counts is not None:
            self.counts[self.label] += 1
        if self.span is not None:
            RECORDER.close(self.span, t1)
        return False
