"""Spans of the program's layers, kept in memory, on the device trace's clock.

A span is one interval of one layer's work: its name, start and end in
nanoseconds on ``time.time_ns()``'s clock (the clock kineto stamps a
``torch.profiler`` session's events with, so spans lie over the kernels of a
trace), its id, the id of the span that caused it (0: none), the ids of the
requests it serves, the thread that ran it and, for a span one thread ran
from start to end, that thread's CPU time inside it (-1 otherwise).

Spans are recorded only while a ``torch.profiler`` session runs in the
process: ``on()`` reads ``torch.autograd.profiler._is_profiler_enabled``, the
module flag PyTorch keeps for this kind of check. The benchmark's traced
window and ``utils.logging.profile_trace`` set it; outside a session a span
point costs one flag read. They go into one bounded ring, ``RECORDER``
(``RING`` spans, the oldest dropped first), and are never written on the hot
path: ``Recorder.spans`` returns those of a time range, ``self_time_ns`` a
span's time outside its children, and ``profile_trace`` writes them into
its Chrome trace beside kineto's events.

``Split`` divides one iteration of a host loop into consecutive phases and
keeps each phase's host and thread CPU nanoseconds, recorded or not, for the
caller's counters; while spans are recorded each phase is also a span, a
child of the iteration's. ``wait()`` marks a host sync: inside it, the
thread's open split counts the time as ``wait``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

from torch.autograd import profiler as _profiler

RING = 1 << 16  # spans kept

_local = threading.local()  # the split each thread has open


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int  # the span that caused this one; 0: none
    requests: Tuple[int, ...]
    thread: str
    cpu_ns: int  # the thread's CPU time inside; -1: not one thread's from start to end


def on() -> bool:
    """Whether spans are recorded: a ``torch.profiler`` session runs."""
    return _profiler._is_profiler_enabled


def perf_offset_ns() -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()``, now: added to a
    ``perf_counter`` reading in nanoseconds, it gives the spans' clock."""
    a = time.perf_counter_ns()
    t = time.time_ns()
    return t - (a + time.perf_counter_ns()) // 2


class Recorder:
    """A bounded ring of spans. Appends and copies are single operations on
    a ``collections.deque``, so threads record without a lock."""

    def __init__(self, size: int = RING):
        self._ring: "collections.deque[Span]" = collections.deque(maxlen=size)
        self._ids = itertools.count(1)

    def new_id(self) -> int:
        return next(self._ids)

    def add(self, name: str, start_ns: int, end_ns: int, *, parent: int = 0,
            requests: Iterable[int] = (), cpu_ns: int = -1, span_id: int = 0) -> int:
        """Record a span (a fresh id unless ``span_id`` was taken from
        ``new_id`` beforehand, for children recorded first); return its id."""
        span_id = span_id or next(self._ids)
        self._ring.append(Span(name, start_ns, end_ns, span_id, parent, tuple(requests),
                               threading.current_thread().name, cpu_ns))
        return span_id

    def spans(self, start_ns: Optional[int] = None, end_ns: Optional[int] = None) -> List[Span]:
        """The spans kept that overlap [start_ns, end_ns], in the order they
        were recorded."""
        lo = -1 if start_ns is None else start_ns
        hi = float("inf") if end_ns is None else end_ns
        return [s for s in self._ring.copy() if s.end_ns >= lo and s.start_ns <= hi]


RECORDER = Recorder()


def self_time_ns(span: Span, spans: Sequence[Span]) -> int:
    """The span's duration less the part of it its children (the spans whose
    parent it is) cover."""
    covered = 0
    end = span.start_ns
    for s, e in sorted((max(c.start_ns, span.start_ns), min(c.end_ns, span.end_ns))
                       for c in spans if c.parent == span.id):
        s = max(s, end)
        if e > s:
            covered += e - s
            end = e
    return span.end_ns - span.start_ns - covered


class Split:
    """``with Split(name, first) as sp:`` over one iteration of a host loop.
    The iteration begins in phase ``first``; ``sp.switch(kind)`` ends the
    current phase and begins ``kind``, so every moment of the iteration
    belongs to exactly one phase and the phases add up to it. ``wall_ns`` and
    ``cpu_ns`` hold each phase's host and thread CPU nanoseconds when the
    block ends. While spans are recorded (decided once, on entry) the
    iteration is a span named ``name`` and each phase a child span; both
    carry ``requests``."""

    __slots__ = ("name", "requests", "wall_ns", "cpu_ns", "id", "_kind", "_stack", "_t", "_c",
                 "_rec", "_off", "_t0", "_c0", "_prev")

    def __init__(self, name: str, first: str, requests: Iterable[int] = ()):
        self.name = name
        self.requests = tuple(requests)
        self.wall_ns: Dict[str, int] = collections.defaultdict(int)
        self.cpu_ns: Dict[str, int] = collections.defaultdict(int)
        self._kind = first
        self._stack: List[str] = []

    def __enter__(self) -> "Split":
        self._prev = getattr(_local, "split", None)
        _local.split = self
        self._rec = on()
        if self._rec:
            # phases are stamped from the counters' own readings, moved to
            # the spans' clock, so a phase's span is its counted time
            self.id = RECORDER.new_id()
            self._off = perf_offset_ns()
        self._t = self._t0 = time.perf_counter_ns()
        self._c = self._c0 = time.thread_time_ns()
        return self

    def switch(self, kind: Optional[str]) -> None:
        """End the current phase and begin ``kind``."""
        if kind == self._kind:
            return
        t, c = time.perf_counter_ns(), time.thread_time_ns()
        self.wall_ns[self._kind] += t - self._t
        self.cpu_ns[self._kind] += c - self._c
        if self._rec:
            RECORDER.add(self._kind, self._t + self._off, t + self._off, parent=self.id,
                         requests=self.requests, cpu_ns=c - self._c)
        self._t, self._c, self._kind = t, c, kind

    def push(self, kind: str) -> None:
        """Begin ``kind`` until the matching ``pop``."""
        self._stack.append(self._kind)
        self.switch(kind)

    def pop(self) -> None:
        self.switch(self._stack.pop())

    def __exit__(self, *exc) -> None:
        self.switch(None)
        _local.split = self._prev
        if self._rec:
            RECORDER.add(self.name, self._t0 + self._off, self._t + self._off,
                         requests=self.requests, cpu_ns=self._c - self._c0, span_id=self.id)

    def seconds(self, kind: str) -> float:
        return self.wall_ns[kind] / 1e9

    def cpu_seconds(self, kind: str) -> float:
        return self.cpu_ns[kind] / 1e9


class _Wait:
    __slots__ = ()

    def __enter__(self) -> None:
        sp = getattr(_local, "split", None)
        if sp is not None:
            sp.push("wait")

    def __exit__(self, *exc) -> None:
        sp = getattr(_local, "split", None)
        if sp is not None:
            sp.pop()


_WAIT = _Wait()


def wait() -> _Wait:
    """``with wait():`` around a host sync (a readback, a test of a device
    value): the thread's open ``Split``, if any, counts it as ``wait``."""
    return _WAIT


def chrome_events(spans: Iterable[Span], base_ns: int, pid: str = "ufvideo spans") -> List[dict]:
    """Spans as Chrome trace complete events, ``ts`` in microseconds after
    ``base_ns`` (a kineto trace's ``baseTimeNanoseconds``), one row a thread."""
    return [{"ph": "X", "cat": "ufvideo", "name": s.name, "pid": pid, "tid": s.thread,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "requests": list(s.requests),
                      "cpu_us": s.cpu_ns / 1e3 if s.cpu_ns >= 0 else None}}
            for s in spans]
