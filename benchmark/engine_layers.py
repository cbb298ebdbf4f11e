"""What the readers of the engine's own split of its layers share: ratios of
its ``stats()`` counters as they moved over the window, and its decode
worker's ``launch`` spans against the traced window's device operations.

A program that lacks a counter, or the span recorder, reads None, and the
harness leaves the metric out of the line. Beside ``port.py`` this is the
one module of the benchmark that imports the program: its span recorder,
``ufvideo_tpu_torch.utils.tracing``, whose spans are on ``time.time_ns()``'s
clock, the device trace's."""

from __future__ import annotations

from typing import List, Optional, Tuple

from .tracing import merged

PERCENT = 100.0


def deltas(w, *keys: str) -> Optional[List[float]]:
    """Each counter's move over the window, or None if the program has not
    one of them."""
    if not all(k in w.stats0 and k in w.stats1 for k in keys):
        return None
    return [w.delta(k) for k in keys]


def ratio(w, num: str, den: str, scale: float = 1.0, per: float = 1.0) -> Optional[float]:
    """``scale`` × Δnum / (``per`` × Δden), None without either counter or
    with no Δden."""
    d = deltas(w, num, den)
    if d is None or d[1] <= 0:
        return None
    return scale * d[0] / (per * d[1])


def uncovered_ns(spans: List[Tuple[int, int]], busy: List[Tuple[int, int]]) -> int:
    """The time inside ``spans`` that no interval of ``busy`` covers; both
    lists merged (sorted, disjoint)."""
    out = j = 0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        cur, k = s, j
        while k < len(busy) and busy[k][0] < e:
            out += max(busy[k][0] - cur, 0)
            cur = max(cur, busy[k][1])
            k += 1
        out += max(e - cur, 0)
    return out


def idle_in_launch(w, recorder=None, offset_ns: Optional[int] = None) -> Optional[float]:
    """Percent of the window [w0, w1] in which no operation runs on the
    device while the decode worker is inside a ``launch`` span: the card
    waiting for Python to issue the step's work. ``recorder`` and
    ``offset_ns`` (``perf_counter`` ns to the spans' clock) default to the
    program's."""
    if recorder is None or offset_ns is None:
        try:
            from ufvideo_tpu_torch.utils import tracing
        except ImportError:
            return None
        recorder = recorder or tracing.RECORDER
        offset_ns = tracing.perf_offset_ns() if offset_ns is None else offset_ns
    lo, hi = int(w.w0 * 1e9) + offset_ns, int(w.w1 * 1e9) + offset_ns
    launch = merged([(max(s.start_ns, lo), min(s.end_ns, hi))
                     for s in recorder.spans(lo, hi) if s.name == "launch"])
    if not launch or hi <= lo:
        return None
    busy = merged([(max(s, lo), min(e, hi)) for _, s, e in w.trace.events if e > lo and s < hi])
    return PERCENT * uncovered_ns(launch, busy) / (hi - lo)
