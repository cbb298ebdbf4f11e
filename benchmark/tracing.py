"""The traced run's readings: every device operation of the window from
``torch.profiler`` (CUDA activity only, kept in memory as (name, start,
end); no timeline is written), and what the host threads were doing, from a
sampler that reads each thread's innermost frame of the program a few
hundred times a second.

Device busy time is the union of the operations' intervals, as
``scripts/torch_trace.py`` computes it; an idle gap is a stretch between two
merged busy intervals, named by what the host threads were doing in it
(the most frequent sampled frame) and by the operations on its two sides.
"""

from __future__ import annotations

import bisect
import re
import sys
import threading
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Event = Tuple[str, int, int]  # name, start ns, end ns


def merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclass
class HostSampler:
    """Samples, every ``period`` seconds, the innermost frame under
    ``package`` of the program's threads (not the main thread, not the
    benchmark's ``bench-*`` threads): (time ns, "file:function")."""

    package: str
    period: float = 0.005
    samples: List[Tuple[int, str]] = field(default_factory=list)

    def __post_init__(self):
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="bench-host-sampler", daemon=True)

    def _where(self, frame) -> Optional[str]:
        while frame is not None:
            path = frame.f_code.co_filename
            if f"/{self.package}/" in path:
                return f"{path.rsplit('/', 1)[-1]}:{frame.f_code.co_name}"
            frame = frame.f_back
        return None

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            now = time.time_ns()
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                name = names.get(ident, "")
                if name.startswith("bench-") or name == "MainThread":
                    continue
                where = self._where(frame)
                if where:
                    self.samples.append((now, where))

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


class DeviceTrace:
    """``with DeviceTrace() as t:`` around the window; afterwards
    ``t.events`` holds every device operation and ``t.window_s`` the host
    seconds traced."""

    def __init__(self, package: str):
        self.sampler = HostSampler(package)
        self.events: List[Event] = []
        self.window_s = 0.0

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.sampler.start()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.sampler.stop()
        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                self.events.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        del self._prof

    # ---- readings ----

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged([(s, e) for _, s, e in self.events])) / 1e9

    def device_seconds(self, pattern: str) -> float:
        """Seconds of the operations whose name matches ``pattern`` (a regular
        expression searched in the demangled name)."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e in self.events if rx.search(name)) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by_name: Dict[str, int] = defaultdict(int)
        for name, s, e in self.events:
            by_name[short_name(name)] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle stretches between busy intervals, each named
        "host: <most sampled frame> | <op before> -> <op after>"."""
        busy = merged([(s, e) for _, s, e in self.events])
        if len(busy) < 2:
            return []
        gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                       for i in range(len(busy) - 1)), reverse=True)[:n]
        ends = sorted((e, name) for name, _, e in self.events)
        starts = sorted((s, name) for name, s, _ in self.events)
        samples = sorted(self.sampler.samples)
        out = []
        for length, g0, g1 in gaps:
            before = ends[max(bisect.bisect_right(ends, (g0, "\uffff")) - 1, 0)][1]
            after = starts[min(bisect.bisect_left(starts, (g1, "")), len(starts) - 1)][1]
            lo, hi = bisect.bisect_left(samples, (g0, "")), bisect.bisect_right(samples, (g1, "\uffff"))
            host = Counter(w for _, w in samples[lo:hi]).most_common(1)
            label = f"host: {host[0][0] if host else 'no sample'} | " \
                    f"{short_name(before)} -> {short_name(after)}"
            out.append([label[:200], length / 1e9])
        return out


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    parameters and all template arguments but the first
    (``flash_fwd_kernel<128>``: the head dim)."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:80]
    s = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:[\w:]+\s+)?(?:\w+::)*(\w+)\s*(?:<\s*([^,>]*))?", s)
    if not m:
        return name[:80]
    return f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)
