"""The traced window, read from ``torch.profiler``: device operations
(kernels, copies, fills), the host operations open around them, the
device's busy time as the union of its operations' intervals (the busy
share of ``chip_smoke.py``'s ``busy_share``, taken over the whole window
instead of over one step), and the breakdown the result line carries."""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]          # ns, ns


@dataclass
class Trace:
    """One traced window: [lo_ns, hi_ns] on the profiler's clock (Unix ns),
    device operations and host operations as (name, start_ns, end_ns)."""

    lo_ns: int
    hi_ns: int
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.hi_ns - self.lo_ns) / 1e9

    def busy_s(self) -> float:
        return sum(b - a for a, b in merged((s, e) for _, s, e in self.device)) / 1e9

    def by_name(self) -> Dict[str, Tuple[int, int]]:
        """(count, ns) of the device operations of each name."""
        if not hasattr(self, "_by_name"):
            out: Dict[str, Tuple[int, int]] = {}
            for name, s, e in self.device:
                n, t = out.get(name, (0, 0))
                out[name] = (n + 1, t + e - s)
            self._by_name = out
        return self._by_name

    def device_s(self, patterns: Optional[Sequence[re.Pattern]] = None,
                 exclude: Sequence[Sequence[re.Pattern]] = ()) -> float:
        """Seconds summed over the device operations whose names match one of
        ``patterns`` (all when None) and no set of ``exclude``."""
        return sum(t for name, (_, t) in self.by_name().items()
                   if (patterns is None or matches(name, patterns))
                   and not any(matches(name, p) for p in exclude)) / 1e9

    def matched(self, patterns: Sequence[re.Pattern]) -> int:
        return sum(n for name, (n, _) in self.by_name().items() if matches(name, patterns))


def matches(name: str, patterns: Sequence[re.Pattern]) -> bool:
    return any(p.search(name) for p in patterns)


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals, as disjoint sorted intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Window:
    """A context that traces its body with ``torch.profiler`` (host and
    device activity) and hands back a ``Trace`` clipped to the body."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Optional[Trace] = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._profile = profile(activities=activities)
            self._profile.__enter__()
        self._lo = time.time_ns()
        return self

    def __exit__(self, *exc):
        hi = time.time_ns()
        if self.enabled:
            self._profile.__exit__(*exc)
            if exc[0] is None:
                # the raw events: not the per-event Python objects that
                # the profile's own tables build
                self.trace = collect(self._profile.profiler.kineto_results.events(), self._lo, hi)
        return False


def collect(events, lo_ns: int, hi_ns: int) -> Trace:
    """Device and host operations of a finished profile's events, clipped
    to [lo_ns, hi_ns]; annotations (ranges, not work) are left out."""
    from torch.autograd import DeviceType

    trace = Trace(lo_ns, hi_ns)
    for ev in events:
        if ev.is_user_annotation():
            continue
        s = max(ev.start_ns(), lo_ns)
        e = min(ev.start_ns() + ev.duration_ns(), hi_ns)
        if e <= s:
            continue
        if ev.device_type() == DeviceType.CUDA:
            trace.device.append((ev.name(), s, e))
        elif ev.device_type() == DeviceType.CPU:
            trace.host.append((ev.name(), s, e))
    return trace


def idle_gaps(trace: Trace) -> List[Interval]:
    """The intervals of the window in which no device operation runs."""
    gaps, at = [], trace.lo_ns
    for a, b in merged((s, e) for _, s, e in trace.device):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if trace.hi_ns > at:
        gaps.append((at, trace.hi_ns))
    return gaps


def host_open(trace: Trace, gaps: List[Interval]) -> Dict[str, float]:
    """Seconds of idle device by the innermost host operation open at the
    middle of each gap ('(no host operation)' where none is)."""
    host = sorted(trace.host, key=lambda h: h[1])
    out: Dict[str, float] = {}
    active: List[Tuple[str, int, int]] = []
    i = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        while i < len(host) and host[i][1] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        key = max(active, key=lambda h: h[1])[0] if active else "(no host operation)"
        out[key] = out.get(key, 0.0) + (b - a) / 1e9
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host had open, each the ``top`` largest, in seconds."""
    ops = sorted(((n, t / 1e9) for n, (_, t) in trace.by_name().items()),
                 key=lambda kv: -kv[1])[:top]
    idle = sorted(host_open(trace, idle_gaps(trace)).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n[:120], v] for n, v in idle]}
