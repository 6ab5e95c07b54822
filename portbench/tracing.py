"""Reduction of a torch.profiler trace of the traced points to what the
per-layer metrics and the breakdown read.

Device activity is the union of the device events' intervals inside the
traced slice (the record_function span TRACE_SLICE): busy_s is its length,
window_s the slice's.  An idle gap is named by what the host was doing in
it: the outermost host operations inside the slice that overlap it, each
credited with its overlap, and "host python" for the rest, where the host
ran no profiled operation (Python and numpy).
"""
from __future__ import annotations

import dataclasses

from portbench.cell import TRACE_SLICE

TOP = 10
HOST_PYTHON = "host python"


@dataclasses.dataclass
class Trace:
    lo: float  # the slice's bounds, us in the profiler's clock
    hi: float
    device: list  # (name, start_us, end_us), by start
    host: list  # outermost host operations in the slice: (name, start_us, end_us)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device intervals, clipped to the slice."""
        out = []
        for _, a, b in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self, fragment: str) -> list:
        """The device events whose name holds `fragment`, by start."""
        return [e for e in self.device if fragment in e[0]]

    def device_ops(self) -> list:
        """[[name, seconds]] of the TOP device operations by total time."""
        by = {}
        for name, a, b in self.device:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """[[what the host did, seconds]] of the device's idle time, the TOP
        by total."""
        gaps, t = [], self.lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.hi > t:
            gaps.append((t, self.hi))
        by = {}
        for g0, g1 in gaps:
            covered = 0.0
            for name, a, b in self.host:
                over = min(b, g1) - max(a, g0)
                if over > 0:
                    by[name] = by.get(name, 0.0) + over / 1e6
                    covered += over
            rest = (g1 - g0) - covered
            if rest > 0:
                by[HOST_PYTHON] = by.get(HOST_PYTHON, 0.0) + rest / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def short_name(name: str) -> str:
    """A device operation's name without a kernel's return type and
    parameter list."""
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i and name[i - 1] not in " ":
            name = name[:i]
            break
    return name.removeprefix("void ").strip()[:120]


def reduce(prof) -> Trace:
    """The Trace of a finished torch.profiler.profile that holds one
    TRACE_SLICE span."""
    from torch.autograd import DeviceType

    events = prof.events()
    spans = [e for e in events
             if e.name == TRACE_SLICE and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        raise ValueError(f"the trace holds {len(spans)} {TRACE_SLICE} spans")
    sl = spans[0]
    lo, hi = sl.time_range.start, sl.time_range.end
    device = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in events  # not the span's own device annotation
                     if e.device_type == DeviceType.CUDA and e.name != TRACE_SLICE),
                    key=lambda e: e[1])
    host = sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in events
                   if e.device_type == DeviceType.CPU and e is not sl
                   and (e.cpu_parent is None or e.cpu_parent is sl)
                   and e.time_range.start >= lo and e.time_range.end <= hi),
                  key=lambda e: e[1])
    return Trace(lo, hi, device, host)
