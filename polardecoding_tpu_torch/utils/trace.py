"""Spans of the port's host work: named intervals on the host's clock
(time.perf_counter_ns), nested as the calls that open them, with optional
counts, kept in memory.

    with trace.span("crc.h2d", bytes=M.nbytes):
        ...

Counts that cost work to find are given through `lazy`, which is called
only while tracing is on.

Tracing is on inside `recording()` and whenever torch.profiler records
(torch.autograd.profiler._is_profiler_enabled), so a profiled run of the
port gets its spans.  Off, the default, `span` makes that one check and
returns a shared object that does nothing.  A span's parent is the span
open around it when it opens, and its point is the outermost open span: the
`point` span of a run_point call, shared by every span of that BLER point.
The last CAPACITY spans are kept (`spans()`, emptied by `clear()`); the
recorder serves one thread.  `write_chrome_trace` writes them as a Chrome
trace (JSON, viewable in Perfetto).

The spans are not profiler ranges: a range that encloses kernels gets an
annotation on the device's timeline, which would read as device activity.
While the profiler records, a span opened with anchor=True starts with a
clock anchor instead, an empty profiler range named ANCHOR that encloses
no device work, inside which the span's start is stamped.  The profiler's
timestamps of the anchors give the offset between the two clocks
(`on_profiler_clock`).  The range is torch's C++ one where torch has it:
under a CUDA trace on an H100's host an anchor then lasts about 2 us,
record_function about 90 us.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import itertools
import json
import statistics
import time
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

ANCHOR = "polardecoding.clock"
CAPACITY = 1 << 18
# an anchor held this many times the median anchor's length says little of
# where in it the stamp fell, and is not used
SLOW_ANCHOR = 4
_anchor_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                        _profiler.record_function)


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    id: int
    parent: Optional[int]  # the span open around it
    point: int  # the outermost open span's id (its own, for a root)
    t0: int  # time.perf_counter_ns()
    t1: int
    counts: Optional[dict] = None
    anchored: bool = False  # t0 was stamped inside a clock anchor


_spans: collections.deque = collections.deque(maxlen=CAPACITY)
_open: list = []  # the open spans, outermost first
_ids = itertools.count(1)
_recording = 0


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Live:
    __slots__ = ("name", "counts", "anchor", "id", "parent", "point", "t0",
                 "anchored")

    def __init__(self, name: str, counts: dict, anchor: bool):
        self.name, self.counts, self.anchor = name, counts, anchor

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _open[-1].id if _open else None
        self.point = _open[0].id if _open else self.id
        _open.append(self)
        self.anchored = self.anchor and _profiler._is_profiler_enabled
        if self.anchored:
            with _anchor_range(ANCHOR):
                self.t0 = time.perf_counter_ns()
        else:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _open.pop()
        _spans.append(Span(self.name, self.id, self.parent, self.point, self.t0,
                           t1, self.counts or None, self.anchored))
        return False


def span(name: str, anchor: bool = False, lazy=None, **counts):
    """A context manager that records the span `name` with `counts` while
    tracing is on; anchor=True opens it with a clock anchor while the
    profiler records.  lazy: a function that returns more counts, called
    before the span opens and only while tracing is on."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    if lazy is not None:
        counts.update(lazy())
    return _Live(name, counts, anchor)


@contextlib.contextmanager
def recording():
    """Tracing on inside the block."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list:
    """The recorded spans, in the order they closed."""
    return list(_spans)


def clear() -> None:
    _spans.clear()


def anchor_offsets(spans: list, anchors: list) -> tuple:
    """(stamps, offsets): the anchored spans' starts (ns, ascending) and,
    for each, the profiler's clock minus the host's in us, from the
    midpoint of its anchor event; anchors held over SLOW_ANCHOR times the
    median are left out.  anchors: (start_us, end_us) of the profiler's
    ANCHOR events, one for each anchored span of `spans`.  ValueError when
    the two do not pair up."""
    stamps = sorted(s.t0 for s in spans if s.anchored)
    if not stamps or len(stamps) != len(anchors):
        raise ValueError(f"{len(stamps)} anchored spans against "
                         f"{len(anchors)} anchor events")
    pairs = list(zip(stamps, sorted(anchors)))
    slow = SLOW_ANCHOR * statistics.median(b - a for _, (a, b) in pairs)
    kept = [(t, (a + b) / 2 - t / 1e3) for t, (a, b) in pairs if b - a <= slow]
    return [t for t, _ in kept], [off for _, off in kept]


def on_profiler_clock(spans: list, anchors: list) -> list:
    """[(span, start_us, end_us)] of every span on the profiler's clock,
    each moved by the offset of its nearest preceding anchor that is used
    (the first's for a span that starts before it), so that the clocks'
    drift does not build up over a trace."""
    stamps, offsets = anchor_offsets(spans, anchors)
    out = []
    for s in spans:
        off = offsets[max(bisect.bisect_right(stamps, s.t0) - 1, 0)]
        out.append((s, s.t0 / 1e3 + off, s.t1 / 1e3 + off))
    return out


def write_chrome_trace(path: str) -> None:
    """The recorded spans as a Chrome trace: one complete event each, in us
    from the first span's start, with its id, parent, point and counts as
    arguments."""
    rec = spans()
    base = min((s.t0 for s in rec), default=0)
    events = [{"name": s.name, "ph": "X", "pid": 0, "tid": 0,
               "ts": (s.t0 - base) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
               "args": {"id": s.id, "parent": s.parent, "point": s.point,
                        **(s.counts or {})}} for s in rec]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
