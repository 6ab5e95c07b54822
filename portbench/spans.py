"""The program's own spans (polardecoding_tpu_torch.utils.trace) of the
traced points, for the per-layer metrics that read them.  The program
records spans while torch.profiler runs, so it records them in the traced
points and nowhere else in a run.  A program without the recorder, or a
run that recorded no span, gives None."""
from __future__ import annotations

import importlib
from typing import Optional


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        return importlib.import_module("polardecoding_tpu_torch.utils.trace")
    except ImportError:
        return None


def traced(ctx) -> Optional[list]:
    """The spans of the points whose `point` span lies inside a traced
    point's run_point call (the spans of one process's earlier windows
    are left out), or None."""
    trace = recorder()
    if trace is None:
        return None
    calls = [(ctx.window.points[i].t0, ctx.window.points[i].t1)
             for i in ctx.window.traced if i < len(ctx.window.points)]
    rec = trace.spans()
    roots = {s.id for s in rec if s.name == "point"
             and any(t0 <= s.t0 / 1e9 and s.t1 / 1e9 <= t1 for t0, t1 in calls)}
    out = [s for s in rec if s.point in roots]
    return out or None


def ms(s) -> float:
    return (s.t1 - s.t0) / 1e6


def named(spans: list, *names) -> list:
    return [s for s in spans if s.name in names]


def self_ms(spans: list, parents: tuple, children: tuple) -> float:
    """The summed milliseconds of the spans named in `parents`, less those
    of their direct children named in `children`."""
    ids = {s.id for s in named(spans, *parents)}
    return (sum(ms(s) for s in named(spans, *parents))
            - sum(ms(s) for s in named(spans, *children) if s.parent in ids))
