"""run_point_waves.drain_ms: the host's milliseconds of a traced point's
drain tail: the program's `waves.drain` spans (each drain call and the
host's read of its counters) over the traced points' `point` spans."""
from portbench.spans import ms, named, traced


def read(ctx):
    spans = traced(ctx)
    drains = named(spans, "waves.drain") if spans else []
    if not drains:
        return None
    return sum(ms(s) for s in drains) / len(named(spans, "point"))
