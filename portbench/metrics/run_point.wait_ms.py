"""run_point.wait_ms: the host's milliseconds a traced step blocked on the
device for counters, the program's `point.read` spans (run_point's
counter reads) over its `point.step` spans in the traced points."""
from portbench.spans import ms, named, traced


def read(ctx):
    spans = traced(ctx)
    steps = named(spans, "point.step") if spans else []
    if not steps:
        return None
    return sum(ms(s) for s in named(spans, "point.read")) / len(steps)
