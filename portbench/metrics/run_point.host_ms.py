"""run_point.host_ms: the host's milliseconds a traced point in run_point
outside its steps and counter reads: the program's `point` spans less
their `point.step` and `point.read` children, over the traced points."""
from portbench.spans import named, self_ms, traced


def read(ctx):
    spans = traced(ctx)
    points = named(spans, "point") if spans else []
    if not points:
        return None
    return self_ms(spans, ("point",), ("point.step", "point.read")) / len(points)
