"""run_point_waves.wait_ms: the host's milliseconds a traced wave step
blocked on the device for counters: the program's `waves.read` spans
(run_point_waves' waits for a chunk's counters) over its `waves.step`
spans in the traced points."""
from portbench.spans import ms, named, traced


def read(ctx):
    spans = traced(ctx)
    steps = named(spans, "waves.step") if spans else []
    if not steps:
        return None
    return sum(ms(s) for s in named(spans, "waves.read")) / len(steps)
