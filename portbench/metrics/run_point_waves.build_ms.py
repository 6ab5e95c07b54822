"""run_point_waves.build_ms: the host's milliseconds a traced point spent
building its wave stepper: the program's `waves.build` spans
(run_point_waves' call of make_wave_step) over the traced points' `point`
spans."""
from portbench.spans import ms, named, traced


def read(ctx):
    spans = traced(ctx)
    builds = named(spans, "waves.build") if spans else []
    if not builds:
        return None
    return sum(ms(s) for s in builds) / len(named(spans, "point"))
