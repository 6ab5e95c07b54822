"""frame_step.host_ms: the host's milliseconds from the call of the
program's frame step (the step that run_point is handed) to its return,
the mean over the window's steps outside the traced points (the profiler
slows the host there).  The step enqueues its device work
and returns; what the host does inside it (payload, CRC matrices and their
copies, launches) is this time, and every step of a point pays it."""


def read(ctx):
    traced = set(ctx.window.traced)
    spans = [s.t1 - s.t0 for s in ctx.window.steps if s.point not in traced]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
