"""device_idle_pct: the share of the traced points' wall time in which no
operation ran on the device, 100 (1 - busy / window), from the profiler's
device intervals (their union) over the traced slice."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
