"""crc.device_idle_pct: the share of the traced slice's wall time in which
the device idles while the host is in the frame step's CRC work: 100 x
(the device's idle time, outside the union of its intervals, that
overlaps the program's `step.crc_encode`, `decode.crc_select` or `crc.h2d`
spans) / the slice's wall time.  The spans are moved onto the profiler's
clock by the program's clock anchors (host events named by its recorder's
ANCHOR), each by its nearest preceding anchor.  Never above
device_idle_pct of the same run."""
from portbench.spans import named, recorder, traced

CRC = ("step.crc_encode", "decode.crc_select", "crc.h2d")


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(xs, ys):
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    spans = traced(ctx)
    if not spans or not named(spans, "step.crc_encode"):
        return None
    trace = recorder()
    anchors = [(a, b) for name, a, b in t.host if name == trace.ANCHOR]
    try:
        mapped = trace.on_profiler_clock(spans, anchors)
    except ValueError as e:
        ctx.note(f"crc.device_idle_pct: the spans do not map onto the trace: {e}")
        return None
    crc = union([(max(a, t.lo), min(b, t.hi)) for s, a, b in mapped
                 if s.name in CRC and min(b, t.hi) > max(a, t.lo)])
    idle, at = [], t.lo
    for a, b in t.busy_intervals():
        if a > at:
            idle.append([at, a])
        at = max(at, b)
    if t.hi > at:
        idle.append([at, t.hi])
    pct = 100.0 * overlap_us(idle, crc) / (t.hi - t.lo)
    ctx.note(f"crc.device_idle_pct {pct} over {len(anchors)} anchors, "
             f"{len(named(spans, *CRC))} CRC spans")
    return pct
