"""crc.h2d_kib: the KiB of CRC matrices that a traced step hands to the
device, the program's `crc.h2d` spans' `bytes` summed over the traced
points, over their `point.step` spans, over 1024.  On the card each is a
copy from pageable memory (ops/crc.gf2_matmul).  Read where the step has
CRC work (`step.crc_encode` spans), 0 where that work copies nothing."""
from portbench.spans import named, traced


def read(ctx):
    spans = traced(ctx)
    if not spans or not named(spans, "step.crc_encode"):
        return None
    steps = len(named(spans, "point.step"))
    nbytes = sum(s.counts["bytes"] for s in named(spans, "crc.h2d"))
    return nbytes / steps / 1024
