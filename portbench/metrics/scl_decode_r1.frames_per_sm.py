"""scl_decode_r1.frames_per_sm: the frames an SM of the list-decode
kernel's instantiation that the traced steps launched (their mean), as
the program's `decode.list` spans count it (frames_per_sm, on the kernel
path: the library's occupancy query at the launch's shape).  None where
no traced span holds the count, as in a program without the span."""
from portbench import spans

SPAN = "decode.list"


def read(ctx):
    rec = spans.traced(ctx)
    if rec is None:
        return None
    got = [s.counts["frames_per_sm"] for s in spans.named(rec, SPAN)
           if s.counts and "frames_per_sm" in s.counts]
    return sum(got) / len(got) if got else None
