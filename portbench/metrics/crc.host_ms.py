"""crc.host_ms: the host's milliseconds a traced step in the frame step's
CRC work outside its copies: the program's `step.crc_encode` (the encode
matrix built and applied) and `decode.crc_select` (the CA-SCL selection)
spans, less their `crc.h2d` children, over the traced points' `point.step`
spans."""
from portbench.spans import named, self_ms, traced

CRC = ("step.crc_encode", "decode.crc_select")


def read(ctx):
    spans = traced(ctx)
    if not spans or not named(spans, "step.crc_encode"):
        return None
    return self_ms(spans, CRC, ("crc.h2d",)) / len(named(spans, "point.step"))
