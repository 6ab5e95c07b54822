"""The per-layer metrics that read the program's spans, on made-up spans
and a made-up trace: two points, the second traced."""
import sys
import types

import pytest

from portbench.spec import metric_reader
from portbench.tracing import Trace

NEW = ["crc.h2d_kib", "crc.host_ms", "crc.device_idle_pct", "run_point.wait_ms",
       "run_point.host_ms"]
OFFSET_US = 1000.0  # the profiler's clock ahead of the host's


def spans(crc=True):
    """An untraced point (ids 1-3) in the first second, then a traced one
    (ids 10-) of two steps of 100 ms; times in ms from the run's start."""
    from polardecoding_tpu_torch.utils.trace import Span

    rows = [("point", 1, None, 1, 100, 900), ("point.step", 2, 1, 1, 200, 300, None, True),
            ("step.crc_encode", 3, 2, 1, 210, 230),
            ("point", 10, None, 10, 1100, 1900),
            ("point.step", 11, 10, 10, 1200, 1300, None, True),
            ("point.read", 12, 10, 10, 1300, 1310),
            ("point.step", 13, 10, 10, 1400, 1500, None, True),
            ("point.read", 14, 10, 10, 1500, 1530),
            ("step.decode", 15, 11, 10, 1240, 1290), ("step.decode", 16, 13, 10, 1440, 1490)]
    if crc:
        rows += [("step.crc_encode", 20, 11, 10, 1210, 1230),
                 ("crc.h2d", 21, 20, 10, 1220, 1225, {"bytes": 1000}),
                 ("decode.crc_select", 22, 15, 10, 1270, 1280),
                 ("crc.h2d", 23, 22, 10, 1271, 1279, {"bytes": 24}),
                 ("step.crc_encode", 24, 13, 10, 1410, 1420),
                 ("crc.h2d", 25, 24, 10, 1411, 1412, {"bytes": 1000}),
                 ("decode.crc_select", 26, 16, 10, 1450, 1460),
                 ("crc.h2d", 27, 26, 10, 1451, 1459, {"bytes": 24})]
    return [Span(r[0], r[1], r[2], r[3], int(r[4] * 1e6), int(r[5] * 1e6), *r[6:])
            for r in rows]


def context(recorded, monkeypatch, device=True):
    from polardecoding_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda: recorded)
    us = lambda ms: ms * 1e3 + OFFSET_US  # noqa: E731
    # idle 1221-1230 ms (inside the first step's CRC encode) and 1600-1700
    busy = [("k", us(1100), us(1221)), ("k", us(1230), us(1600)), ("k", us(1700), us(1900))]
    anchors = [(trace.ANCHOR, us(t) - 0.5, us(t) + 0.5) for t in (1200, 1400)]
    points = [types.SimpleNamespace(t0=0.05, t1=0.95), types.SimpleNamespace(t0=1.05, t1=1.95)]
    return types.SimpleNamespace(
        window=types.SimpleNamespace(points=points, traced=(1,)),
        trace=Trace(us(1100), us(1900), busy if device else [], anchors),
        note=lambda line: None)


def read(name, ctx):
    return metric_reader(name).read(ctx)


def test_the_readers_on_a_ca_scl_point(monkeypatch):
    ctx = context(spans(), monkeypatch)
    assert read("crc.h2d_kib", ctx) == 1.0  # (1000 + 24) B a step
    assert read("crc.host_ms", ctx) == pytest.approx(((20 - 5) + (10 - 8) + (10 - 1) + (10 - 8)) / 2)
    assert read("run_point.wait_ms", ctx) == pytest.approx((10 + 30) / 2)
    assert read("run_point.host_ms", ctx) == pytest.approx(800 - 100 - 10 - 100 - 30)
    assert read("crc.device_idle_pct", ctx) == pytest.approx(100 * 9 / 800)
    assert metric_reader("device_idle_pct").read(ctx) == pytest.approx(100 * 109 / 800)


def test_a_point_without_crc_work_reads_no_crc_metric(monkeypatch):
    ctx = context(spans(crc=False), monkeypatch)
    assert [read(n, ctx) for n in NEW] == [None, None, None, 20.0, pytest.approx(560.0)]


def test_no_device_and_no_spans_read_nothing(monkeypatch):
    assert read("crc.device_idle_pct", context(spans(), monkeypatch, device=False)) is None
    ctx = context(spans()[:3], monkeypatch)  # the untraced point's alone
    assert [read(n, ctx) for n in NEW] == [None] * 5


def test_anchors_that_do_not_pair_read_nothing(monkeypatch):
    ctx = context(spans(), monkeypatch)
    ctx.trace.host = ctx.trace.host[:1]
    assert read("crc.device_idle_pct", ctx) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    ctx = context(spans(), monkeypatch)
    monkeypatch.setitem(sys.modules, "polardecoding_tpu_torch.utils.trace", None)
    assert [read(n, ctx) for n in NEW] == [None] * 5
