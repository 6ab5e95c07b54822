"""The port's spans (polardecoding_tpu_torch.utils.trace) on the CPU: off
by default with the counts unchanged, one tree a BLER point under
recording(), the CRC copies' bytes, the clock anchors under torch.profiler,
and `cli run --trace`."""
import dataclasses
import json

import numpy as np
import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from polardecoding_tpu_torch import cli as tcli
from polardecoding_tpu_torch.configs import preset
from polardecoding_tpu_torch.ops.crc import check_matrix, multiplicative_encode_matrix
from polardecoding_tpu_torch.parallel.harness import run_point
from polardecoding_tpu_torch.utils import trace

CASCL = "CASCL_128_L8"  # N=128, K=64, CRC-6
STEPS = 2
BATCH = 8
STEP_SPANS = ["step.payload", "step.crc_encode", "step.encode", "step.channel",
              "step.decode", "step.count"]


def _point(name=CASCL, steps=STEPS, step_fn=None):
    """One run_point of `steps` steps at 1.0 dB on the CPU: its counts."""
    res = run_point(preset(name), 1.0, batch=BATCH, device="cpu", step_fn=step_fn,
                    error_blocks=1 << 30, max_frames=steps * BATCH, seed=7)
    return res.errbit, res.errblock, res.frames, res.pm_ties


@pytest.fixture(scope="module")
def recorded():
    """(counts, spans) of one CA-SCL point under recording()."""
    trace.clear()
    with trace.recording():
        counts = _point()
    out = trace.spans()
    trace.clear()
    return counts, out


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.t0)


def test_off_records_nothing_and_counts_as_on(recorded):
    trace.clear()
    counts = _point()
    assert trace.spans() == []
    assert counts == recorded[0] and counts[2] == STEPS * BATCH


def test_each_point_is_one_tree(recorded):
    spans = recorded[1]
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "point" and all(s.point == root.id for s in spans)
    for s in spans:
        assert s.t0 <= s.t1
        if s is not root:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s.name, p.name)
    # the step is built in the point: its two CRC matrices' copies come first
    assert [s.name for s in _children(spans, root)] == (
        ["crc.h2d"] * 2 + ["point.step", "point.read"] * STEPS)
    for step in (s for s in spans if s.name == "point.step"):
        assert [s.name for s in _children(spans, step)] == STEP_SPANS
        (dec,) = [s for s in _children(spans, step) if s.name == "step.decode"]
        assert [s.name for s in _children(spans, dec)] == ["decode.crc_select"]


def test_the_crc_matrices_are_copied_when_the_step_is_built_not_in_a_step(recorded):
    # run_point builds the step inside its `point` span: the encode and
    # check matrices go to the device there, once, and no step copies one
    spans = recorded[1]
    code = preset(CASCL).code
    want = (multiplicative_encode_matrix(code.crc, code.K).astype(np.float32).nbytes
            + check_matrix(code.crc, code.num_info).astype(np.float32).nbytes)
    by_id = {s.id: s for s in spans}

    def in_step(s):
        while s.parent is not None:
            s = by_id[s.parent]
            if s.name == "point.step":
                return True
        return False

    copies = [s for s in spans if s.name == "crc.h2d"]
    assert not [s for s in copies if in_step(s)]
    assert len(copies) == 2 and sum(s.counts["bytes"] for s in copies) == want


def _bp_one_iteration():
    """BP_128 at one iteration: few operations on the CPU."""
    p = preset("BP_128")
    return dataclasses.replace(p, decoder=dataclasses.replace(p.decoder, bp_iters=1))


def test_bp_records_no_crc_span():
    trace.clear()
    with trace.recording():
        run_point(_bp_one_iteration(), 3.0, batch=4, device="cpu",
                  error_blocks=1 << 30, max_frames=4, seed=7)
    names = [s.name for s in trace.spans()]
    trace.clear()
    assert "point.step" in names and "step.decode" in names
    assert not [n for n in names if "crc" in n]


def test_anchors_are_host_events_and_map_the_spans_onto_the_profiler():
    # an enclosing range, as a benchmark's, takes the profiler's cost of
    # its first range off the first anchor
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof, record_function("slice"):
        run_point(_bp_one_iteration(), 1.0, batch=BATCH, device="cpu",
                  error_blocks=1 << 30, max_frames=STEPS * BATCH, seed=7)
    spans = trace.spans()
    trace.clear()
    names = {s.name for s in spans} | {trace.ANCHOR}
    events = prof.events()
    anchors = [e for e in events if e.name == trace.ANCHOR]
    assert len(anchors) == STEPS and sum(s.anchored for s in spans) == STEPS
    assert all(e.device_type == DeviceType.CPU for e in anchors)
    assert not [e for e in events if e.device_type != DeviceType.CPU and e.name in names]
    mapped = trace.on_profiler_clock(
        spans, [(e.time_range.start, e.time_range.end) for e in anchors])
    matmuls = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == "aten::matmul"]
    encodes = [(a, b) for s, a, b in mapped if s.name == "step.encode"]
    assert len(encodes) == STEPS
    for a, b in encodes:
        assert len([m for m in matmuls if a <= m[0] and m[1] <= b]) == 1


def test_on_profiler_clock_takes_the_nearest_preceding_anchor():
    S = trace.Span
    spans = [S("a", 1, None, 1, 1000, 5000, None, True),
             S("b", 2, 1, 1, 2000, 3000),
             S("c", 3, None, 3, 9000, 12000, None, True),
             S("d", 4, 3, 3, 11000, 11500),
             S("e", 5, None, 5, 500, 600),
             S("f", 6, None, 6, 20000, 21000, None, True)]
    # the profiler's clock runs 100 us ahead of the host's, then 101 us; the
    # third anchor, held 40 times the median, is not used
    anchors = [(100.5, 101.5), (109.5, 110.5), (111.0, 151.0)]
    mapped = {s.name: (a, b) for s, a, b in trace.on_profiler_clock(spans, anchors)}
    assert mapped == {"a": (101, 105), "b": (102, 103), "c": (110, 113),
                      "d": (112, 112.5), "e": (100.5, 100.6), "f": (121, 122)}
    with pytest.raises(ValueError):
        trace.on_profiler_clock(spans, anchors[:2])


def test_cli_run_trace_writes_a_chrome_trace(tmp_path, capsys):
    path = tmp_path / "spans.json"
    tcli.main(["run", "--preset", CASCL, "--snr", "1.0", "--batch", str(BATCH),
               "--error-blocks", "1000000", "--max-frames", str(BATCH),
               "--device", "cpu", "--trace", str(path)])
    assert json.loads(capsys.readouterr().out)[0]["frames"] == BATCH
    events = json.loads(path.read_text())["traceEvents"]
    assert {e["name"] for e in events} == {"point", "point.step", "point.read",
                                           "decode.crc_select", "crc.h2d", *STEP_SPANS}
    assert all(e["ph"] == "X" and e["dur"] >= 0 and e["ts"] >= 0 for e in events)
    # run_sweep builds the step before its points: the CRC matrices' two
    # copies are spans of their own, every other span lies in a point
    points = {e["args"]["id"] for e in events if e["name"] == "point"}
    outside = [e for e in events if e["args"]["point"] not in points]
    assert [e["name"] for e in outside] == ["crc.h2d"] * 2
    assert all(e["args"]["point"] == e["args"]["id"] for e in outside)
    trace.clear()
    _point(steps=1)
    assert trace.spans() == []
