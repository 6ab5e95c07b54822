"""The early-stop engine's per-layer metrics: the fused wave kernel's work
(bp_wave_fused.roofline_pct) on a CPU window of the test-size early-stop
cell equals a brute-force count of the plain reference's CHKs over each
call's iterations, a drain counting only the slots still live; and the
run_point_waves.* readers read the program's wave spans in a traced
window, and nothing where the program has none."""
import contextlib

import pytest
import torch

from portbench.spec import metric_reader
from portbench.tests.conftest import make_cell

ROOF = metric_reader("bp_wave_fused.roofline_pct")
SPAN_METRICS = ["run_point_waves.build_ms", "run_point_waves.wait_ms",
                "run_point_waves.drain_ms"]
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def window():
    """A traced CPU window of the test-size early-stop cell (BP_1024_ES,
    batch 8), its profile dropped: (cell, window, the slots each call ran,
    counted apart from the benchmark's records: the batch on a step, the
    slots holding a frame not yet retired on a drain)."""
    from polardecoding_tpu_torch.parallel import harness
    from portbench.traffic import Traffic
    from portbench.waves import Program

    cell = make_cell("bp_1024_es", "tiny_es")
    built = harness.make_wave_step
    live = []

    def counting(*args, **kw):
        init, step, drain = built(*args, **kw)

        def step_c(key, sigma, carry):
            live.append(int(carry[0].shape[1]))
            return step(key, sigma, carry)

        def drain_c(sigma, carry):
            live.append(int(((carry[1] >= 0) & ~carry[4]).sum()))
            return drain(sigma, carry)
        return init, step_c, drain_c

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "make_wave_step", counting)
        prog = Program(cell.config, cell.traffic["batch"], "cpu")
        w = prog.window(Traffic(cell.traffic, SEED), 0.2, trace=True)
    w.profile = None
    return cell, w, live


def brute_chks(slots: int, N: int, iters: int) -> int:
    """The CHKs the plain reference's flooding BP (reference/bp.iterate)
    computes over `iters` iterations of `slots` frames, from a random
    state, a CHK counted once per iteration however often it is computed
    on the same operands."""
    from portbench.reference import bp
    from portbench.reference.chk import chk

    n = N.bit_length() - 1
    g = torch.Generator().manual_seed(slots * N + iters)
    Ls = [torch.randn(slots, N, generator=g) for _ in range(n + 1)]
    Rs = [torch.randn(slots, N, generator=g) for _ in range(n + 1)]
    count = 0
    for _ in range(iters):
        seen = []

        def counted(a, b):
            nonlocal count
            if not any(a.shape == x.shape and torch.equal(a, x) and torch.equal(b, y)
                       for x, y in seen):
                count += a.numel()
            seen.append((a, b))
            return chk(a, b)
        bp.iterate(Ls, Rs, 1, chk_fn=counted)
    return count


def test_the_wave_kernels_work_is_the_references_chks_on_the_live_slots(window):
    cell, w, live = window
    N, K = cell.config["code"]["N"], cell.config["decoder"]["wave_iters"]
    B = cell.traffic["batch"]
    n = N.bit_length() - 1
    assert len(live) == len(w.steps)
    assert ROOF.call_slots(w.steps, B) == live
    # drains whose slots are partly empty, so the live count is tested
    assert any(c.kind == "drain" and s < B for c, s in zip(w.steps, live))
    per_slot = brute_chks(1, N, K)
    assert per_slot == K * ROOF.chks_per_iteration(N)
    chks = {s: brute_chks(s, N, K) for s in set(live)}
    for (nbytes, ops), c, s in zip(ROOF.wave_work(w.steps, B, N, K), w.steps, live):
        assert ops == chks[s] * (ROOF.CHK_OPS + 1) + s * (n * N // 2 + N)
        state = 2 * (n + 1) * N * 4
        assert nbytes == s * (2 * state + (4 * N if c.kind == "step" else 0) + N + 1)


@pytest.mark.parametrize("N", [64, 1024])
def test_an_iterations_chks_are_counted_as_bp_decodes(N):
    """bp_decode.roofline_pct's count of a one-iteration decode."""
    from portbench.reference.step import Reference

    ref = Reference({"code": {"N": N, "K": N // 2}, "decoder": {"kind": "bp", "iters": 1},
                     "step": {"channel": "threefry"}}, "cpu")
    _, _, llr = ref.inputs(1024, 3.5, 0, 3)
    got = metric_reader("bp_decode.roofline_pct").counted_chks(ref, llr)
    assert got["chks"] == 3 * ROOF.chks_per_iteration(N)


def test_the_span_readers_read_a_traced_window(window):
    from portbench.context import Context

    cell, w, _ = window
    ctx = Context(cell.config, None, w, None, None, {"name": "cpu"})
    got = {m: metric_reader(m).read(ctx) for m in SPAN_METRICS}
    assert all(v is not None and v > 0 for v in got.values()), got
    # no device trace: the kernel's share is not read, not made up
    assert ROOF.read(ctx) is None


def test_the_span_readers_read_nothing_without_the_wave_spans(monkeypatch):
    """A program without spans in run_point_waves (`point` alone, as the
    frame path's) reads None."""
    from polardecoding_tpu_torch.parallel import harness
    from polardecoding_tpu_torch.utils import trace
    from portbench import spans
    from portbench.context import Context
    from portbench.traffic import Traffic
    from portbench.waves import Program

    class NoWaveSpans:
        def __getattr__(self, name):
            return getattr(trace, name)

        def span(self, name, *args, **kw):
            if name.startswith("waves."):
                return contextlib.nullcontext()
            return trace.span(name, *args, **kw)

    monkeypatch.setattr(harness, "trace", NoWaveSpans())
    cell = make_cell("bp_1024_es", "tiny_es")
    prog = Program(cell.config, cell.traffic["batch"], "cpu")
    w = prog.window(Traffic(cell.traffic, SEED), 0.2, trace=True)
    w.profile = None
    ctx = Context(cell.config, None, w, None, None, {"name": "cpu"})
    assert [s.name for s in spans.traced(ctx)] == ["point"]
    assert [metric_reader(m).read(ctx) for m in SPAN_METRICS] == [None] * 3


def test_the_early_stop_cell_takes_the_wave_entry_and_its_reference():
    """bp_1024_es.deep, as BENCHMARK.json gives it: the wave entry, the
    wave check, the plain early-stop reference and the wave metrics."""
    from portbench import entry, wave_check, waves
    from portbench.reference.bp_es import Reference
    from portbench.spec import load_cell

    cell = load_cell("bp_1024_es.deep")
    assert cell.chips == 1 and cell.config["preset"] == "BP_1024_ES"
    assert cell.config["reference"] == "bp_es"
    assert (cell.traffic["snr_db"], cell.traffic["batch"]) == (3.5, 16384)
    assert entry.checker(cell.config) is wave_check
    assert type(entry.reference(cell.config, "cpu")) is Reference
    assert type(entry.program(cell.config, 8, "cpu")) is waves.Program
    assert {m["name"] for m in cell.per_layer} == {"bp_wave_fused.roofline_pct", *SPAN_METRICS}
