"""The benchmark's configuration SCL_1024_L8_FASTR1 on the CPU: its plain
reference (portbench/reference/scl_r1.py) gives the counters of the port's
plain frame step on the same frames, differs from exact SCL where the
rate-1 rule does and equals the numpy twin tests/scl_fast_ref.py there,
refuses what it does not model and reads other counters in bfloat16; the
port's span decode.list and its counts; the new metrics' work counts and
readers; and the reference's imports."""
import json
import os
import subprocess
import sys

import pytest
import torch
from scl_fast_ref import decode_batch

from portbench.cell import PointRec, StepRec, Window
from portbench.context import Context
from portbench.reference import scl, step
from portbench.reference.scl_r1 import Reference, decompose, scl_r1_decode
from portbench.spec import ROOT, load_cell, load_json, metric_reader
from portbench.tracing import Trace
from portbench.traffic import Point, Traffic
from polardecoding_tpu_torch.configs import preset
from polardecoding_tpu_torch.models.scl import scl_decode_auto
from polardecoding_tpu_torch.ops.channel import fold_in, prng_key
from polardecoding_tpu_torch.parallel.harness import make_frame_step
from polardecoding_tpu_torch.utils import trace

CELL = "scl_1024_l8_fastr1.deep"
ROOFLINE = metric_reader("scl_decode_r1.roofline_pct")
FRAMES_PER_SM = metric_reader("scl_decode_r1.frames_per_sm")
EXACT = metric_reader("scl_decode.roofline_pct")
FLAVOR = {"kind": "scl", "list_size": 8, "r1": 4, "wloop": 2}
# (preset, code, batch, (seed, SNR, first frame) points)
CASES = [
    ("SCL_128_L8_FASTR1", {"N": 128, "K": 64}, 64,
     [(1024, 1.0, 0), (2**33 + 5, 0.5, 12_345_678), (2**31 + 77, 2.0, 2**31 - 3)]),
    ("SCL_1024_L8_FASTR1", {"N": 1024, "K": 512}, 8,
     [(1024, 1.0, 0), (2**31 + 77, 1.5, 2**31 - 3)]),
]


def config(code=None, **decoder):
    return {"name": "test", "code": code or {"N": 128, "K": 64},
            "decoder": {**FLAVOR, **decoder}, "step": {"channel": "threefry"}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of small tensor operations: one thread runs them as fast
    as several, and test workers side by side do not share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mask_1024():
    return Reference(config({"N": 1024, "K": 512}), "cpu").code.frozen


@pytest.mark.parametrize("name,code,batch,points", CASES, ids=[c[0] for c in CASES])
def test_reference_counters_are_the_plain_steps(name, code, batch, points):
    step_fn = make_frame_step(preset(name), batch, "cpu")
    ref = Reference(config(code), "cpu")
    seen = 0
    for seed, snr, start in points:
        key = fold_in(prng_key(seed, "cpu"), int(round(snr * 100)))
        got = tuple(int(c) for c in step_fn(key, start, float(10 ** (-snr / 20))))
        want = ref.counters(seed, snr, start, batch)
        assert got == want, (seed, snr, start)
        seen += want[1]
    assert seen > 0


@pytest.mark.parametrize("step_db", [None, 1.0], ids=["raw", "rounded"])
def test_the_flavor_departs_from_exact_scl_and_is_the_twins(step_db):
    """At -1 dB the rate-1 rule decides other frames than exact SCL, and
    its u_all, path metrics and tie counters are the twin's r1 mode's on
    the same LLRs; LLRs rounded to whole numbers make its forks tie."""
    ref = Reference(config(), "cpu")
    _, _, llr = ref.inputs(77, -1.0, 0, 16)
    if step_db:
        llr = torch.round(llr / step_db) * step_db
    fr = ref.code.frozen
    got = scl_r1_decode(llr, fr, 8, 4, 2)
    want = decode_batch(llr.numpy(), fr.numpy(), 8, wloop=2, r1min=4)
    for g, w in zip(got, want):
        assert (g.numpy() == w).all()
    assert (int(got[2].sum()) > 0) == bool(step_db)
    exact = scl.cascl_select(*scl.scl_decode(llr, fr, 8)[:2], ref.code.info, None)
    assert (ref.decode(llr)[0] != exact).any(dim=-1).sum() > 0


@pytest.mark.parametrize("change", [
    {"decoder": {**FLAVOR, "r1": 0}},
    {"decoder": {"kind": "bp", "iters": 5}},
    {"decoder": {**FLAVOR, "early_stop": True}},
    {"decoder": {**FLAVOR, "kind": "cascl"}},
    {"step": {"channel": "mc"}},
], ids=["exact", "bp", "early_stop", "cascl", "mc_channel"])
def test_the_reference_refuses_what_it_does_not_model(change):
    with pytest.raises(ValueError):
        Reference({**config(), **change}, "cpu")
    with pytest.raises(ValueError):
        step.Reference(config(), "cpu")


def test_the_control_in_bfloat16_differs():
    ref = Reference(config(), "cpu")
    for seed in (11, 12):
        f32 = ref.counters(seed, 1.5, 0, 256)
        assert f32 != ref.counters(seed, 1.5, 0, 256, dtype=torch.bfloat16), (seed, f32)


@pytest.mark.parametrize("r1", [0, 4])
def test_decode_list_span_counts_the_r1_nodes(r1, mask_1024):
    nodes = [(s, off) for kind, s, off in decompose(mask_1024.tolist(), r1, 2)
             if kind == "r1"]
    assert (len(nodes) > 0) == (r1 > 0)
    llr = Reference(config({"N": 1024, "K": 512}), "cpu").inputs(5, 2.0, 0, 2)[2]
    trace.clear()
    with trace.recording():
        traced = scl_decode_auto(llr, mask_1024, 8, return_all=True,
                                 return_ties=True, r1=r1)
    spans = trace.spans()
    trace.clear()
    (sp,) = [s for s in spans if s.name == "decode.list"]
    assert sp.counts == {"r1": r1, "r1_nodes": len(nodes),
                         "r1_bits": sum(1 << s for s, _ in nodes)}
    plain = scl_decode_auto(llr, mask_1024, 8, return_all=True, return_ties=True, r1=r1)
    assert trace.spans() == []
    for a, b in zip(traced, plain):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.parametrize("r1", [0, 4])
def test_the_flavors_work_is_exact_scls_at_r1_0_and_chip_smokes(chip_smoke, r1, mask_1024):
    frozen = mask_1024.tolist()
    got = ROOFLINE.scl_work(16384, 1024, 8, frozen, r1, 2)
    assert got == chip_smoke.scl_work(16384, 1024, 8, frozen, r1)
    if r1 == 0:
        assert got == EXACT.scl_work(16384, 1024, 8, frozen)
    else:
        assert got[1] < EXACT.scl_work(16384, 1024, 8, frozen)[1]


def _ctx(device, cell_config, batch=4):
    """A Context of one traced point of two steps whose device events are
    `device` [(name, start_us, end_us)]."""
    plan = Point(0, 1024, 3.0, batch, 200)
    steps = [StepRec(0, k * batch, (), 0.0, 0.0) for k in range(2)]
    win = Window([PointRec(plan, None, 0.0, 1.0, 0, 2)], steps, 0.0, 1.0, traced=(0,))
    return Context(cell_config, None, win, Trace(0.0, 1e6, device, []),
                   Reference(cell_config, "cpu"), {"name": "test", "power_limit": "n/a"})


def test_the_roofline_reads_the_flavors_launches_alone():
    cfg = config({"N": 1024, "K": 512})
    true_ = "void (anonymous namespace)::scl_decode_kernel<true, 10, 8>(float const*)"
    false_ = "void (anonymous namespace)::scl_decode_kernel<false, 10, 8>(float const*)"
    ctx = _ctx([(true_, 0.0, 5000.0), (false_, 6000.0, 9000.0), (true_, 10000.0, 15000.0)], cfg)
    frozen = ctx.reference.code.frozen.tolist()
    from portbench.peaks import least_seconds

    least = 2 * least_seconds(*ROOFLINE.scl_work(4, 1024, 8, frozen, 4, 2))
    assert ROOFLINE.read(ctx) == pytest.approx(100 * least / 0.01, rel=1e-12)
    assert ROOFLINE.read(_ctx([(false_, 0.0, 5000.0), (false_, 6000.0, 9000.0)], cfg)) is None


def test_frames_per_sm_reads_the_decode_list_spans(monkeypatch):
    S = trace.Span
    counts = {"r1": 4, "r1_nodes": 49, "r1_bits": 300}
    spans = [S("step.decode", 1, None, 1, 0, 9),
             S("decode.list", 2, 1, 1, 1, 8, {**counts, "frames_per_sm": 10})]
    monkeypatch.setattr(FRAMES_PER_SM.spans, "traced", lambda ctx: spans)
    assert FRAMES_PER_SM.read(None) == 10
    spans[1] = S("decode.list", 2, 1, 1, 1, 8, counts)  # the plain path's
    assert FRAMES_PER_SM.read(None) is None
    monkeypatch.setattr(FRAMES_PER_SM.spans, "traced", lambda ctx: None)
    assert FRAMES_PER_SM.read(None) is None


def test_the_cell_takes_the_preset_and_the_flavors_reference():
    from portbench import entry
    from portbench.cell import load_preset

    cell = load_cell(CELL)
    assert isinstance(entry.reference(cell.config, "cpu"), Reference)
    assert load_preset(cell.config).decoder.scl_r1 == cell.config["decoder"]["r1"] == 4
    assert Traffic(cell.traffic, 2**31 + 11).point(0).batch == 16384
    assert {m["name"] for m in cell.per_layer} == {
        "scl_decode_r1.roofline_pct", "scl_decode_r1.frames_per_sm"}
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    (entry_,) = [c for c in bench["configs"] if c["name"] == "scl_1024_l8_fastr1"]
    assert len(entry_["source"]) <= 200 and entry_["reduced"] == []


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, json, portbench.reference.scl_r1\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "polardecoding_tpu",
                        "polardecoding_tpu_torch", "tests", "scl_fast_ref"}
