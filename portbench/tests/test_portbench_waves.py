"""The early-stop entry (run_point's wave path): its reference against the
port's plain wave engine, whole CPU runs of a test-size early-stop cell
(BP_1024_ES at batch 8), the check coming out false under each fault the
wave path can have, the control coming out false, and the refusals that keep
a configuration off a path its users do not run.  The cells run on one card:
no exchange between cards to leave out."""
import json
import os
import random
import time

import pytest
import torch

from portbench.tests.conftest import ROOT, make_cell

SEED = 2**31 + 41


def es_cell():
    """The test-size early-stop cell, with the per-layer metrics that read
    every entry."""
    cell = make_cell("bp_1024_es", "tiny_es")
    cell.per_layer = [m for m in cell.per_layer
                      if m["name"] in ("device_idle_pct", "run_point.wait_ms")]
    return cell


def run(cell=None, seed=SEED, trace=False):
    from portbench.run import run_cell

    return run_cell(cell or es_cell(), seed, 0.5, trace, "cpu",
                    time.perf_counter(), grace=20.0)


def test_the_reference_retires_each_frame_as_the_plain_wave_engine():
    """Frame by frame: the slots a step of make_wave_step(fused=False,
    engine="plain") retires are the frames whose reference retirement is
    that iteration, the others have not retired by it, and the step's
    counters are the reference's over its retirees."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import fold_in, prng_key
    from polardecoding_tpu_torch.parallel import harness
    from portbench.reference.bp_es import Reference

    cell = es_cell()
    ref = Reference(cell.config, "cpu")
    p = preset("BP_1024_ES")
    seed, snr, K = 1031, 1.5, 8
    init, step, _ = harness.make_wave_step(p, 8, K, "cpu", fused=False, engine="plain")
    key = fold_in(prng_key(seed, "cpu"), int(round(snr * 100)))
    sigma = 10.0 ** (-snr / 20.0)
    carry = init(key, 0, sigma)
    retired = 0
    for _ in range(16):
        fidx, iters = carry[1].clone(), carry[2].clone()
        carry, out = step(key, sigma, carry)
        gone = carry[2] == 0  # a retired slot restarts its count
        at, eb, ebl = ref.frames(seed, snr, fidx, iters + K)
        assert torch.equal(at[gone], iters[gone] + K)
        assert not bool((at[~gone] > 0).any())
        assert [int(c) for c in out] == [int(eb[gone].sum()), int(ebl[gone].sum()),
                                         int(gone.sum())]
        retired += int(gone.sum())
    assert retired > 8  # frames retired at several iterations, refills among them


def test_the_reference_counters_sum_its_frames():
    from portbench.reference.bp_es import Reference

    ref = Reference(es_cell().config, "cpu")
    fidx = torch.arange(5, 9)
    at, eb, ebl = ref.frames(7, 1.5, fidx, torch.full((4,), 100))
    assert bool((at % 8 == 0).all()) and bool((at > 0).all()) and int(at.max()) <= 104
    assert ref.counters(7, 1.5, 5, 4) == (int(eb.sum()), int(ebl.sum()), 0)


@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_of_the_wave_entry_is_correct(trace):
    from portbench import wave_check

    out = run(trace=trace)
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out["compared"]) == list(wave_check.LIMITS)
    assert all(c["value"] == 0 for c in out["compared"].values())
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert not any(k.endswith("_pct") for k in out["metrics"])
    else:
        assert set(out["metrics"]) == {"frames_per_s", "point_s_p95", "setup_s"}


def test_the_window_keeps_the_slots_of_a_few_calls():
    from portbench.traffic import Traffic
    from portbench.waves import Program

    from polardecoding_tpu_torch.parallel import harness

    built = harness.make_wave_step
    cell = es_cell()
    prog = Program(cell.config, cell.traffic["batch"], "cpu")
    w = prog.window(Traffic(cell.traffic, SEED), 0.2)
    kept = [i for i, c in enumerate(w.steps) if c.slots is not None]
    assert sorted(kept) == sorted(w.kept["final"] + w.kept["other"])
    assert len(w.kept["final"]) == 2 and len(w.kept["other"]) == 2
    assert all(w.steps[i].kind == "drain" or w.steps[i + 1].kind == "drain"
               for i in w.kept["final"])
    # run_point_waves gets its stepper from the harness module's own again
    assert harness.make_wave_step is built


def test_the_reservoir_keeps_k_of_the_stream_drawn_from_its_seed():
    from portbench.waves import Reservoir

    def draw(seed):
        dropped = []
        r = Reservoir(3, random.Random(seed), dropped.append)
        for i in range(50):
            r.offer(i)
        assert sorted(r.items + dropped) == list(range(50)) and len(r.items) == 3
        return r.items

    assert draw("a") == draw("a") and draw("a") != draw("b")


def test_each_wave_point_builds_its_stepper_and_gives_run_points_own_result(monkeypatch):
    """Each point of the window builds its stepper as run_point's wave path
    does for a user, with what run_point_waves asks for, and its result is
    run_point's own, unrecorded."""
    from polardecoding_tpu_torch.parallel import harness
    from portbench.traffic import Traffic
    from portbench.waves import Program

    asked = []
    built = harness.make_wave_step

    def counting(*args, **kw):
        asked.append((args[1:], kw))
        return built(*args, **kw)

    monkeypatch.setattr(harness, "make_wave_step", counting)
    cell = es_cell()
    prog = Program(cell.config, cell.traffic["batch"], "cpu")
    w = prog.window(Traffic(cell.traffic, SEED), 0.2)
    assert len(asked) == len(w.points) >= 1
    monkeypatch.setattr(harness, "make_wave_step", built)
    for p in w.points:
        res = harness.run_point(prog.preset, p.plan.snr_db, batch=p.plan.batch,
                                device="cpu", error_blocks=p.plan.error_blocks,
                                seed=p.plan.seed)
        got = p.result
        assert (got.errbit, got.errblock, got.frames) == (
            res.errbit, res.errblock, res.frames)


# --- faults planted under the harness -------------------------------------


def stale(make):
    """Every step returns the carry it was given."""
    def build(preset, batch, *args, **kw):
        init, step, drain = make(preset, batch, *args, **kw)
        return init, (lambda key, sigma, carry: (carry, step(key, sigma, carry)[1])), drain
    return build


def half_slots(make):
    """Decodes half the slots and doubles their counters."""
    def build(preset, batch, *args, **kw):
        init, step, drain = make(preset, batch // 2, *args, **kw)

        def step2(key, sigma, carry):
            carry, out = step(key, sigma, carry)
            return carry, tuple(2 * c for c in out)

        def drain2(sigma, carry):
            carry, out = drain(sigma, carry)
            return carry, (*(2 * c for c in out[:3]), out[3])
        return init, step2, drain2
    return build


def first_done(done, skip=None):
    s = done if skip is None else done & ~skip
    idx = torch.nonzero(s)
    return int(idx[0]) if len(idx) else None


def flipped(fused):
    """Flips an info bit of the first slot whose check passed."""
    from portbench.reference.code import info_set

    pos = int(info_set(1024, 512)[0])

    def broken(state, llr, retire, *args, **kw):
        state, u_hat, done = fused(state, llr, retire, *args, **kw)
        s = first_done(done)
        if s is not None:
            u_hat = u_hat.clone()
            u_hat[s, pos] ^= 1
        return state, u_hat, done
    return broken


def held_back(fused):
    """Holds back one wave the retirement of the first slot whose check
    passed (not the one held back the wave before)."""
    prev = [None]

    def broken(state, llr, retire, *args, **kw):
        state, u_hat, done = fused(state, llr, retire, *args, **kw)
        skip = None if prev[0] is None or prev[0].shape != done.shape else prev[0]
        s = first_done(done, skip)
        held = torch.zeros_like(done)
        if s is not None:
            done = done.clone()
            done[s] = False
            held[s] = True
        prev[0] = held
        return state, u_hat, done
    return broken


@pytest.mark.parametrize("fault", ["stale", "half_slots", "flipped", "held_back"])
def test_a_broken_wave_path_is_not_correct(monkeypatch, fault):
    from polardecoding_tpu_torch.parallel import harness

    if fault in ("stale", "half_slots"):
        wrap = {"stale": stale, "half_slots": half_slots}[fault]
        monkeypatch.setattr(harness, "make_wave_step", wrap(harness.make_wave_step))
    else:
        wrap = {"flipped": flipped, "held_back": held_back}[fault]
        monkeypatch.setattr(harness, "bp_wave_fused", wrap(harness.bp_wave_fused))
    out = run()
    assert out["correct"] is False, out["compared"]
    assert out["failed"] >= 1


def test_the_control_in_bfloat16_is_not_correct():
    from portbench import control

    rows = control.readings(es_cell(), [], [SEED + 1], 0.2, "cpu")
    assert rows[0]["kind"] == "control" and rows[0]["correct"] is False, rows


# --- refusals, and the frame-step entry as it was -------------------------


def with_config(**changes):
    cell = make_cell("bp_128")
    cell.config = {**cell.config, **changes}
    return cell


def test_an_early_stop_configuration_is_refused_on_the_frame_step(monkeypatch):
    from polardecoding_tpu_torch.parallel import harness
    from portbench.cell import Program

    built = []
    monkeypatch.setattr(harness, "make_frame_step", lambda *a, **k: built.append(a))
    cell = es_cell()
    cell.config = {k: v for k, v in cell.config.items()
                   if k != "reference"}
    with pytest.raises(ValueError, match="early-stop"):
        run(cell)
    with pytest.raises(ValueError, match="wave engine"):
        Program({**cell.config, "reference": "bp_es"}, 8, "cpu")
    assert not built


def test_the_step_reference_refuses_early_stop():
    from portbench.reference.step import Reference

    config = make_cell("bp_1024_es", "tiny_es").config
    with pytest.raises(ValueError, match="fixed iterations"):
        Reference(config, "cpu")


@pytest.mark.parametrize("changes,match", [
    ({"reference": "../step"}, "not a module name"),
    ({"reference": "chk"}, "has no Reference"),
    ({"reference": "bp_es"}, "early-stop BP"),
])
def test_a_reference_that_does_not_fit_is_refused(changes, match):
    with pytest.raises(ValueError, match=match):
        run(with_config(**changes))


def test_the_existing_configurations_keep_their_entry_and_reference():
    from portbench import check, entry
    from portbench.cell import Program
    from portbench.reference.step import Reference
    from portbench.spec import load_cell, load_json

    for w in load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]:
        config = load_cell(w["name"]).config
        assert "reference" not in config
        assert entry.checker(config) is check
        assert type(entry.reference(config, "cpu")) is Reference
        assert type(entry.program(config, 8, "cpu")) is Program


def test_an_early_stop_configuration_takes_the_wave_entry():
    from portbench import entry, wave_check, waves
    from portbench.reference.bp_es import Reference

    config = es_cell().config
    assert entry.checker(config) is wave_check
    assert type(entry.reference(config, "cpu")) is Reference
    assert type(entry.program(config, 8, "cpu")) is waves.Program


def test_the_frame_step_window_gives_run_points_own_results():
    """The window's points are what run_point gives with a frame step of
    its own, point by point."""
    from polardecoding_tpu_torch.parallel import harness
    from portbench.cell import Program
    from portbench.traffic import Traffic

    cell = make_cell("bp_128")
    prog = Program(cell.config, cell.traffic["batch"], "cpu")
    w = prog.window(Traffic(cell.traffic, SEED), 0.3)
    opts = {k: v for k, v in cell.config["step"].items() if k != "sync_every"}
    own = harness.make_frame_step(prog.preset, prog.batch, "cpu", **opts)
    for p in w.points:
        res = harness.run_point(prog.preset, p.plan.snr_db, batch=p.plan.batch,
                                device="cpu", step_fn=own,
                                error_blocks=p.plan.error_blocks, seed=p.plan.seed)
        got = p.result
        assert (got.errbit, got.errblock, got.frames, got.pm_ties) == (
            res.errbit, res.errblock, res.frames, res.pm_ties)
