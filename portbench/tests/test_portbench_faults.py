"""The check, driven through a whole run on the CPU at a test size with the
timed path broken underneath, comes out false for each fault a cell can
have: a step that returns its state unchanged, half of the batch left out
with the count scaled up from the rest, and an answer altered where it is
produced.  (The cells run on one card: no exchange between cards to leave
out.)  Sound runs come out true (test_portbench_run.py)."""
import time

import pytest
import torch

from portbench.tests.conftest import make_cell


def stale(make):
    """Every call returns the first call's counters."""
    def build(preset, batch, device, **kw):
        step, first = make(preset, batch, device, **kw), []

        def broken(key, frame_start, sigma):
            out = step(key, frame_start, sigma)
            first.append(out)
            return first[0]
        return broken
    return build


def half_batch(make):
    """Decodes the first half of the batch and doubles its counters."""
    def build(preset, batch, device, **kw):
        step = make(preset, batch // 2, device, **kw)
        return lambda key, frame_start, sigma: tuple(
            2 * c for c in step(key, frame_start, sigma))
    return build


def flipped(decode):
    """Flips the first info bit of frame 0 in the decoder's answer."""
    def broken(llr, frozen, *args, **kw):
        out = decode(llr, frozen, *args, **kw)
        u = out[0] if isinstance(out, tuple) else out
        u = u.clone()
        pos = int(torch.nonzero(~frozen)[0])
        u[0, pos] ^= 1
        return (u, *out[1:]) if isinstance(out, tuple) else u
    return broken


@pytest.mark.parametrize("fault", ["stale", "half_batch", "flipped"])
@pytest.mark.parametrize("config", ["cascl_128_l8", "bp_128"])
def test_a_broken_step_is_not_correct(monkeypatch, config, fault):
    from polardecoding_tpu_torch.parallel import harness
    from portbench.run import run_cell

    if fault == "flipped":
        name = "cascl_decode" if config.startswith("cascl") else "bp_decode_auto"
        monkeypatch.setattr(harness, name, flipped(getattr(harness, name)))
    else:
        wrap = {"stale": stale, "half_batch": half_batch}[fault]
        monkeypatch.setattr(harness, "make_frame_step", wrap(harness.make_frame_step))
    out = run_cell(make_cell(config), 2**31 + 99, 0.5, False, "cpu",
                   time.perf_counter(), grace=5.0)
    assert out["correct"] is False, out["compared"]
    assert out["failed"] >= 1
