"""The spans of run_point's wave path (run_point_waves, the fused early-stop
engine) on the CPU: under recording() a point is one tree, its `point`
span holding one `waves.build`, one `waves.step` a step, a `waves.read` a
counter read and a `waves.drain` a drain; a traced point gives the same
PointResult as an untraced one; and the point's counters and each frame's
retirement are those of the benchmark's plain early-stop reference
(portbench/reference/bp_es.py: plain PyTorch, each frame alone)."""
import dataclasses
import json
import os

import pytest
import torch

from polardecoding_tpu_torch.configs import preset
from polardecoding_tpu_torch.parallel import harness
from polardecoding_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "BP_1024_ES"
BATCH = 8
# a point of 16 steps (two chunks, the least a point runs) and 2 drains
SNR, SEED = 2.0, 1032


@pytest.fixture(scope="module")
def one_thread():
    """A point's tensors are [8, 1024]: one thread runs them as fast as
    several, and test workers side by side do not share out the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _point():
    return harness.run_point(preset(PRESET), SNR, batch=BATCH, device="cpu",
                             error_blocks=1, seed=SEED)


@pytest.fixture(scope="module")
def traced(one_thread):
    """(PointResult, spans, calls) of the point under recording(): calls
    lists each step and drain with the frames it retired and their
    iterations, read off the stepper's carry."""
    built = harness.make_wave_step
    calls = []

    def recorded(*args, **kw):
        init, step, drain = built(*args, **kw)

        def step_r(key, sigma, carry):
            carry, out = step(key, sigma, carry)
            fidx, iters, retire = carry[1], carry[2], carry[4]
            calls.append(("step", fidx[retire], iters[retire]))
            return carry, out

        def drain_r(sigma, given):
            live = (given[1] >= 0) & ~given[4]
            carry, out = drain(sigma, given)
            gone = live & (carry[1] < 0)
            calls.append(("drain", given[1][gone], carry[2][gone]))
            return carry, out
        return init, step_r, drain_r

    trace.clear()
    with pytest.MonkeyPatch.context() as mp, trace.recording():
        mp.setattr(harness, "make_wave_step", recorded)
        res = _point()
    spans = trace.spans()
    trace.clear()
    return res, spans, calls


def test_a_wave_point_is_one_tree_of_its_build_steps_reads_and_drains(traced):
    res, spans, calls = traced
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "point" and all(s.point == root.id for s in spans)
    assert all(s.parent == root.id for s in spans if s is not root)
    assert all(root.t0 <= s.t0 <= s.t1 <= root.t1 for s in spans)
    steps = sum(kind == "step" for kind, _, _ in calls)
    drains = len(calls) - steps
    chunk = harness.SYNC_EVERY
    assert steps % chunk == 0 and steps >= 2 * chunk and drains >= 1
    # a chunk's counters are read while the next chunk runs, the last's
    # after it
    want = (["waves.build"] + ["waves.step"] * chunk
            + (["waves.step"] * chunk + ["waves.read"]) * (steps // chunk - 1)
            + ["waves.read"] + ["waves.drain"] * drains)
    kids = sorted((s for s in spans if s is not root), key=lambda s: s.t0)
    assert [s.name for s in kids] == want
    assert kids[0].counts == {"batch": BATCH, "wave_iters": 8}
    assert all(s.anchored is False for s in kids)  # no profiler: no anchor


def test_a_traced_wave_point_counts_as_an_untraced_one(traced):
    trace.clear()
    res = _point()
    assert trace.spans() == []
    got, want = dataclasses.asdict(traced[0]), dataclasses.asdict(res)
    got.pop("elapsed_s"), want.pop("elapsed_s")
    assert got == want and got["errblock"] >= 1


def test_each_frame_retires_as_the_plain_reference_decides_it(traced):
    from portbench.reference.bp_es import Reference

    with open(os.path.join(ROOT, "portbench", "tests", "data", "bp_1024_es.json")) as f:
        ref = Reference(json.load(f), "cpu")
    res, _, calls = traced
    fidx = torch.cat([c[1] for c in calls])
    iters = torch.cat([c[2] for c in calls])
    # every frame handed out retired once: frames 0 .. frames - 1
    assert sorted(fidx.tolist()) == list(range(res.frames))
    at, eb, ebl = ref.frames(SEED, SNR, fidx, torch.full_like(fidx, ref.iters))
    assert torch.equal(at, iters)
    assert (res.errbit, res.errblock) == (int(eb.sum()), int(ebl.sum()))
