"""The early-stop entry of the program, which an early-stop BP
configuration takes (portbench/entry.py): the window of BLER points through
run_point without a frame step, which hands an early-stop BP preset to
run_point_waves on the fused wave engine, as run_sweep and cli do for their
users.

Each point builds its wave stepper as a user's call does: while a point
runs, the harness module's make_wave_step is replaced by a wrapper that
calls the original with whatever run_point_waves asks for and records the
stepper's step and drain; the original comes back when the point returns.
run_point, its `point` span, the stepper's build and run_point_waves' stop
rule, drain and counter reads run as a user's call runs them.

Every call of the stepper's step and drain is recorded (Call): its point,
its counters as it returned them, and the slots it names.  The slots are
tensors of the carry it returned (a drain's also of the carry it was given),
held by reference: recording adds no device operation and no
synchronisation to the window.  Slots are kept for at most
check.final_steps + check.other_steps + 1 calls at once: two reservoirs
drawn from the run's seed, one over the points' final calls (a point's last
step and its drains), one over the other steps, and the newest step until
the next call says whether it was its point's last.  What recording keeps
on the card: 2 KiB a call (at most four 0-dim int64 tensors, in the
allocator's 512-byte blocks), and B x 17 bytes for a kept step's slots,
B x 25 for a kept drain's (B the batch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Optional

import torch

from portbench.cell import Program as FrameProgram
from portbench.cell import Window, early_stop, load_preset
from portbench.traffic import Point, Traffic

# the fused stepper's carry (harness.make_wave_step, fused=True):
# (state, slot frame indices, iterations done, next frame index, retire
# mask, first refill index)
FIDX, ITERS, NEXT, RETIRE = 1, 2, 3, 4


@dataclasses.dataclass
class Call:
    """One call of the stepper.  out: (errbit, errblock, frames) of a step,
    (errbit, errblock, frames, remaining) of a drain; next_fidx: a step's
    next frame index (0-dim).  slots, while kept: a step's (frame indices,
    retire mask, iterations done) after it; a drain's (frame indices and
    retire mask it was given, frame indices and iterations done after
    it)."""
    point: int
    kind: str  # "step" or "drain"
    out: tuple
    t0: float
    t1: float
    next_fidx: object = None
    slots: Optional[tuple] = None


class Reservoir:
    """k of a stream's items drawn uniformly by `rng` (algorithm R); `drop`
    is called on each item that leaves."""

    def __init__(self, k: int, rng: random.Random, drop):
        self.k, self.rng, self.drop = int(k), rng, drop
        self.seen = 0
        self.items: list = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j], item = item, self.items[j]
        self.drop(item)


class Recorder:
    """Wraps each stepper built in the window (wrap) so that every call of
    its step and drain is recorded in w.steps (point cur[0]) and
    overran(its return time) is called after it; w.kept holds the
    reservoirs' calls and the program's counter-read chunk."""

    def __init__(self, w: Window, cur: list, overran, traffic: Traffic,
                 chunk: int):
        self._step = self._drain = None
        self.w, self.cur, self.overran = w, cur, overran
        rng = random.Random(f"{traffic.seed}:wave-check")
        self.final = Reservoir(traffic.check["final_steps"], rng, self.drop)
        self.other = Reservoir(traffic.check["other_steps"], rng, self.drop)
        self.newest = None  # the newest step's index while a point steps
        w.kept = {"final": self.final.items, "other": self.other.items,
                  "chunk": chunk}

    def drop(self, i: int) -> None:
        self.w.steps[i].slots = None

    def add(self, call: Call) -> None:
        i = len(self.w.steps)
        self.w.steps.append(call)
        if call.kind == "step":
            if self.newest is not None:
                self.other.offer(self.newest)
            self.newest = i
            return
        if self.newest is not None:
            self.final.offer(self.newest)
            self.newest = None
        self.final.offer(i)

    def step(self, key, sigma, carry):
        t0 = time.perf_counter()
        carry, out = self._step(key, sigma, carry)
        t1 = time.perf_counter()
        self.add(Call(self.cur[0], "step", out, t0, t1, carry[NEXT],
                      (carry[FIDX], carry[RETIRE], carry[ITERS])))
        self.overran(t1)
        return carry, out

    def drain(self, sigma, given):
        t0 = time.perf_counter()
        carry, out = self._drain(sigma, given)
        t1 = time.perf_counter()
        self.add(Call(self.cur[0], "drain", out, t0, t1, None,
                      (given[FIDX], given[RETIRE], carry[FIDX], carry[ITERS])))
        self.overran(t1)
        return carry, out

    def wrap(self, stepper: tuple) -> tuple:
        """(init, step, drain) of a stepper just built, step and drain
        recorded (a point's calls go to its own stepper)."""
        init, self._step, self._drain = stepper
        return init, self.step, self.drain


class Program(FrameProgram):
    """The system under test for an early-stop configuration and one batch:
    run_point's wave path, each point building its own stepper.  The
    window's loop is the frame-step Program's."""

    def __init__(self, config: dict, batch: int, device):
        from polardecoding_tpu_torch.parallel import harness

        self.preset = load_preset(config)
        if not early_stop(self.preset):
            raise ValueError(f"{config['name']}: run_point takes its wave path "
                             "for an early-stop BP preset only")
        self.device = torch.device(device)
        self.batch = batch
        self.harness = harness
        self.run_point = harness.run_point
        self.chunk = harness.SYNC_EVERY

    @contextlib.contextmanager
    def recording(self, rec: Recorder):
        """While open, each stepper that run_point_waves builds is the one
        make_wave_step builds, its calls recorded by `rec`."""
        h = self.harness
        built = h.make_wave_step

        def make_wave_step(*args, **kw):
            return rec.wrap(built(*args, **kw))

        h.make_wave_step = make_wave_step
        try:
            yield
        finally:
            h.make_wave_step = built

    def warm(self, traffic: Traffic) -> None:
        """Points' steps and drains through run_point at the mix's SNR, on a
        seed outside the pool, to traffic.warmup_steps batches of frames
        (the counters lag a chunk, so at least two chunks run), then a
        synchronisation."""
        self.run_point(self.preset, traffic.snr_db, batch=self.batch,
                       device=self.device, error_blocks=1 << 62,
                       max_frames=traffic.warmup_steps * self.batch,
                       seed=traffic.base - 1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def caller(self, w: Window, cur: list, overran, traffic: Traffic):
        """plan -> the program's PointResult: run_point with no frame step,
        the stepper it builds recording its calls."""
        rec = Recorder(w, cur, overran, traffic, self.chunk)

        def call(plan: Point):
            with self.recording(rec):
                return self.run_point(self.preset, plan.snr_db, batch=plan.batch,
                                      device=self.device,
                                      error_blocks=plan.error_blocks,
                                      seed=plan.seed)
        return call
