"""Drives the program, polardecoding_tpu_torch, through one cell of the
frame-step entry: set-up, the window of BLER points through its run_point,
and the records that the check and the per-layer metrics read.  The window's
loop is every entry's; an entry's Program gives it `caller`
(portbench/waves.py is the early-stop entry's).

The program is imported inside `Program`, never at module level, so the
harness's other parts (traffic, check, reference) load without it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from portbench.traffic import Point, Traffic

TRACE_SLICE = "portbench.trace_slice"
# the decoder and code settings of a configuration file that the program's
# preset has to carry, and the preset's attribute holding each
CODE_KEYS = ("N", "K", "crc", "crc_style", "construction", "graph")
DECODER_KEYS = {"kind": "kind", "list_size": "list_size", "iters": "bp_iters",
                "flavor": "bp_flavor", "r1": "scl_r1",
                "early_stop": "bp_early_stop"}


class Overrun(RuntimeError):
    """A point ran past the window's end by more than the grace."""


@dataclasses.dataclass
class StepRec:
    point: int
    frame_start: int
    out: tuple
    t0: float
    t1: float


@dataclasses.dataclass
class PointRec:
    plan: Point
    result: object  # the program's PointResult, None if the point raised
    t0: float
    t1: float
    first: int  # its steps are window.steps[first:last]
    last: int


@dataclasses.dataclass
class Window:
    points: list
    steps: list
    t_start: float
    t_end: float
    error: Optional[str] = None
    profile: object = None  # torch.profiler.profile over the traced points
    traced: tuple = ()  # the traced points' indices
    kept: Optional[dict] = None  # an entry's records for its check

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    def counts(self) -> list:
        """[[errbit, errblock, pm_ties]] of every step, as the step
        returned them (read once the window has closed)."""
        if not self.steps:
            return []
        return torch.stack([torch.stack([torch.as_tensor(c).reshape(())
                                         for c in s.out]) for s in self.steps]
                           ).cpu().tolist()


def preset_differences(preset, config: dict) -> list:
    """Where the program's preset departs from the configuration file."""
    out = []
    for key in CODE_KEYS:
        if key in config["code"]:
            want, got = config["code"][key], getattr(preset.code, key)
            if key == "crc":
                want, got = tuple(want or ()), tuple(got or ())
            if want != got:
                out.append(f"code.{key}: preset {got!r}, configuration {want!r}")
    for key, attr in DECODER_KEYS.items():
        if key in config["decoder"]:
            want, got = config["decoder"][key], getattr(preset.decoder, attr)
            if want != got:
                out.append(f"decoder.{key}: preset {got!r}, configuration {want!r}")
    return out


def load_preset(config: dict):
    """The program's preset that the configuration names, refused where it
    departs from the configuration's code and decoder."""
    from polardecoding_tpu_torch.configs import preset

    got = preset(config["preset"])
    wrong = preset_differences(got, config)
    if wrong:
        raise ValueError(f"preset {config['preset']} is not the "
                         f"configuration {config['name']}: {wrong}")
    return got


def early_stop(preset) -> bool:
    """Whether run_point hands the preset to the wave engine when it is
    given no frame step (an early-stop BP preset)."""
    return preset.decoder.kind == "bp" and preset.decoder.bp_early_stop


class Program:
    """The system under test for one configuration and one batch: its
    frame step, built once, and its run_point."""

    def __init__(self, config: dict, batch: int, device):
        from polardecoding_tpu_torch.parallel import harness

        self.preset = load_preset(config)
        if early_stop(self.preset):
            raise ValueError(f"{config['name']}: users run an early-stop "
                             "preset through run_point's wave engine, not a "
                             "frame step (portbench/waves.py)")
        opts = dict(config.get("step", {}))
        self.sync_every = int(opts.pop("sync_every", 1))
        self.device = torch.device(device)
        self.batch = batch
        self.run_point = harness.run_point
        self.step = harness.make_frame_step(self.preset, batch, self.device, **opts)

    def warm(self, traffic: Traffic) -> None:
        """traffic.warmup_steps steps through run_point at the mix's SNR,
        on a seed outside the pool, then a synchronisation."""
        self.run_point(self.preset, traffic.snr_db, batch=self.batch,
                       device=self.device, step_fn=self.step, error_blocks=1 << 62,
                       max_frames=traffic.warmup_steps * self.batch,
                       seed=traffic.base - 1, sync_every=self.sync_every)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, traffic: Traffic, seconds: float, trace: bool = False,
               grace: float = 30.0) -> Window:
        """Points back to back until `seconds` have passed; the point in
        flight at the deadline runs to its end, unless it is still running
        `grace` seconds later (Overrun: the window records the error).
        With trace, torch.profiler covers the points traffic.trace names,
        and the window lasts until they are done."""
        steps, points = [], []
        cur = [0]
        hard = [float("inf")]

        def overran(t1):
            if t1 > hard[0]:
                raise Overrun(f"point {cur[0]} still running {grace} s after "
                              "the window's end")

        first = int(traffic.trace["from_point"])
        traced = tuple(range(first, first + int(traffic.trace["points"]))) if trace else ()
        stack = contextlib.ExitStack()
        w = Window(points, steps, 0.0, 0.0, traced=traced)
        call = self.caller(w, cur, overran, traffic)
        t_start = time.perf_counter()
        deadline = t_start + seconds
        hard[0] = deadline + grace
        i = 0
        try:
            while True:
                if traced and i == traced[0]:
                    w.profile = _start_profile(stack)
                plan = traffic.point(i)
                cur[0] = i
                n0 = len(steps)
                t0 = time.perf_counter()
                try:
                    res = call(plan)
                finally:
                    t1 = time.perf_counter()
                    points.append(PointRec(plan, None, t0, t1, n0, len(steps)))
                points[-1].result = res
                if traced and i == traced[-1]:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    stack.close()
                i += 1
                if t1 >= deadline and (not traced or i > traced[-1]):
                    break
        except Exception as e:  # the run reports it, as a failed point
            w.error = f"{type(e).__name__}: {e}"
        finally:
            stack.close()
        w.t_start, w.t_end = t_start, points[-1].t1
        return w

    def caller(self, w: Window, cur: list, overran, traffic: Traffic):
        """plan -> the program's PointResult of one point: run_point with
        the frame step, each step's call recorded in w.steps (point cur[0])
        and overran(its return time) called after it."""
        def step(key, frame_start, sigma):
            t0 = time.perf_counter()
            out = self.step(key, frame_start, sigma)
            t1 = time.perf_counter()
            w.steps.append(StepRec(cur[0], int(frame_start), out, t0, t1))
            overran(t1)
            return out

        def call(plan: Point):
            return self.run_point(self.preset, plan.snr_db, batch=plan.batch,
                                  device=self.device, step_fn=step,
                                  error_blocks=plan.error_blocks,
                                  seed=plan.seed, sync_every=self.sync_every)
        return call


def _start_profile(stack: contextlib.ExitStack):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = stack.enter_context(profile(activities=acts))
    stack.enter_context(record_function(TRACE_SLICE))
    return prof
