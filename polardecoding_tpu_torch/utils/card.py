"""The card a measurement ran on, and kernel times by CUDA events."""
from __future__ import annotations

import subprocess
import time

import torch


def card_line() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1):
    """Mean milliseconds per call of fn on the card, by CUDA events around
    `reps` calls after `warmup` calls, and the output of the last warmup
    call."""
    out = None
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, out


# cycles of the sleep kernel ahead of a queued timing: about 10 ms at the
# H100's 1.98 GHz, above the host's time to enqueue a few dozen calls
SLEEP_CYCLES = 20_000_000


def queued_ms(fn, reps: int, warmup: int = 1):
    """Mean device milliseconds per call of fn, by CUDA events around `reps`
    calls enqueued behind a sleep kernel (torch.cuda._sleep), so that the
    host's time to enqueue them (35-55 us a call) is hidden: what a kernel
    shorter than that costs the card when calls come back to back.  Returns
    (ms, the output of the last warmup call).  The sleep doubles until it
    outlasts the enqueue, which a gap between the sleep's end and the start
    event would otherwise add."""
    out = None
    for _ in range(warmup):
        out = fn()
    cycles = SLEEP_CYCLES
    for _ in range(6):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        t0 = time.perf_counter()
        stop.synchronize()
        # the host waited longer than the calls ran: it had enqueued every
        # call before the sleep ended
        ms = start.elapsed_time(stop)
        if (time.perf_counter() - t0) * 1e3 > ms:
            return ms / reps, out
        cycles *= 2
    raise RuntimeError("queued_ms: the host enqueues slower than the sleep "
                       "kernel runs")
