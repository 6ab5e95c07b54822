#!/usr/bin/env python3
"""The launch floor on the card, the port of scripts/probe_floor3.py.

The body is probe_floor3's bare_call: ops/probe_kernel.floor_cuda with no
shared memory beyond the LLR row and two outputs, N=1024, L=8, one warp per
frame; C is the TPU probe's grid size (128 frames per step), so B = 128 C.
  C64, C128, C512  one launch per call at B = 8192, 16384, 65536;
  C4_x10, C64_x10  ten launches back to back on one stream per call
                   (the TPU probe's ten calls inside one jit);
  C64_scan20       one replay of a CUDA graph of twenty launches per call
                   (its lax.scan of twenty).

  python scripts/torch_probe_floor3.py [iters] [reps]

Prints JSON lines: compile_plus_first_s per variant; then per variant the
best of `reps` windows of `iters` calls: ms_per_jit_call (per call, by CUDA
events after a warmup call), ms_per_inner_call (per launch),
host_ms_per_jit_call (the host's clock over the same window, which ends in a
synchronisation) and each window's ms.  Every line carries the card's name
and power limit.  Exits 2 without a card.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from polardecoding_tpu_torch.ops.probe_kernel import (  # noqa: E402
    floor_burst, floor_cuda, floor_graph)
from polardecoding_tpu_torch.utils.card import card_line  # noqa: E402

N, L = 1024, 8
FRAMES_PER_STEP = 128
BODY = {"scratch": False, "ties": False}
# name: (C, k, how): one launch, k back to back, or a graph of k
VARIANTS = {
    "C64": (64, 1, "plain"),
    "C128": (128, 1, "plain"),
    "C512": (512, 1, "plain"),
    "C4_x10": (4, 10, "burst"),
    "C64_x10": (64, 10, "burst"),
    "C64_scan20": (64, 20, "graph"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def make(C, k, how, ch):
    """One call of a variant: a function of no arguments."""
    if how == "plain":
        return lambda: floor_cuda(ch, None, L, **BODY)
    if how == "burst":
        return lambda: floor_burst(k, ch, None, L, **BODY)
    return floor_graph(k, ch, None, L, **BODY)


def window_ms(fn, iters):
    """(device ms, host ms) per call over `iters` calls after one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / iters
    return start.elapsed_time(stop) / iters, host


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("torch_probe_floor3: no CUDA device", file=sys.stderr)
        return 2
    iters = int(argv[0]) if len(argv) > 0 else 24
    reps = int(argv[1]) if len(argv) > 1 else 3
    card = card_line()
    rng = np.random.default_rng(0)
    fns = {}
    for name, (C, k, how) in VARIANTS.items():
        ch = torch.as_tensor(rng.normal(size=(C * FRAMES_PER_STEP, N))
                             .astype(np.float32), device="cuda")
        t0 = time.perf_counter()
        fns[name] = make(C, k, how, ch)
        fns[name]()
        torch.cuda.synchronize()
        emit({"variant": name, "C": C, "k": k,
              "compile_plus_first_s": time.perf_counter() - t0, "card": card})
    results = {name: [] for name in VARIANTS}
    for _ in range(reps):
        for name, fn in fns.items():
            results[name].append(window_ms(fn, iters))
    for name, ts in results.items():
        C, k, _ = VARIANTS[name]
        best = min(t[0] for t in ts)
        emit({"variant": name, "C": C, "k": k, "ms_per_jit_call": best,
              "ms_per_inner_call": best / k,
              "host_ms_per_jit_call": min(t[1] for t in ts),
              "reps_ms": [t[0] for t in ts], "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
