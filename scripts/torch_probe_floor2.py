#!/usr/bin/env python3
"""The SCL kernel's floor taken apart by operand on the card, the port of
scripts/probe_floor2.py.

Two-output variants of ops/probe_kernel.floor_cuda (u and pm, no tie
counter), N=1024, L=8, the SCL kernel's launch shape:
  bare      each frame's LLR row read into shared memory and 8 KiB of int8
            u written (B=8192; the TPU probe's grid of 64 steps)
  C16/C4    the same at B=2048 and B=512: per-call against per-frame cost
  noscratch no shared memory beyond the LLR row
  no_u      u with one entry per path instead of N
  u_i32     u as int32
  no_in     the LLRs never read

  python scripts/torch_probe_floor2.py [iters] [reps]

Prints JSON lines: compile_plus_first_s per variant; then per variant the
best of `reps` windows of `iters` calls timed by CUDA events after a warmup
call: ms_per_call, us_per_grid_step (per 128 frames, the TPU probe's grid
step), us_per_block (per frame) and each window's ms; and
graph_ms_per_call, the best of `reps` replays of a CUDA graph of `iters`
launches per launch: the device's time without the host's cost of a call.
C is the TPU probe's grid size, B / 128; blocks is the card's, B.  Every
line carries the card's name and power limit.  Exits 2 without a card.
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
    floor_cuda, floor_graph)
from polardecoding_tpu_torch.utils.card import card_line, cuda_ms  # noqa: E402

N, L = 1024, 8
FRAMES_PER_STEP = 128  # the TPU probe's frames per grid step at L=8
VARIANTS = {
    "bare": (8192, {}),
    "C16": (2048, {}),
    "C4": (512, {}),
    "noscratch": (8192, {"scratch": False}),
    "no_u": (8192, {"u_rows": 1}),
    "u_i32": (8192, {"u_dtype": torch.int32}),
    "no_in": (8192, {"dma_in": False}),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("torch_probe_floor2: no CUDA device", file=sys.stderr)
        return 2
    iters = int(argv[0]) if len(argv) > 0 else 24
    reps = int(argv[1]) if len(argv) > 1 else 3
    card = card_line()
    rng = np.random.default_rng(0)
    chs = {}
    for name, (B, kw) in VARIANTS.items():
        chs[name] = torch.as_tensor(
            rng.normal(size=(B, N)).astype(np.float32), device="cuda")
        t0 = time.perf_counter()
        floor_cuda(chs[name], None, L, ties=False, **kw)
        torch.cuda.synchronize()
        emit({"variant": name, "C": B // FRAMES_PER_STEP, "blocks": B,
              "compile_plus_first_s": time.perf_counter() - t0, "card": card})
    graphs = {name: floor_graph(iters, chs[name], None, L, ties=False, **kw)
              for name, (_, kw) in VARIANTS.items()}
    results = {name: [] for name in VARIANTS}
    device = {name: [] for name in VARIANTS}
    for _ in range(reps):
        for name, (B, kw) in VARIANTS.items():
            ms, _ = cuda_ms(lambda: floor_cuda(chs[name], None, L, ties=False,
                                               **kw), iters)
            results[name].append(ms)
            device[name].append(cuda_ms(graphs[name], 1)[0] / iters)
    for name, ms in results.items():
        B = VARIANTS[name][0]
        best = min(ms)
        emit({"variant": name, "C": B // FRAMES_PER_STEP, "blocks": B,
              "ms_per_call": best,
              "us_per_grid_step": best * 1e3 / (B // FRAMES_PER_STEP),
              "us_per_block": best * 1e3 / B, "reps_ms": ms,
              "graph_ms_per_call": min(device[name]), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
