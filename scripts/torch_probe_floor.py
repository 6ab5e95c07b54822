#!/usr/bin/env python3
"""Floor probe of the SCL list-decode kernel on the card, the port of
scripts/probe_floor.py.

A kernel with csrc/scl_decode.cu's launch shape (its grid, one warp per
frame and a frame's dynamic shared memory at (N, L)) and its three outputs
(u [B, L, N] int8, pm [B, L], ties [B]) that decodes nothing
(ops/probe_kernel.floor_cuda).  Variant `bare` reads the leaf table and each
frame's LLR row into shared memory and writes constant outputs; `init` also
zero-fills each frame's shared memory.  Their time is the per-call
floor that no work on the decode's phases can go below.

  python scripts/torch_probe_floor.py [N] [L] [B] [iters] [reps]

Defaults N=1024, L=8, B=8192, iters 24, reps 3.  Prints JSON lines: the
launch shape; compile_plus_first_s per variant (the first call, the
kernel's build included when it is not built yet); then per variant the
best of `reps` windows of `iters` calls timed by CUDA events after a warmup
call: best_equiv_fps (frames per second of the floor), ms_per_call,
us_per_grid_step (per 128 frames, the TPU probe's grid step at L=8),
us_per_block (per frame) and the frames per second of each window; and
graph_ms_per_call, the best of `reps` replays of a CUDA graph of `iters`
launches per launch: the device's time without the host's cost of a call.
Every line carries the card's name and power limit.  Exits 2 without a
card.
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
    floor_cuda, floor_graph, scl_shape)
from polardecoding_tpu_torch.utils.card import card_line, cuda_ms  # noqa: E402
from polardecoding_tpu_torch.utils.sequences import frozen_mask  # noqa: E402

VARIANTS = {"bare": {}, "init": {"init": True}}


def emit(obj):
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("torch_probe_floor: no CUDA device", file=sys.stderr)
        return 2
    defaults = (1024, 8, 8192, 24, 3)
    N, L, B, iters, reps = (int(argv[i]) if len(argv) > i else d
                            for i, d in enumerate(defaults))
    card = card_line()
    rng = np.random.default_rng(0)
    ch = torch.as_tensor(rng.normal(size=(B, N)).astype(np.float32) * 2,
                         device="cuda")
    leaf = torch.as_tensor(frozen_mask(N, N // 2).astype(np.uint8),
                           device="cuda")
    emit(dict(scl_shape(B, N, L), frames=B, card=card))

    def call(kw):
        return floor_cuda(ch, leaf, L, **kw)

    for name, kw in VARIANTS.items():
        t0 = time.perf_counter()
        call(kw)
        torch.cuda.synchronize()
        emit({"variant": name,
              "compile_plus_first_s": time.perf_counter() - t0, "card": card})
    graphs = {name: floor_graph(iters, ch, leaf, L, **kw)
              for name, kw in VARIANTS.items()}
    results = {name: [] for name in VARIANTS}
    device = {name: [] for name in VARIANTS}
    for _ in range(reps):
        for name, kw in VARIANTS.items():
            results[name].append(cuda_ms(lambda: call(kw), iters)[0])
            device[name].append(cuda_ms(graphs[name], 1)[0] / iters)
    for name, ms in results.items():
        best = min(ms)
        emit({"variant": name, "N": N, "L": L, "B": B,
              "best_equiv_fps": B / best * 1e3, "ms_per_call": best,
              "us_per_grid_step": best * 1e3 / (B / 128),
              "us_per_block": best * 1e3 / B,
              "reps": [B / m * 1e3 for m in ms],
              "graph_ms_per_call": min(device[name]), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
