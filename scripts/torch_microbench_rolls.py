#!/usr/bin/env python3
"""Sustained rate of the SCL kernel's operation patterns on the card, the
port of scripts/microbench_rolls.py.

Each pattern (ops/microbench_kernel: the roll+mask path gather on one row
and on many, the 8-bin LUT ladder, the 2L-candidate rank, CHK rows) runs
`iters` iterations on [rows, 8, 128] float32 tiles, one tile per block.
With one tile (copies 1, the TPU probe's run) it measures one SM; with
`--copies` tiles (default 8 per SM) the whole card.  Rates use the TPU
script's operation counts per iteration, so the two read alike, against
the H100 SXM's 33.5e12 float32 operations per second (132 SMs x 128 lanes
x 1.98 GHz; an add, compare, select or multiply is one) and its per-SM
share.

  python scripts/torch_microbench_rolls.py [--iters 200000] [--copies N]

Prints one JSON line per pattern and copies count: lane_ops_per_s (G/s, the
best of three runs timed by CUDA events after a first call), of_nominal_peak
(of 33.5e12), per_sm_lane_ops_per_s and of_sm_peak (over the SMs the tiles
occupy), seconds of the best run, and the card's name and power limit.
Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from polardecoding_tpu_torch.ops.microbench_kernel import (  # noqa: E402
    microbench_cuda, ops_per_iter)
from polardecoding_tpu_torch.utils.card import card_line, cuda_ms  # noqa: E402

# H100 SXM (NVIDIA's data sheet): 67 TFLOP/s of float32 counts an FMA as two
OPS_PER_S = 33.5e12
# the TPU script's patterns and shapes, in its order (:169-176)
CASES = (("gather", {"L": 8}), ("gather", {"L": 32}),
         ("gather_rows", {"L": 8, "rows": 8}),
         ("gather_rows", {"L": 8, "rows": 32}),
         ("gather_rows", {"L": 8, "rows": 128}),
         ("lut", {"rows": 8}), ("lut", {"rows": 32}),
         ("rank", {"L": 8}),
         ("chkrow", {"rows": 8}), ("chkrow", {"rows": 64}))


def rate(kind, iters, copies, L=8, rows=8):
    """(operations per second, seconds) of the best of three runs."""
    if kind in ("gather", "rank"):
        rows = 1
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(copies, rows, 8, 128))
                        .astype(np.float32), device="cuda")
    def run():
        return microbench_cuda(kind, x, iters, L)

    run()
    ms = min(cuda_ms(run, 1, warmup=0)[0] for _ in range(3))
    return iters * copies * ops_per_iter(kind, L, rows) / (ms / 1e3), ms / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200_000)
    ap.add_argument("--copies", type=int, default=0,
                    help="tiles of the whole-card line (0: 8 per SM)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_microbench_rolls: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for copies in (1, args.copies or 8 * sms):
        for kind, kw in CASES:
            ops, seconds = rate("chk" if kind == "chkrow" else kind,
                                args.iters, copies, **kw)
            per_sm = ops / min(copies, sms)
            print(json.dumps({"pattern": kind, **kw, "copies": copies,
                              "iters": args.iters,
                              "lane_ops_per_s": ops / 1e9, "unit": "G/s",
                              "of_nominal_peak": ops / OPS_PER_S,
                              "per_sm_lane_ops_per_s": per_sm / 1e9,
                              "of_sm_peak": per_sm / (OPS_PER_S / sms),
                              "seconds": seconds, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
