#!/usr/bin/env python3
"""How often the BP sweep's CHK table is 0 - 0, the case the live-row
kernels skip (csrc/bp_common.cuh, lut_fma_diff).

  python scripts/torch_bp_saturation.py [--batch 32] [--iters 100] [--device cuda]

Decodes BP_1024 frames (the 5G mask at rate 1/2, LLRs of the all-zero
codeword at 2.0 dB from a seed) with the port's plain flooding iteration
and counts, for every CHK of each window of iterations, whether both
|a + b| and |a - b| are at or above the table's last threshold (4.5,
ops/chk.table_zero), and whether that holds for all 32 consecutive pairs
that one warp of the kernel runs together.  Prints one JSON line per
window.  Runs on the card; without one it exits 2.  A count, not a time:
--device cpu gives the same counts on the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from polardecoding_tpu_torch.models import bp
from polardecoding_tpu_torch.ops.chk import chk, table_zero
from polardecoding_tpu_torch.utils.sequences import frozen_mask

N, EBN0_DB, WARP = 1024, 2.0, 32
WINDOWS = (5, 20, 100)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_bp_saturation: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(1)
    sigma = math.sqrt(1.0 / (2 * 0.5 * 10 ** (EBN0_DB / 10)))
    y = 1.0 + sigma * rng.normal(size=(args.batch, N))
    llr = torch.as_tensor((2.0 * y / sigma ** 2).astype(np.float32),
                          device=args.device)
    frozen = torch.as_tensor(frozen_mask(N, N // 2), device=args.device)
    counts = {"chks": 0, "saturated": 0, "warp_saturated": 0}

    def counted_chk(a, b):
        # a, b: [B, N/2d, d], one element per pair in the kernel's lane order
        flat = table_zero(a, b).reshape(a.shape[0], -1)
        counts["chks"] += flat.numel()
        counts["saturated"] += int(flat.sum())
        counts["warp_saturated"] += WARP * int(
            flat.reshape(flat.shape[0], -1, WARP).all(dim=-1).sum())
        return chk(a, b)

    n = N.bit_length() - 1
    zero = torch.zeros_like(llr)
    Ls = [zero] * n + [llr]
    Rs = [torch.where(frozen, bp.FROZEN_R, 0.0).expand_as(llr)] + [zero] * n
    start = 0
    for it in range(1, args.iters + 1):
        Ls, Rs = bp.bp_iteration(Ls, Rs, counted_chk)
        if it in WINDOWS or it == args.iters:
            print(json.dumps({"iterations": [start + 1, it],
                              "batch": args.batch, "device": args.device,
                              "chks": counts["chks"],
                              "saturated_share": counts["saturated"] / counts["chks"],
                              "warp_saturated_share":
                                  counts["warp_saturated"] / counts["chks"]}),
                  flush=True)
            counts = dict.fromkeys(counts, 0)
            start = it
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
