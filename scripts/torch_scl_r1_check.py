#!/usr/bin/env python3
"""Build the port's CUDA kernels and hold the SCL list-decode kernel's
rate-1 flavor against its plain version on one card, then time exact mode
and the flavor at N=1024, L=8, B=16384.

  python3 scripts/torch_scl_r1_check.py     # from the repo root

Cases: N in {32, 128, 1024}; the 5G mask, an all-info mask (one R1 node at
the root) and a random mask; L from 1 to 32; r1 in {2, 4} (only 4 for the
all-info mask at N=1024); exact mode at L=8; forced ties.  u_all, PM and
ties must be bit-equal on every frame.  The timing LLRs are random (mean
1.6, deviation 1.5): the kernel's time barely depends on them.  Exits 1 if
any case differs.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from polardecoding_tpu_torch.models.scl import scl_decode  # noqa: E402
from polardecoding_tpu_torch.ops import _build, scl_kernel  # noqa: E402
from polardecoding_tpu_torch.utils.sequences import frozen_mask  # noqa: E402


def compare(llr, fr, L, r1, tag):
    got = scl_kernel.scl_decode_cuda(llr, fr, L, r1=r1)
    want = scl_decode(llr, fr, L, return_all=True, return_ties=True, r1=r1)
    torch.cuda.synchronize()
    eq = [bool((g == w).all()) for g, w in zip(got, want)]
    B = llr.shape[0]
    frames = int(((got[0] == want[0]).reshape(B, -1).all(1)
                  & (got[1] == want[1]).all(1) & (got[2] == want[2])).sum())
    print(json.dumps(dict(tag=tag, N=llr.shape[1], L=L, r1=r1, eq=eq,
                          frames_equal=frames, B=B,
                          ties=int(want[2].sum()))), flush=True)
    return all(eq)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    ok = True
    rng = np.random.default_rng(1)
    for N in (32, 128, 1024):
        for name, fr in (("5g", frozen_mask(N, N // 2)),
                         ("allinfo", np.zeros(N, bool)),
                         ("random", rng.random(N) < 0.5)):
            fr = torch.as_tensor(np.asarray(fr), device="cuda")
            B = 64 if N < 1024 else 16
            llr = torch.as_tensor((rng.normal(size=(B, N)) * 3)
                                  .astype(np.float32), device="cuda")
            for L in (1, 2, 4, 8, 16, 32):
                for r1 in ((4,) if name == "allinfo" and N == 1024 else (2, 4)):
                    ok &= compare(llr, fr, L, r1, name)
            ok &= compare(llr, fr, 8, 0, name + " exact")
    tie = torch.tensor([1.0, -1.0] * 16, device="cuda").repeat(64, 1)
    ok &= compare(tie, torch.as_tensor(frozen_mask(32, 20), device="cuda"), 4,
                  2, "ties")
    fr = torch.as_tensor(frozen_mask(1024, 512), device="cuda")
    llr = torch.as_tensor((rng.normal(size=(16384, 1024)) * 1.5 + 1.6)
                          .astype(np.float32), device="cuda")
    for r1 in (0, 4, 0, 4):
        scl_kernel.scl_decode_cuda(llr, fr, 8, r1=r1)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            scl_kernel.scl_decode_cuda(llr, fr, 8, r1=r1)
        stop.record()
        stop.synchronize()
        print(json.dumps({"r1": r1, "ms": start.elapsed_time(stop) / 3}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
