#!/usr/bin/env python3
"""Exact-mode time of the SCL list-decode kernel of the port in a checkout,
N=1024, L=8, B=16384, on AWGN LLRs of the all-zero codeword at 2.0 dB.

  python3 scripts/torch_scl_exact_ab.py ROOT    # ROOT: the checkout's root

To compare two versions of the kernel, unpack the other commit beside this
checkout (git archive) and run the script once per process in turns on
one card: parent, change, change, parent.  Prints one JSON line with three
means of five launches each.
"""
import json
import os
import sys

import numpy as np
import torch

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import polardecoding_tpu_torch as pkg  # noqa: E402
from polardecoding_tpu_torch.ops import scl_kernel  # noqa: E402
from polardecoding_tpu_torch.utils.sequences import frozen_mask  # noqa: E402

if not pkg.__file__.startswith(root):
    sys.exit(f"imported {pkg.__file__}, not the package under {root}")
rng = np.random.default_rng(7)
sigma = 10 ** (-2.0 / 20)
y = 1.0 + sigma * rng.normal(size=(16384, 1024))
llr = torch.as_tensor((2 * y / sigma ** 2).astype(np.float32), device="cuda")
fr = torch.as_tensor(frozen_mask(1024, 512), device="cuda")
scl_kernel.scl_decode_cuda(llr, fr, 8)
torch.cuda.synchronize()
ms = []
for _ in range(3):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        scl_kernel.scl_decode_cuda(llr, fr, 8)
    stop.record()
    stop.synchronize()
    ms.append(start.elapsed_time(stop) / 5)
print(json.dumps({"ab_exact": sys.argv[1], "file": pkg.__file__, "ms": ms}),
      flush=True)
