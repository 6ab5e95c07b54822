#!/usr/bin/env python3
"""SCL list-decode kernel throughput across N and L on the card, the port of
scripts/bench_scl.py: the kernel alone (exact mode, csrc/scl_decode.cu) on
pre-generated channel LLRs, then the full MC pipeline's rate (bench_step)
at SCL_1024_L8 and, without --quick, CASCL_1024_L32.

  python scripts/torch_bench_scl.py [--quick] [--device cpu] [--out DIR]
      [--commit TEXT]

The kernel's input is the channel LLRs of SCL_<N>_L8 at 1.5 dB on its
mask (studies/scl_parity_hw.channel_llrs: one frame-channel launch); each
grid point times `iters` calls after `warmup` by CUDA events.  Prints the
script's lines (kernel_fps, full_mc_fps) with the milliseconds a call and
the launches, and appends them to <out>/scl_grid.jsonl with the card's name
and power limit.  The TPU's run of the script, at smaller batches, is
results/hw_queue_r2/step7.log.  Exits 2 without a card unless --device cpu
is given.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from polardecoding_tpu_torch.studies import queue_a  # noqa: E402

# (N, L, batch): bench_scl.py:57-62
GRID = [(128, 8, 8192), (128, 16, 8192), (128, 32, 8192),
        (1024, 1, 8192), (1024, 8, 4096), (1024, 16, 2048), (1024, 32, 1024)]
QUICK_GRID = [(128, 8, 8192), (1024, 8, 4096)]
# bench_kernel's defaults (:29)
SNR = 1.5
ITERS = 8
WARMUP = 3
# (preset, batch, snr_db, iters, warmup) of the full pipeline (:69, :75);
# the second only without --quick
FULL_MC = [("SCL_1024_L8", 4096, 2.0, 8, 3), ("CASCL_1024_L32", 512, 2.0, 4, 2)]


def bench_kernel(ncode: int, L: int, batch: int, device, snr: float = SNR,
                 iters: int = ITERS, warmup: int = WARMUP) -> float:
    """bench_scl.py:29-49: milliseconds a call of the list decode at list
    size L on SCL_<ncode>_L8's channel LLRs and mask."""
    import torch

    from polardecoding_tpu_torch.analysis.construction import code_frozen_mask
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.scl import scl_decode_auto
    from polardecoding_tpu_torch.studies.scl_parity_hw import channel_llrs

    p = preset(f"SCL_{ncode}_L8")
    frozen = torch.as_tensor(code_frozen_mask(p.code), device=device)
    llr = channel_llrs(p, batch, snr, device)
    return queue_a.time_ms(
        lambda: scl_decode_auto(llr, frozen, list_size=L, return_all=True,
                                return_ties=True), iters, warmup, device)


def main(argv=None) -> int:
    ap = queue_a.parser("torch_bench_scl.py", __doc__)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    rec = queue_a.start("bench_scl", args)
    if rec is None:
        return 2
    from polardecoding_tpu_torch.bench import bench_step
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.studies._common import counting

    for ncode, L, batch in QUICK_GRID if args.quick else GRID:
        with counting(rec.device) as launches:
            ms = bench_kernel(ncode, L, batch, rec.device)
        rec.write({"N": ncode, "L": L, "batch": batch,
                   "kernel_fps": batch / ms * 1e3, "ms_per_call": ms,
                   "iters": ITERS, "snr_db": SNR, "launches": launches,
                   "tpu_log": f"results/{queue_a.SCL_LOG}"})
    for i, (name, batch, snr, iters, warmup) in enumerate(FULL_MC):
        if args.quick and i:
            break
        with counting(rec.device) as launches:
            fps = bench_step(name, batch, snr, iters=iters, warmup=warmup,
                             device=rec.device)
        p = preset(name)
        head = ({"N": p.code.N, "L": p.decoder.list_size} if i == 0
                else {"preset": name})
        rec.write(dict(head, batch=batch, full_mc_fps=fps, snr_db=snr,
                       iters=iters, launches=launches,
                       tpu_log=f"results/{queue_a.SCL_LOG}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
