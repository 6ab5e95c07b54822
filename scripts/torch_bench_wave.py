#!/usr/bin/env python3
"""Wave-engine throughput sweep on the card, the port of
scripts/bench_wave.py: steady-state retired frames/s of the
continuous-batching BP engine (make_wave_step through bench_waves) across
batch and wave_iters K, beside the fixed 100-iteration frame step.

  python scripts/torch_bench_wave.py [--snr 2.0] [--quick] [--ab-fused]
      [--reps 3] [--retune] [--device cpu] [--out DIR] [--commit TEXT]

Three modes, each with the script's grids:
  default     plain100 (bench_step BP_1024 at 8192), then the batch x K grid
              of BP_1024 on the fused engine with x_plain, its rate over
              plain100's
  --ab-fused  BP_1024, the unfused wave kernel against the fused one, in
              interleaved reps; best of --reps and fused_x
  --retune    BP_1024_FASTCHK on the fused engine over (16384, 4/6/8/12)
              and (32768, 6/8), interleaved reps, and the best
Each wave point is 24 timed chunks of 8 steps after 4 (bench_waves).
Prints the script's lines with the launches of each call, and appends
them, with `mode`, to <out>/wave_sweep.jsonl with the card's name and
power limit.  The TPU's runs: --ab-fused results/hw_queue_r2/step3.log,
--retune results/hw_queue_r3/step5.log.  Exits 2 without a card unless
--device cpu is given.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from polardecoding_tpu_torch.studies import queue_a  # noqa: E402

# bench_wave.py:26-36 (the command line), :40-44, :61, :86-88 (the grids)
SNR = 2.0
REPS = 3
STEPS = 24
WARMUP = 4
# plain100: bench_step("BP_1024", 8192, snr, iters=5, warmup=2)
PLAIN = ("BP_1024", 8192, 5, 2)
WAVE_PRESET = "BP_1024"
GRID = [(2048, 8), (4096, 4), (4096, 8), (4096, 16), (8192, 8), (16384, 8)]
QUICK_GRID = [(4096, 8), (8192, 8)]
AB_GRID = [(8192, 8), (16384, 8)]
AB_QUICK_GRID = [(8192, 8)]
RETUNE_PRESET = "BP_1024_FASTCHK"
RETUNE_GRID = [(16384, 4), (16384, 6), (16384, 8), (16384, 12),
               (32768, 6), (32768, 8)]
RETUNE_QUICK_GRID = [(16384, 8), (16384, 6)]


def main(argv=None) -> int:
    ap = queue_a.parser("torch_bench_wave.py", __doc__)
    ap.add_argument("--snr", type=float, default=SNR)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ab-fused", action="store_true",
                    help="interleaved fused-vs-unfused A/B (best of reps)")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--retune", action="store_true",
                    help="K/batch sweep of BP_1024_FASTCHK on the fused engine")
    args = ap.parse_args(argv)
    rec = queue_a.start("bench_wave", args)
    if rec is None:
        return 2
    from polardecoding_tpu_torch.bench import bench_step, bench_waves
    from polardecoding_tpu_torch.studies._common import counting

    snr, dev = args.snr, rec.device

    def waves(name, batch, wi, fused=True):
        with counting(dev) as launches:
            fps = bench_waves(name, batch, snr, wave_iters=wi, steps=STEPS,
                              warmup=WARMUP, fused=fused, device=dev)
        return fps, launches

    if args.retune:
        grid = RETUNE_QUICK_GRID if args.quick else RETUNE_GRID
        best = {}
        for rep in range(args.reps):
            for batch, wi in grid:
                fps, launches = waves(RETUNE_PRESET, batch, wi)
                best[(batch, wi)] = max(best.get((batch, wi), 0.0), fps)
                rec.write({"engine": "wave-retune", "rep": rep, "batch": batch,
                           "wave_iters": wi, "fps": fps, "mode": "retune",
                           "preset": RETUNE_PRESET, "snr_db": snr,
                           "launches": launches})
        top = max(best, key=best.get)
        rec.write({"engine": "wave-retune-best", "batch": top[0],
                   "wave_iters": top[1], "fps": best[top], "mode": "retune",
                   "preset": RETUNE_PRESET, "snr_db": snr,
                   "tpu_log": f"results/{queue_a.WAVE_LOGS['retune']}"})
        return 0

    if args.ab_fused:
        for batch, wi in AB_QUICK_GRID if args.quick else AB_GRID:
            best = {False: 0.0, True: 0.0}
            for rep in range(args.reps):
                for fused in (False, True):
                    fps, launches = waves(WAVE_PRESET, batch, wi, fused)
                    best[fused] = max(best[fused], fps)
                    rec.write({"engine": "wave", "fused": fused, "rep": rep,
                               "batch": batch, "wave_iters": wi, "fps": fps,
                               "mode": "ab-fused", "snr_db": snr,
                               "launches": launches})
            rec.write({"engine": "wave-AB", "batch": batch, "wave_iters": wi,
                       "best_unfused": best[False], "best_fused": best[True],
                       "fused_x": best[True] / best[False], "mode": "ab-fused",
                       "snr_db": snr,
                       "tpu_log": f"results/{queue_a.WAVE_LOGS['ab-fused']}"})
        return 0

    name, batch, iters, warmup = PLAIN
    with counting(dev) as launches:
        plain = bench_step(name, batch, snr, iters=iters, warmup=warmup,
                           device=dev)
    rec.write({"engine": "plain100", "batch": batch, "fps": plain,
               "mode": "default", "snr_db": snr, "launches": launches})
    for batch, wi in QUICK_GRID if args.quick else GRID:
        fps, launches = waves(WAVE_PRESET, batch, wi)
        rec.write({"engine": "wave", "batch": batch, "wave_iters": wi,
                   "fps": fps, "x_plain": fps / plain, "mode": "default",
                   "snr_db": snr, "launches": launches})
    return 0


if __name__ == "__main__":
    sys.exit(main())
