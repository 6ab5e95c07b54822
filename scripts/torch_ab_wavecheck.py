#!/usr/bin/env python3
"""A/B of the in-wave check cadence (check_every) of the fused BP wave
engine on the card, the port of scripts/ab_wavecheck.py.

  python scripts/torch_ab_wavecheck.py [B] [steps] [reps] [snr_db] [K]
      [--preset BP_1024_FASTCHK] [--device cpu] [--out DIR] [--commit TEXT]

Defaults B=16384, steps 30, reps 3, 2.0 dB, K=8, --preset (the script's
PD_WAVE_PRESET) BP_1024_FASTCHK.  check_every=0 is the incumbent (one check
at the wave's end); c > 0 also checks every c iterations inside the
kernel, latching a frame at its first passing check.  Each variant is the
production step (make_wave_step: refill LLRs by the frame channel, encode,
count, the fused wave kernel), from a fresh carry each rep: 4 steps, then
a window of `steps` steps ended by one host read of the summed retired
frames, timed by the host clock.  Prints each variant's
compile_plus_first_s (the first step; the kernels are built before it),
then best_retired_fps, the rate of each rep and window_bler, the retired
BLER over its last window's frames (each rep's window holds the same
frames), with that window's frames and error blocks; appends them to
<out>/wavecheck.jsonl with the card's name and power limit.  The TPU's run:
results/hw_queue_r4/step2.log.  Exits 2 without a card unless --device cpu
is given.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from polardecoding_tpu_torch.studies import queue_a  # noqa: E402

# ab_wavecheck.py:40-46: B, steps, reps, snr_db, K; CES; PD_WAVE_PRESET
DEFAULTS = (16384, 30, 3, 2.0, 8)
CES = (0, 1, 2, 4)
PRESET = "BP_1024_FASTCHK"
WARMUP_STEPS = 4


def main(argv=None) -> int:
    ap = queue_a.parser("torch_ab_wavecheck.py", __doc__)
    for name, default in zip(("B", "steps", "reps", "snr_db", "K"), DEFAULTS):
        ap.add_argument(name, type=type(default), nargs="?", default=default)
    ap.add_argument("--preset", default=PRESET, help="PD_WAVE_PRESET")
    args = ap.parse_args(argv)
    rec = queue_a.start("ab_wavecheck", args)
    if rec is None:
        return 2
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import prng_key
    from polardecoding_tpu_torch.parallel.harness import make_wave_step
    from polardecoding_tpu_torch.studies._common import add_counts, counting

    B, steps, reps, snr, K = args.B, args.steps, args.reps, args.snr_db, args.K
    dev = rec.device
    p = preset(args.preset)
    key = prng_key(p.sweep.seed, dev)
    sigma = float(10.0 ** (-snr / 20.0))
    head = {"preset": p.name, "B": B, "K": K}
    variants = {f"ce{ce}": make_wave_step(p, B, wave_iters=K, device=dev,
                                          check_every=ce) for ce in CES}

    for name, (init, step, _) in variants.items():
        t0 = time.perf_counter()
        with counting(dev) as launches:
            carry = init(key, 0, sigma)
            carry, out = step(key, sigma, carry)
            int(out[2])
        rec.write(dict(variant=name, **head,
                       compile_plus_first_s=time.perf_counter() - t0,
                       launches=launches))

    results = {name: [] for name in variants}
    counts = {name: {} for name in variants}
    # each variant's last window: (frames, error blocks); every rep starts
    # from frame 0, so every rep's window holds the same frames
    windows = {}
    for _ in range(reps):
        for name, (init, step, _) in variants.items():
            with counting(dev) as launches:
                carry = init(key, 0, sigma)
                last = None
                for _ in range(WARMUP_STEPS):
                    carry, last = step(key, sigma, carry)
                int(last[2])
                t0 = time.perf_counter()
                ebls, frs = [], []
                for _ in range(steps):
                    carry, (_, ebl, fr) = step(key, sigma, carry)
                    ebls.append(ebl)
                    frs.append(fr)
                frames = int(sum(frs))
                dt = time.perf_counter() - t0
            errblock = int(sum(ebls))
            counts[name] = add_counts(counts[name], launches)
            results[name].append(frames / dt)
            windows[name] = (frames, errblock)

    for name, fps in results.items():
        rec.write(dict(variant=name, **head, snr_db=snr,
                       best_retired_fps=max(fps), reps=fps,
                       window_bler=windows[name][1] / max(windows[name][0], 1),
                       steps=steps, window_frames=windows[name][0],
                       window_errblock=windows[name][1],
                       launches=counts[name],
                       tpu_log=f"results/{queue_a.WAVECHECK_LOG}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
