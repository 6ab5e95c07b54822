#!/usr/bin/env python3
"""End-to-end verification drive on the card, the port of
scripts/verify_drive.py: decode through the port's run_point at several SNR
points and hold each BLER within its tolerance of BASELINE.md's tables,
then two decoder invariants through the card's kernels: all-frozen BP
(bp_decode_auto) decodes to zeros, zero-LLR SC (sc_decode_auto) too.

  python scripts/torch_verify_drive.py [--fast] [--max-frames N]
      [--device cpu] [--out DIR] [--commit TEXT]

--fast runs the four N=128 checks (the TPU's three runs of it:
results/hw_queue_r2/step5.log, hw_queue_r3/step6.log, hw_queue_r4/step8.log),
without it all eight.  Each check runs run_point with batch min(4096,
frames), error_blocks 10**9 and max_frames its frames (--max-frames caps
them for a short run, for which BASELINE.md's tolerances are not made).
Prints the script's lines, ending in VERIFY PASS (exit 0) or VERIFY FAIL
(exit 1), and appends a JSON line a check to <out>/verify_drive.jsonl with
its counts, the JAX package's CPU counts and the TPU's where the run has
them.  Exits 2 without a card unless --device cpu is given.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from polardecoding_tpu_torch.studies import queue_a  # noqa: E402

# (preset, snr_db, frames, expected BLER, absolute tolerance ~3-4 sigma):
# verify_drive.py:23-34
CHECKS = [
    ("BP_128", 2.0, 32768, 0.1127, 0.012),
    ("SC_128", 3.0, 32768, 0.02098, 0.006),
    ("SCL_128_L8", 2.0, 16384, 0.0552, 0.010),
    ("CASCL_128_L8", 2.0, 16384, 0.03773, 0.008),
]
FULL_CHECKS = [
    ("SC_1024", 2.0, 32768, 0.09009, 0.010),
    ("BP_1024", 2.0, 16384, 0.02948, 0.008),
    ("SCL_1024_L8", 1.5, 8192, 0.04721, 0.012),
    ("CASCL_1024_L8", 1.5, 8192, 0.07130, 0.015),
]
BATCH = 4096
ERROR_BLOCKS = 10**9
# (errbit, errblock, frames, pm_ties) of the JAX package's run_point on the
# CPU at each --fast check's settings; the plain versions give them on the
# CPU and the kernels, bit-equal to the plain versions, on the card.  The
# TPU's runs have the same errblock at SC_128, SCL_128_L8 and CASCL_128_L8;
# at BP_128 the TPU's arithmetic decodes other frames (3809 error blocks).
JAX_CPU = {
    "BP_128": (62468, 3834, 32768, 0),
    "SC_128": (12158, 787, 32768, 0),
    "SCL_128_L8": (11817, 933, 16384, 1),
    "CASCL_128_L8": (15158, 637, 16384, 0),
}


def invariants(device) -> dict:
    """verify_drive.py:64-73 on the device: all-frozen BP over 5 iterations
    of noisy LLRs, and SC of zero LLRs on an all-info mask, each all
    zeros."""
    import numpy as np
    import torch

    from polardecoding_tpu_torch.models.bp import bp_decode_auto
    from polardecoding_tpu_torch.models.scl import sc_decode_auto

    fr = torch.ones(32, dtype=torch.bool, device=device)
    noisy = torch.as_tensor(
        np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32),
        device=device)
    bp = bp_decode_auto(noisy, fr, iters=5)
    sc = sc_decode_auto(torch.zeros((2, 32), dtype=torch.float32, device=device),
                        torch.zeros(32, dtype=torch.bool, device=device))
    return {"bp_all_frozen_zero": bool((bp == 0).all()),
            "sc_zero_llr_zero": bool((sc == 0).all())}


def main(argv=None) -> int:
    ap = queue_a.parser("torch_verify_drive.py", __doc__)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="cap each check's frames (a short run)")
    args = ap.parse_args(argv)
    rec = queue_a.start("verify_drive", args, log=None)
    if rec is None:
        return 2
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import run_point
    from polardecoding_tpu_torch.studies._common import counting

    print("devices:", rec.card, flush=True)
    tpu = queue_a.verify_tpu()
    checks = CHECKS + ([] if args.fast else FULL_CHECKS)
    failures = []
    for name, snr, frames, want, tol in checks:
        frames = min(frames, args.max_frames or frames)
        batch = min(BATCH, frames)
        t0 = time.time()
        with counting(rec.device) as launches:
            res = run_point(preset(name), snr, batch=batch, device=rec.device,
                            error_blocks=ERROR_BLOCKS, max_frames=frames)
        dt = time.time() - t0
        ok = abs(res.bler - want) < tol
        print(
            f"{name:16s} @{snr:.1f}dB: bler={res.bler:.5f} want~{want:.5f} "
            f"(+-{tol}) frames={res.frames} [{res.frames/dt:.0f} fps] "
            f"{'OK' if ok else 'FAIL'}", flush=True)
        counts = (res.errbit, res.errblock, res.frames, res.pm_ties)
        # the records of the same setting, where there are any
        t = tpu.get(name)
        t = t if t and (t["snr_db"], t["frames"]) == (snr, frames) else None
        pin = JAX_CPU.get(name)
        pin = pin if pin and pin[2] == frames else None
        rec.write({
            "check": name, "snr_db": snr, "frames": res.frames,
            "errblock": res.errblock, "errbit": res.errbit,
            "pm_ties": res.pm_ties, "bler": res.bler, "want": want, "tol": tol,
            "ok": ok, "fps": res.frames / dt, "seconds": dt, "batch": batch,
            "launches": launches, "jax_cpu": pin,
            "same_as_jax_cpu": None if pin is None else counts == pin,
            "tpu": t, "same_as_tpu": None if t is None else (
                (res.errblock, res.frames) == (t["errblock"], t["frames"]))})
        if not ok:
            failures.append(name)

    with counting(rec.device) as launches:
        held = invariants(rec.device)
    rec.write(dict(held, probes="ok" if all(held.values()) else "FAIL",
                   launches=launches))
    if not all(held.values()):
        failures.append("invariants")
    else:
        print("probes ok", flush=True)
    rec.write({"verify": "FAIL" if failures else "PASS", "failures": failures,
               "fast": args.fast, "checks": len(checks),
               "max_frames": args.max_frames})
    if failures:
        print("VERIFY FAIL:", failures, flush=True)
        return 1
    print("VERIFY PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
