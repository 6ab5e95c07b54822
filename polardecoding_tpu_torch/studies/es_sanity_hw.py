"""The latched early-stop BP kernel's parity (port of
scripts/es_sanity_hw.py): row 1's kernel through bp_decode_auto with 100
iterations and a G-matrix check every 4 against the plain bp_decode on the
same LLRs (scl_parity_hw's frames), BP_128 and BP_1024 at 2.5 dB; the
decoded bits must be equal.  first_call_s is the kernel call's wall time,
its library built before by the Recorder (the JAX script's figure held the
TPU compile).  Held against results/hw_queue_r3/step7.log.
"""
from __future__ import annotations

import time

from polardecoding_tpu_torch.studies._common import (
    Recorder,
    counting,
    find,
    launches_text,
    read_log,
    tpu_ref,
)
from polardecoding_tpu_torch.studies.scl_parity_hw import channel_llrs

FILE = "es_sanity.jsonl"
TPU_LOG = "hw_queue_r3/step7.log"
FRAMES = 1024
SNR = 2.5
PRESETS = ("BP_128", "BP_1024")
ITERS = 100
EARLY_STOP_EVERY = 4


def run(rec: Recorder, frames: int = FRAMES, snr: float = SNR) -> list:
    import torch

    from polardecoding_tpu_torch.analysis.construction import code_frozen_mask
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.bp import bp_decode, bp_decode_auto

    tpu = read_log(TPU_LOG).records
    lines = []
    for name in PRESETS:
        arm = f"{name} frames={frames} snr={snr}"
        line = rec.done(arm)
        if line is None:
            p = preset(name)
            frozen = torch.as_tensor(code_frozen_mask(p.code), device=rec.device)
            llr = channel_llrs(p, frames, snr, rec.device)
            if rec.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counting(rec.device) as launches:
                uk = bp_decode_auto(llr, frozen, iters=ITERS,
                                    early_stop_every=EARLY_STOP_EVERY)
            first = time.perf_counter() - t0
            uj = bp_decode(llr, frozen, iters=ITERS,
                           early_stop_every=EARLY_STOP_EVERY)
            line = rec.finish(arm, {
                "preset": name, "frames": frames, "snr_db": snr,
                "bits_equal": bool(torch.equal(uk, uj)), "first_call_s": first,
                "launches": launches,
                "tpu": tpu_ref(TPU_LOG, find(tpu, preset=name))})
        lines.append(line)
    return lines


def checks(lines: list) -> list:
    return [f"es_sanity {x['preset']}: bits_equal {x['bits_equal']}"
            for x in lines if not x["bits_equal"]]


def report(lines: list) -> list:
    out = ["## es_sanity_hw: the latched early-stop BP kernel against the plain "
           "decoder (scripts/es_sanity_hw.py; TPU: results/hw_queue_r3/step7.log)",
           "", "first_call_s: the kernel call's wall seconds on the card, its "
           "library built before (the TPU's figure holds its compile).", "",
           "| preset | frames | Eb/N0 | bits equal | first_call_s | launches | "
           "TPU bits equal | TPU first_call_s |", "|---|---|---|---|---|---|---|---|"]
    for x in lines:
        t = x["tpu"] or {}
        out.append(f"| {x['preset']} | {x['frames']} | {x['snr_db']} | "
                   f"{x['bits_equal']} | {x['first_call_s']:.4f} | "
                   f"{launches_text(x['launches'])} | {t.get('bits_equal', '')} | "
                   f"{t.get('first_call_s', '')} |")
    return out + [""]


def main_args(args) -> dict:
    return dict(frames=args.frames or FRAMES,
                snr=SNR if args.snr is None else args.snr)
