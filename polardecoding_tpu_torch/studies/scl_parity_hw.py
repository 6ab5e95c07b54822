"""The SCL kernel's parity on the script's frames (port of
scripts/scl_parity_hw.py): row 6's kernel (models/scl.scl_decode_auto)
against the plain scl_decode(return_all=True) on the same channel LLRs, at
L = 8, 16 and 32, N=128 at 2.0 dB and N=1024 at 1.5 dB; decoded bits and
every path's metric.  --flavors adds the rate-1 flavor (r1=4, L=8, N=1024,
128 frames): the kernel against the plain flavor, which is bit-equal to
the numpy twin tests/scl_fast_ref.py on the CPU.  The JAX script's
stacked=True line has no counterpart: that is a second schedule of the TPU
kernel, and the port's kernel has one.  Held against
results/hw_queue_r3/step1.log and hw_queue_r5/step15_parity_flavors.log.
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

FILE = "scl_parity.jsonl"
TPU_LOG = "hw_queue_r3/step1.log"
TPU_FLAVORS_LOG = "hw_queue_r5/step15_parity_flavors.log"
FRAMES = 512
# scl_parity_hw.py:108-112
CODES = ((128, 2.0), (1024, 1.5))
LISTS = (8, 16, 32)
# the flavors' check: SCL_1024_L8 at 1.5 dB, at most 128 frames (:97-101)
FLAVOR_FRAMES = 128
FLAVOR_R1 = 4
FLAVOR_WLOOP = 2


def channel_llrs(p, frames: int, snr_db: float, device):
    """scl_parity_hw.py:34-42: LLRs of frames 0 .. frames-1, PN payloads
    scattered on the info set, encoded, under the keys
    fold_in(PRNGKey(seed), i) at sigma = 10^(-snr/20) in float32: the
    port's frame channel (one launch of csrc/frame_channel.cu on the
    card)."""
    import torch

    from polardecoding_tpu_torch.analysis.construction import code_info_set
    from polardecoding_tpu_torch.ops.channel import frame_llr, prng_key
    from polardecoding_tpu_torch.ops.encode import polar_encode, scatter_info
    from polardecoding_tpu_torch.parallel.harness import payload_from_index
    from polardecoding_tpu_torch.utils.pn import pn_sequence

    code = p.code
    fidx = torch.arange(frames, dtype=torch.int64, device=device)
    pn = torch.as_tensor(pn_sequence(), device=device)
    payload = payload_from_index(fidx, pn, code.K)
    info = torch.as_tensor(code_info_set(code), dtype=torch.int64, device=device)
    x = polar_encode(scatter_info(payload, info, code.N))
    return frame_llr(x, prng_key(p.sweep.seed, device), fidx,
                     float(10.0 ** (-snr_db / 20.0)))


def compare(llr, frozen, L: int, device, r1: int = 0, wloop: int = 2) -> dict:
    """The kernel's (u_all, PM, ties) against the plain version's on llr:
    bits_equal, pm_close (|dPM| <= 1e-3 |PM|, the script's test),
    max_pm_err, ties_equal, the kernel call's launches and seconds."""
    import torch

    from polardecoding_tpu_torch.models.scl import scl_decode, scl_decode_auto

    t0 = time.perf_counter()
    with counting(device) as launches:
        uk, pmk, tk = scl_decode_auto(llr, frozen, list_size=L, return_all=True,
                                      return_ties=True, r1=r1, wloop=wloop)
    seconds = time.perf_counter() - t0
    uj, pmj, tj = scl_decode(llr, frozen, list_size=L, return_all=True,
                             return_ties=True, r1=r1, wloop=wloop)
    err = (pmk - pmj).abs()
    return {"bits_equal": bool(torch.equal(uk, uj)),
            "pm_close": bool((err <= 1e-3 * pmj.abs()).all()),
            "max_pm_err": float(err.max()), "ties_equal": bool(torch.equal(tk, tj)),
            "launches": launches, "kernel_s": seconds}


def run(rec: Recorder, frames: int = FRAMES, flavors: bool = False,
        flavors_only: bool = False) -> list:
    """Every (N, L) line (not with flavors_only), then with flavors the r1
    line; returns the lines.  The study fails where a line is not
    bit-equal (checks)."""
    import torch

    from polardecoding_tpu_torch.analysis.construction import code_frozen_mask
    from polardecoding_tpu_torch.configs import preset

    tpu = read_log(TPU_LOG).records
    lines = []
    for ncode, snr in CODES:
        if flavors_only and ncode != 1024:
            continue
        p = preset(f"SCL_{ncode}_L8")
        frozen = torch.as_tensor(code_frozen_mask(p.code), device=rec.device)
        llr = None
        if not flavors_only:
            for L in LISTS:
                arm = f"N={ncode} L={L} frames={frames} snr={snr}"
                line = rec.done(arm)
                if line is None:
                    if llr is None:
                        llr = channel_llrs(p, frames, snr, rec.device)
                    line = rec.finish(arm, dict(
                        {"N": ncode, "L": L, "frames": frames, "snr_db": snr},
                        **compare(llr, frozen, L, rec.device),
                        tpu=tpu_ref(TPU_LOG, find(tpu, N=ncode, L=L))))
                lines.append(line)
        if (flavors or flavors_only) and ncode == 1024:
            nf = min(frames, FLAVOR_FRAMES)
            arm = f"flavor r1={FLAVOR_R1} N={ncode} frames={nf} snr={snr}"
            line = rec.done(arm)
            if line is None:
                flavor_llr = (llr[:nf] if llr is not None
                              else channel_llrs(p, nf, snr, rec.device))
                got = compare(flavor_llr, frozen, 8, rec.device, r1=FLAVOR_R1,
                              wloop=FLAVOR_WLOOP)
                line = rec.finish(arm, dict(
                    {"flavor": f"r1={FLAVOR_R1}", "N": ncode, "frames": nf,
                     "snr_db": snr,
                     "bit_identical_vs_twin": got["bits_equal"]
                     and got["max_pm_err"] == 0.0 and got["ties_equal"]},
                    **got, tpu=tpu_ref(TPU_FLAVORS_LOG, find(
                        read_log(TPU_FLAVORS_LOG).records,
                        flavor=f"r1={FLAVOR_R1}"))))
            lines.append(line)
    return lines


def checks(lines: list) -> list:
    """Every line bit-equal: bits, path metrics (max_pm_err 0.0) and tie
    counters."""
    return [f"scl_parity {x.get('flavor', '')} N={x['N']} L={x.get('L', 8)}: "
            f"bits_equal {x['bits_equal']}, max_pm_err {x['max_pm_err']}, "
            f"ties_equal {x['ties_equal']}" for x in lines
            if not (x["bits_equal"] and x["max_pm_err"] == 0.0 and x["ties_equal"])]


def report(lines: list) -> list:
    out = ["## scl_parity_hw: the SCL kernel against the plain decoder "
           "(scripts/scl_parity_hw.py; TPU: results/hw_queue_r3/step1.log, "
           "hw_queue_r5/step15_parity_flavors.log)", "",
           "| N | L | flavor | frames | Eb/N0 | bits equal | PM close | max PM err | "
           "ties equal | kernel launches | TPU |", "|---|---|---|---|---|---|---|"
           "---|---|---|---|"]
    for x in lines:
        t = x["tpu"] or {}
        want = (f"bits_equal {t.get('bits_equal')}, max_pm_err {t.get('max_pm_err')}"
                if "bits_equal" in t else
                f"bit_identical_vs_twin {t.get('bit_identical_vs_twin')}" if t else "")
        out.append(f"| {x['N']} | {x.get('L', 8)} | {x.get('flavor', 'exact')} | "
                   f"{x['frames']} | {x['snr_db']} | {x['bits_equal']} | "
                   f"{x['pm_close']} | {x['max_pm_err']} | {x['ties_equal']} | "
                   f"{launches_text(x['launches'])} | {want} |")
    return out + ["", "The JAX script's `stacked=True` line has no counterpart: "
                  "a second schedule of the TPU kernel, bit-identical to its "
                  "first; the port's kernel has one schedule.", ""]


def main_args(args) -> dict:
    return dict(frames=args.frames or FRAMES, flavors=args.flavors,
                flavors_only=args.flavors_only)
