"""The rate-1 flavor's BLER qualification (port of scripts/bler_r1.py): a
paired 1000-error-block A/B of exact SCL against its _FASTR1 twin at the
hardest table SNR of each case.  Frames are pure functions of (seed, frame
index), so both arms decode the same noisy frames; the ratio carries about
sqrt(2 / errors) of relative sigma.  Each arm runs through the port's
run_point at batch 8192 (on the card the SCL kernel, exact or r1, and the
frame channel), and is held against the TPU's run of the same script
(results/hw_queue_r4/bler_r1.log) by the two-proportion z.
"""
from __future__ import annotations

import dataclasses

from polardecoding_tpu_torch.studies._common import (
    Recorder,
    find,
    launches_text,
    read_log,
    run_point_resumable,
    tpu_ref,
    z_against,
    z_over,
)

FILE = "bler_r1.jsonl"
TPU_LOG = "hw_queue_r4/bler_r1.log"
# bler_r1.py:26-30: name, hardest-table SNR, frame cap (--cases overrides,
# as PD_CASES does)
CASES = [
    ("SCL_128_L8", 3.0, 2_000_000),
    ("SCL_1024_L8", 3.0, 30_000_000),
    ("CASCL_1024_L8", 2.5, 60_000_000),
]
BATCH = 8192
ERROR_BLOCKS = 1000
R1 = 4


def parse_cases(text: str) -> list:
    """PD_CASES' form: "name:snr:cap[,...]"."""
    return [(n, float(s), int(c)) for n, s, c in
            (e.split(":") for e in text.split(","))]


def r1_twin(name: str, r1: int):
    """The rate-1 twin of preset `name`: the preset <name>_FASTR1 where the
    table has one (whatever its r1, as register_r1_twin), else `name` with
    scl_r1 = r1 under that name.  The preset table is left as it is."""
    from polardecoding_tpu_torch.configs import PRESETS, preset

    fast = f"{name}_FASTR1"
    if fast in PRESETS:
        return PRESETS[fast]
    p = preset(name)
    return dataclasses.replace(p, name=fast,
                               decoder=dataclasses.replace(p.decoder, scl_r1=r1))


def verdict(exact: dict, fast: dict) -> tuple:
    """bler_r1.py:66-69: (ratio r1/exact, 3 sigma, "OK" or "DIVERGES")."""
    ratio = fast["bler"] / max(exact["bler"], 1e-300)
    sigma = (2.0 / max(min(exact["errblock"], fast["errblock"]), 1)) ** 0.5
    return ratio, 3 * sigma, "OK" if abs(ratio - 1.0) < 3 * sigma else "DIVERGES"


def run(rec: Recorder, cases=CASES, error_blocks: int = ERROR_BLOCKS,
        r1: int = R1, batch: int = BATCH) -> list:
    """Both arms of every case, then its verdict line; returns the lines
    written or found.  An arm's line: bler_r1.py's keys, errbit and pm_ties,
    its launches, the TPU's line of the same preset and SNR, its z against
    it and whether (errblock, frames) are the TPU's exactly."""
    from polardecoding_tpu_torch.configs import preset

    tpu = read_log(TPU_LOG).records
    lines = []
    for base, snr, cap in cases:
        out = {}
        for p in (preset(base), r1_twin(base, r1)):
            arm = (f"{p.name}@{snr} r1={p.decoder.scl_r1} blocks={error_blocks} "
                   f"cap={cap} batch={batch}")
            line = rec.done(arm)
            if line is None:
                res, launches = run_point_resumable(rec, arm, p, snr, batch,
                                                    error_blocks, cap)
                t = tpu_ref(TPU_LOG, find(tpu, preset=p.name, snr_db=snr))
                line = rec.finish(arm, {
                    "preset": p.name, "snr_db": snr, "frames": res.frames,
                    "errblock": res.errblock, "bler": res.bler,
                    "elapsed_s": res.elapsed_s, "errbit": res.errbit,
                    "pm_ties": res.pm_ties, "batch": batch,
                    "launches": launches, "tpu": t,
                    "z": z_against(res.errblock, res.frames, t),
                    "same_as_tpu": None if t is None else (
                        res.errblock == t["errblock"] and res.frames == t["frames"])})
            out[p.decoder.scl_r1 > 0] = line
            lines.append(line)
        arm = f"verdict {base}@{snr} r1={r1} blocks={error_blocks} cap={cap} batch={batch}"
        line = rec.done(arm)
        if line is None:
            ratio, three, word = verdict(out[False], out[True])
            line = rec.finish(arm, {
                "config": base, "r1": r1, "bler_ratio_r1/exact": ratio,
                "3sigma": three, "verdict": word,
                "tpu": tpu_ref(TPU_LOG, find(tpu, config=base, r1=r1))})
        lines.append(line)
    return lines


def report(lines: list) -> list:
    """STUDIES.md's section: each arm beside the TPU's, each verdict beside
    the TPU's."""
    out = ["## bler_r1: the rate-1 flavor against exact SCL "
           "(scripts/bler_r1.py; TPU: results/hw_queue_r4/bler_r1.log)", "",
           "| preset | Eb/N0 | frames | errblock | BLER | s | launches | "
           "TPU frames | TPU errblock | TPU BLER | z | same counts |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for x in lines:
        if "preset" not in x:
            continue
        t = x["tpu"] or {}
        out.append(
            f"| {x['preset']} | {x['snr_db']} | {x['frames']} | {x['errblock']} | "
            f"{x['bler']:.4e} | {x['elapsed_s']:.3f} | {launches_text(x['launches'])} | "
            f"{t.get('frames', '')} | {t.get('errblock', '')} | "
            + (f"{t['bler']:.4e} | {x['z']:+.2f} | "
               f"{'yes' if x['same_as_tpu'] else 'no'} |" if t else " | | |"))
    out += ["", "| config | r1 | ratio r1/exact | 3 sigma | verdict | TPU ratio | "
            "TPU 3 sigma | TPU verdict |", "|---|---|---|---|---|---|---|---|"]
    for x in lines:
        if "config" not in x:
            continue
        t = x["tpu"] or {}
        out.append(f"| {x['config']} | {x['r1']} | {x['bler_ratio_r1/exact']:.4f} | "
                   f"{x['3sigma']:.4f} | {x['verdict']} | "
                   f"{t.get('bler_ratio_r1/exact', '')} | {t.get('3sigma', '')} | "
                   f"{t.get('verdict', '')} |")
    return out + [""]


def checks(lines: list) -> list:
    """What the study must show: each arm within |z| <= 4 of its TPU line,
    each verdict OK.  Returns the failures."""
    bad = z_over(lines, lambda x: f"bler_r1 {x['preset']} @ {x['snr_db']}")
    bad += [f"bler_r1 {x['config']}: {x['verdict']}" for x in lines
            if x.get("verdict") not in (None, "OK")]
    return bad


def main_args(args) -> dict:
    """run()'s keywords from the command line's flags."""
    return dict(cases=parse_cases(args.cases) if args.cases else CASES,
                error_blocks=args.error_blocks, r1=args.r1)
