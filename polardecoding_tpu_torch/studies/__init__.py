"""The JAX repository's hardware studies on the card, each the port of a
script of scripts/ and held against the TPU's record of the same run:

  bler_r1           the rate-1 SCL flavor's 1000-error-block BLER A/B
  bler_wavemc       the MC wave engine's BLER A/B against the fused engine
  scl_parity_hw     the SCL kernel against the plain decoder, L = 8, 16, 32
  es_sanity_hw      the latched early-stop BP kernel against the plain one
  tie_impact_study  the two PM-tie selection policies on the same frames
  bf16_study        the precision study: float32 against the float64 C
                    engine, and bfloat16 message state against float32
  ab_chkfast        the fast CHK flavor's BLER A/B (--bler) and its rate
                    A/B (--perf, the default) against the default flavor

  python -m polardecoding_tpu_torch.studies --study all        # the card
  python -m polardecoding_tpu_torch.studies --study bler_r1 --device cpu
  python -m polardecoding_tpu_torch.studies --report-only      # host only

Each study appends its lines to --out (results/h100/ by default; never
inside the TPU archive) and resumes what a rerun finds there (_common).
--report-only writes STUDIES.md and PRECISION.md from the records, and
QUEUE_A.md from those of the queue A drivers (studies/queue_a.py).  The
scripts' environment knobs are flags with the same defaults.
"""
from __future__ import annotations

import argparse
import os
import sys

from polardecoding_tpu_torch.studies import (
    ab_chkfast,
    bf16_study,
    bler_r1,
    bler_wavemc,
    es_sanity_hw,
    scl_parity_hw,
    queue_a,
    tie_impact_study,
)
from polardecoding_tpu_torch.studies._common import (
    DEFAULT_OUT,
    STUDY_PINS,
    Recorder,
    check_out,
    read_lines,
)

# in the order ROADMAP's queue D ports them, then queue A's study
STUDIES = {"bler_r1": bler_r1, "bler_wavemc": bler_wavemc,
           "scl_parity_hw": scl_parity_hw, "es_sanity_hw": es_sanity_hw,
           "tie_impact_study": tie_impact_study, "bf16_study": bf16_study,
           "ab_chkfast": ab_chkfast}
# the flags whose default differs between the studies that take them: given
# only with one study
PER_STUDY_FLAGS = ("preset", "frames", "snr", "batch")

__all__ = ["STUDIES", "STUDY_PINS", "run_study", "write_reports", "main"]


def run_study(name: str, out: str = DEFAULT_OUT, device="cuda", commit=None,
              log=print, **kw) -> list:
    """Run study `name` (keywords: its run()'s) into out; returns its lines."""
    mod = STUDIES[name]
    rec = Recorder(name, mod.FILE, out, device=device, commit=commit, log=log)
    return mod.run(rec, **kw)


def _head(lines: list) -> list:
    cards = sorted({x["card"] for x in lines if "card" in x})
    commits = sorted({x["commit"] for x in lines if "commit" in x})
    return [f"Card (nvidia-smi name, power.limit): {'; '.join(cards) or 'unknown'}. "
            f"Code: {', '.join(commits) or 'unknown'}.  "
            "polardecoding_tpu_torch.studies; every time is wall time on that "
            "card's machine.", ""]


def write_reports(out: str = DEFAULT_OUT) -> dict:
    """STUDIES.md (every study but bf16_study), PRECISION.md (bf16_study)
    and QUEUE_A.md (the queue A drivers' records) from the records in out
    (host only); returns {report: the checks that failed}."""
    check_out(out)
    done = {}
    recs = {name: read_lines(out, mod.FILE) for name, mod in STUDIES.items()}
    five = [n for n in STUDIES if n != "bf16_study" and recs[n]]
    if five:
        body = ["# Hardware studies (H100)", ""] + _head(
            [x for n in five for x in recs[n]])
        body += ["Each study's lines beside the TPU's record of the same run "
                 "(results/hw_queue_r*/); z: the two-proportion z with the "
                 "pooled rate; launches: the kernels the arm launched.", ""]
        failed = []
        for n in five:
            body += STUDIES[n].report(recs[n])
            failed += STUDIES[n].checks(recs[n])
        body += ["## Checks", ""] + ([f"- FAILED: {f}" for f in failed] or [
            "All held: every z within 4, every verdict OK, every parity line "
            "bit-equal, the CPU tie record exact."]) + [""]
        _write(os.path.join(out, "STUDIES.md"), body)
        done["STUDIES.md"] = failed
    if recs["bf16_study"]:
        lines = recs["bf16_study"]
        failed = bf16_study.checks(lines)
        body = bf16_study.report(lines, _head(lines))
        body += ["## Checks", ""] + ([f"- FAILED: {f}" for f in failed] or [
            "All held: every arm within |z| <= 4 of the TPU's."]) + [""]
        _write(os.path.join(out, "PRECISION.md"), body)
        done["PRECISION.md"] = failed
    queue = queue_a.report(out)
    if queue is not None:
        body, failed = queue
        _write(os.path.join(out, queue_a.REPORT), body)
        done[queue_a.REPORT] = failed
    return done


def _write(path: str, lines: list):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m polardecoding_tpu_torch.studies",
        description="The JAX repository's hardware studies on the card, each "
                    "held against the TPU's record.")
    ap.add_argument("--study", default="all", choices=(*STUDIES, "all"))
    ap.add_argument("--quick", action="store_true",
                    help="bf16_study.py's --quick: 100 error blocks an arm")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="records and reports (never inside the archive)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--commit", default=None,
                    help="the code's name in the records (default: git HEAD)")
    ap.add_argument("--report-only", action="store_true",
                    help="write the reports from the records; no device work")
    g = ap.add_argument_group("bler_r1")
    g.add_argument("--cases", default=None,
                   help="PD_CASES: name:snr:cap[,...] (default bler_r1.py's)")
    g.add_argument("--error-blocks", type=int, default=bler_r1.ERROR_BLOCKS,
                   help="bler_r1 and bler_wavemc")
    g.add_argument("--r1", type=int, default=bler_r1.R1)
    g = ap.add_argument_group("bler_wavemc")
    g.add_argument("--snrs", default=",".join(map(str, bler_wavemc.SNRS)),
                   help="PD_SNRS")
    g.add_argument("--engines", default=",".join(bler_wavemc.ENGINES),
                   help="PD_ENGINES: fused, mc, mc-tf, mc-c<cadence>, each "
                        "with an optional -i<iterMax>")
    g.add_argument("--mc-k", type=int, default=bler_wavemc.MC_K, help="PD_MC_K")
    g.add_argument("--mc-cadence", type=int, default=bler_wavemc.MC_CADENCE,
                   help="PD_MC_CADENCE")
    g.add_argument("--fused-k", type=int, default=bler_wavemc.FUSED_K,
                   help="PD_FUSED_K")
    g.add_argument("--max-frames", type=int, default=bler_wavemc.MAX_FRAMES)
    g = ap.add_argument_group("scl_parity_hw")
    g.add_argument("--flavors", action="store_true",
                   help="also the rate-1 flavor's parity (N=1024)")
    g.add_argument("--flavors-only", action="store_true")
    g = ap.add_argument_group("bf16_study")
    g.add_argument("--blocks", type=int, default=bf16_study.BLOCKS)
    g = ap.add_argument_group("ab_chkfast (--perf unless --bler alone)")
    g.add_argument("--perf", action="store_true")
    g.add_argument("--bler", action="store_true")
    g.add_argument("--bler-snr", type=float, default=ab_chkfast.BLER_SNR)
    g = ap.add_argument_group("one study only (each study's own default)")
    g.add_argument("--preset", default=None,
                   help="PD_PRESET of bler_wavemc (BP_1024_FASTCHK); "
                        "tie_impact_study's (CASCL_128_L32)")
    g.add_argument("--frames", type=int, default=None,
                   help="scl_parity_hw (512), es_sanity_hw (1024), "
                        "tie_impact_study (8192)")
    g.add_argument("--snr", type=float, default=None,
                   help="es_sanity_hw (2.5), tie_impact_study (2.0)")
    g.add_argument("--batch", type=int, default=None,
                   help="PD_BATCH of bler_wavemc (16384); tie_impact_study "
                        "(512); ab_chkfast's BLER arms (the preset's "
                        "batch_per_device, 1024)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    try:
        check_out(args.out)
    except ValueError as e:
        print(f"studies: {e}", file=sys.stderr)
        return 2
    given = [f for f in PER_STUDY_FLAGS if getattr(args, f) is not None]
    if args.study == "all" and given and not args.report_only:
        print(f"studies: --{', --'.join(given)} takes one study (--study)",
              file=sys.stderr)
        return 2
    failed = []
    if not args.report_only:
        import torch

        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            print("studies: no CUDA device (--device cpu runs the plain "
                  "versions)", file=sys.stderr)
            return 2
        names = list(STUDIES) if args.study == "all" else [args.study]
        for name in names:
            mod = STUDIES[name]
            lines = run_study(name, args.out, device=args.device,
                              commit=args.commit,
                              log=lambda m: print(m, flush=True),
                              **mod.main_args(args))
            failed += mod.checks(lines)
    for name, bad in write_reports(args.out).items():
        print(f"wrote {os.path.join(args.out, name)}: "
              + (f"{len(bad)} checks failed" if bad else "all checks held"),
              flush=True)
    for f in failed:
        print(f"studies: FAILED {f}", file=sys.stderr)
    return 1 if failed else 0
