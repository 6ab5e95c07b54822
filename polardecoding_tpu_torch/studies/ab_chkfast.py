"""The fast CHK flavor's qualification (port of scripts/ab_chkfast.py): the
default minsum_lut BP against its minsum_lut_fast twin (the presets
<name>_FASTCHK), in two phases.

  perf  three interleaved reps of bench_step at BP_1024, batch 8192, and of
        bench_waves at 8192, 16 chunks, on both flavors; best of reps,
        fixed_x and wave_x (the fast flavor's rate over the default's)
  bler  the 1000-error-block BLER A/B at 4.0 dB on the fused wave engine
        (run_point_waves), BP_128 and BP_1024 each against its twin, to the
        script's 30,000,000-frame cap.  Frames are pure in (seed, frame
        index, wave_iters), so both arms of a pair decode the same frames;
        the verdict is the script's |ratio - 1| < 3 sqrt(2 / min errors)

Each BLER arm is held by the two-proportion z against its row of the TPU's
run (results/hw_queue_r2/step4.log).  BP's TPU arithmetic steers other
frames than the port's, so no exact count is held.  The perf line holds
the card's rates only: the TPU's are in the log.  On the card the fixed
arms launch row 1's kernel and the frame channel, the wave arms row 2's
kernel and the frame channel.
"""
from __future__ import annotations

import json

from polardecoding_tpu_torch.studies._common import (
    Recorder,
    counting,
    find,
    launches_text,
    read_log,
    tpu_ref,
    z_against,
    z_over,
)
# ab_chkfast.py:104-107 is bler_r1.py's rule: (ratio fast/default, 3 sigma,
# "OK" or "DIVERGES")
from polardecoding_tpu_torch.studies.bler_r1 import verdict

FILE = "chkfast.jsonl"
TPU_LOG = "hw_queue_r2/step4.log"
# bler_ab (ab_chkfast.py:82) and the command line (:116-121)
BLER_SNR = 4.0
ERROR_BLOCKS = 1000
MAX_FRAMES = 30_000_000
BASES = ("BP_128", "BP_1024")
# perf_ab (:58-79)
PERF_PRESET = "BP_1024"
PERF_BATCH = 8192
PERF_SNR = 2.0
PERF_REPS = 3
FIXED_ITERS = 5
WAVE_STEPS = 16


def fast_twin(name: str):
    """ab_chkfast.py:43-56: the preset <name>_FASTCHK, the table's twin of
    BP_128 and BP_1024 (bp_flavor minsum_lut_fast)."""
    from polardecoding_tpu_torch.configs import preset

    return preset(f"{name}_FASTCHK")


def tpu_row(**want):
    """The step4 record holding `want` (an arm's preset and snr_db, or a
    verdict's N), as a line carries it, or None."""
    return tpu_ref(TPU_LOG, find(read_log(TPU_LOG).records, **want))


def perf_ab(rec: Recorder, reps: int = PERF_REPS) -> dict:
    """perf_ab: the script's rep lines (logged) and its summary line, with
    every rep's rate and the launches of the whole A/B."""
    from polardecoding_tpu_torch.bench import bench_step, bench_waves

    fast = fast_twin(PERF_PRESET).name
    names = (PERF_PRESET, fast)
    best, runs = {}, []

    def rep_line(line):
        runs.append(line)
        rec.log(json.dumps(line))

    with counting(rec.device) as launches:
        for rep in range(reps):
            for name in names:
                fps = bench_step(name, PERF_BATCH, PERF_SNR, iters=FIXED_ITERS,
                                 warmup=(2 if rep == 0 else 1), device=rec.device)
                best[name] = max(best.get(name, 0.0), fps)
                rep_line({"engine": "fixed100", "preset": name, "rep": rep,
                          "fps": fps})
        for rep in range(reps):
            for name in names:
                fps = bench_waves(name, PERF_BATCH, PERF_SNR, steps=WAVE_STEPS,
                                  warmup=(4 if rep == 0 else 2), device=rec.device)
                best["wave_" + name] = max(best.get("wave_" + name, 0.0), fps)
                rep_line({"engine": "wave", "preset": name, "rep": rep,
                          "fps": fps})
    arm = f"perf {PERF_PRESET} batch={PERF_BATCH} reps={reps}"
    return rec.finish(arm, {
        "AB": best, "fixed_x": best[fast] / best[PERF_PRESET],
        "wave_x": best["wave_" + fast] / best["wave_" + PERF_PRESET],
        "batch": PERF_BATCH, "snr_db": PERF_SNR, "runs": runs,
        "launches": launches, "tpu_log": f"results/{TPU_LOG}"})


def bler_ab(rec: Recorder, snr_db: float = BLER_SNR,
            error_blocks: int = ERROR_BLOCKS, max_frames: int = MAX_FRAMES,
            batch=None) -> list:
    """bler_ab: each base and its twin through run_point_waves (fused engine,
    K=8, batch `batch` or the preset's batch_per_device, run_point_waves'
    default on one rank), then each pair's verdict line.  An arm's line:
    the script's keys with errbit, elapsed_s, batch, launches, the TPU's
    row and z.  A wave arm has no checkpoint: an arm cut short runs again."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import run_point_waves

    lines = []
    for base in BASES:
        out = []
        for p in (preset(base), fast_twin(base)):
            b = batch or p.sweep.batch_per_device
            arm = f"{p.name}@{snr_db} blocks={error_blocks} cap={max_frames} batch={b}"
            line = rec.done(arm)
            if line is None:
                with counting(rec.device) as launches:
                    r = run_point_waves(p, snr_db, batch=b, device=rec.device,
                                        error_blocks=error_blocks,
                                        max_frames=max_frames)
                t = tpu_row(preset=p.name, snr_db=snr_db)
                line = rec.finish(arm, {
                    "preset": p.name, "snr_db": snr_db, "frames": r.frames,
                    "errblock": r.errblock, "bler": r.bler, "errbit": r.errbit,
                    "elapsed_s": r.elapsed_s, "batch": b, "wave_iters": 8,
                    "launches": launches, "tpu": t,
                    "z": z_against(r.errblock, r.frames, t)})
            out.append(line)
            lines.append(line)
        N = preset(base).code.N
        arm = f"verdict N={N}@{snr_db} blocks={error_blocks} cap={max_frames}"
        line = rec.done(arm)
        if line is None:
            ratio, three, word = verdict(*out)
            line = rec.finish(arm, {
                "N": N, "bler_ratio_fast/def": ratio, "3sigma": three,
                "verdict": word,
                "tpu": tpu_row(N=N) if snr_db == BLER_SNR else None})
        lines.append(line)
    return lines


def run(rec: Recorder, perf: bool = True, bler: bool = False,
        bler_snr: float = BLER_SNR, error_blocks: int = ERROR_BLOCKS,
        max_frames: int = MAX_FRAMES, batch=None, reps: int = PERF_REPS) -> list:
    """The phases asked for, perf first, as the script runs them; a finished
    perf line or arm is not run again."""
    lines = []
    if perf:
        line = rec.done(f"perf {PERF_PRESET} batch={PERF_BATCH} reps={reps}")
        lines.append(line or perf_ab(rec, reps))
    if bler:
        lines += bler_ab(rec, bler_snr, error_blocks, max_frames, batch)
    return lines


def report(lines: list) -> list:
    """STUDIES.md's section: the perf A/B's rates and ratios on this card,
    each BLER arm beside the TPU's counts, each verdict beside the TPU's."""
    out = ["## ab_chkfast: the fast CHK flavor against the default "
           "(scripts/ab_chkfast.py; TPU: results/hw_queue_r2/step4.log)", ""]
    for x in lines:
        if "AB" not in x:
            continue
        out += [f"perf, {x['snr_db']} dB, batch {x['batch']}, best of "
                f"{1 + max(r['rep'] for r in x['runs'])} interleaved reps on "
                f"this card ({x['card']}): "
                + ", ".join(f"{k} {v:.1f} frames/s" for k, v in x["AB"].items())
                + f"; fixed_x {x['fixed_x']:.4f}, wave_x {x['wave_x']:.4f}; "
                f"launches {launches_text(x['launches'])}.", ""]
    out += ["| preset | Eb/N0 | batch | frames | errblock | BLER | s | launches | "
            "TPU frames | TPU errblock | TPU BLER | z |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for x in lines:
        if "preset" not in x:
            continue
        t = x["tpu"] or {}
        out.append(
            f"| {x['preset']} | {x['snr_db']} | {x['batch']} | {x['frames']} | "
            f"{x['errblock']} | {x['bler']:.4e} | {x['elapsed_s']:.3f} | "
            f"{launches_text(x['launches'])} | {t.get('frames', '')} | "
            f"{t.get('errblock', '')} | "
            + (f"{t['bler']:.4e} | {x['z']:+.2f} |" if t else " | |"))
    out += ["", "| N | ratio fast/default | 3 sigma | verdict | TPU ratio | "
            "TPU 3 sigma | TPU verdict |", "|---|---|---|---|---|---|---|"]
    for x in lines:
        if "verdict" not in x:
            continue
        t = x["tpu"] or {}
        out.append(f"| {x['N']} | {x['bler_ratio_fast/def']:.4f} | "
                   f"{x['3sigma']:.4f} | {x['verdict']} | "
                   f"{t.get('bler_ratio_fast/def', '')} | {t.get('3sigma', '')} | "
                   f"{t.get('verdict', '')} |")
    return out + [""]


def checks(lines: list) -> list:
    """Each BLER arm within |z| <= 4 of its TPU row, each verdict OK."""
    bad = z_over(lines, lambda x: f"ab_chkfast {x['preset']} @ {x['snr_db']}")
    bad += [f"ab_chkfast N={x['N']}: {x['verdict']}" for x in lines
            if x.get("verdict") not in (None, "OK")]
    return bad


def main_args(args) -> dict:
    """ab_chkfast.py:116-124: --perf unless --bler alone is given."""
    return dict(perf=args.perf or not args.bler, bler=args.bler,
                bler_snr=args.bler_snr, error_blocks=args.error_blocks,
                batch=args.batch)
