"""The MC wave engine's BLER qualification (port of scripts/bler_wavemc.py):
a 1000-error-block BLER A/B at each SNR of the fused wave engine against the
MC engine with counter noise (mc: the TPU kernel's counter threefry, drawn
in the kernel) and with threefry words (mc-tf), through the port's
run_point_waves.  The engines do not decode the same frames (the MC
engine's noise depends on the run's history), so the comparison is
unpaired: sigma of a ratio about sqrt(2 / errors).

The TPU rows each arm is held against (two-proportion z): fused against
hw_queue_r5/step7_bler_mcK32.log (2.0 dB) and step8_bler_mcK32_tail.log
(3.5 dB); mc against the counter-threefry rows of step10_tf32_requal.log
(sections 3 and 4, K=32, 4 spares, cadence 2); mc-tf against step7's row.
The mc rows of step7 and step8 are the TPU's hardware PRNG, which failed
qualification and has no counterpart here: reports show them as history.
On the card mc-tf draws its words with the plain random_bits (then one MC
wave kernel launch a wave); fused runs row 2's kernel and the frame
channel, mc row 3's kernel alone.
"""
from __future__ import annotations

import dataclasses
import time

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

FILE = "bler_wavemc.jsonl"
# bler_wavemc.py:39-45, the environment's defaults
SNRS = [2.0, 3.5]
PRESET = "BP_1024_FASTCHK"
ENGINES = ["fused", "mc", "mc-tf"]
BATCH = 16384
MC_K = 8
MC_CADENCE = 1
FUSED_K = 8
ERROR_BLOCKS = 1000
MAX_FRAMES = 200_000_000

STEP7 = "hw_queue_r5/step7_bler_mcK32.log"
STEP8 = "hw_queue_r5/step8_bler_mcK32_tail.log"
STEP10 = "hw_queue_r5/step10_tf32_requal.log"
# (engine, SNR) -> (log, the section of its row or None)
TPU_ROWS = {("fused", 2.0): (STEP7, None), ("fused", 3.5): (STEP8, None),
            ("mc", 2.0): (STEP10, "4: wave 2.0 dB BLER (tf32)"),
            ("mc", 3.5): (STEP10, "3: wave tail BLER 3.5 dB (tf32)"),
            ("mc-tf", 2.0): (STEP7, None)}
# the hardware PRNG's mc rows, history only
HISTORY_ROWS = {2.0: STEP7, 3.5: STEP8}


def with_itermax(p, iters: int):
    """bler_wavemc.py:34-37: the preset at iterMax `iters`."""
    return dataclasses.replace(
        p, name=f"{p.name}_I{iters}",
        decoder=dataclasses.replace(p.decoder, bp_iters=iters))


def engine_args(eng: str, p, mc_k: int, mc_cadence: int, fused_k: int):
    """bler_wavemc.py:57-78: (preset, wave_iters, run_point_waves keywords)
    of an engine name: fused, mc, mc-tf or mc-c<cadence>, each with an
    optional -i<iterMax> suffix."""
    base = eng
    if "-i" in eng:
        base, it = eng.rsplit("-i", 1)
        p = with_itermax(p, int(it))
    if base == "fused":
        return p, fused_k, dict(engine="fused")
    if base == "mc":
        return p, mc_k, dict(engine="mc", noise="kernel", cadence=mc_cadence)
    if base == "mc-tf":
        return p, mc_k, dict(engine="mc", noise="threefry", cadence=mc_cadence)
    if base.startswith("mc-c"):
        return p, mc_k, dict(engine="mc", noise="kernel", cadence=int(base[4:]))
    raise ValueError(f"unknown engine {eng!r}")


def tpu_row(preset_name: str, eng: str, snr: float):
    """The TPU row an arm is held against, or None."""
    key = TPU_ROWS.get((eng, snr))
    if key is None:
        return None
    log, section = key
    return tpu_ref(log, find(read_log(log).records, preset=preset_name,
                             engine=eng, snr_db=snr,
                             **({"section": section} if section else {})))


def history_row(preset_name: str, snr: float):
    log = HISTORY_ROWS.get(snr)
    return log and tpu_ref(log, find(read_log(log).records, preset=preset_name,
                                     engine="mc", snr_db=snr))


def run(rec: Recorder, snrs=SNRS, preset_name: str = PRESET, engines=ENGINES,
        batch: int = BATCH, mc_k: int = MC_K, mc_cadence: int = MC_CADENCE,
        fused_k: int = FUSED_K, error_blocks: int = ERROR_BLOCKS,
        max_frames: int = MAX_FRAMES) -> list:
    """Every engine at every SNR, then each SNR's ratio line.  An engine's
    line: bler_wavemc.py's keys, with wave_iters, cadence and spares (the
    TPU log records none), errbit, elapsed_s, launches, the TPU row and z.
    A wave arm has no checkpoint: its noise depends on its whole run, so an
    arm cut short runs again from its start."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import run_point_waves

    p0 = preset(preset_name)
    lines = []
    for snr in snrs:
        out = {}
        for eng in engines:
            p, wi, kw = engine_args(eng, p0, mc_k, mc_cadence, fused_k)
            spares = max(2, wi // 8) if kw["engine"] == "mc" else None
            arm = (f"{preset_name}@{snr} {eng} K={wi} cadence={kw.get('cadence')} "
                   f"blocks={error_blocks} cap={max_frames} batch={batch}")
            line = rec.done(arm)
            if line is None:
                t0 = time.perf_counter()
                with counting(rec.device) as launches:
                    r = run_point_waves(p, snr, batch=batch, wave_iters=wi,
                                        device=rec.device,
                                        error_blocks=error_blocks,
                                        max_frames=max_frames, **kw)
                seconds = time.perf_counter() - t0
                t = tpu_row(preset_name, eng, snr) if p is p0 else None
                line = rec.finish(arm, {
                    "preset": preset_name, "engine": eng, "snr_db": snr,
                    "frames": r.frames, "errblock": r.errblock, "bler": r.bler,
                    "fps": r.frames / max(r.elapsed_s, 1e-9),
                    "wave_iters": wi, "cadence": kw.get("cadence"),
                    "spares": spares, "errbit": r.errbit,
                    "elapsed_s": r.elapsed_s, "seconds": seconds,
                    "batch": batch, "launches": launches, "tpu": t,
                    "z": z_against(r.errblock, r.frames, t)})
            out[eng] = line
            lines.append(line)
        base_name = "fused" if "fused" in out else engines[0]
        arm = (f"ratios {preset_name}@{snr} {','.join(engines)} K={mc_k},"
               f"{fused_k} cadence={mc_cadence} blocks={error_blocks} "
               f"cap={max_frames} batch={batch}")
        line = rec.done(arm)
        if line is None:
            base = out[base_name]
            tpu = {e: tpu_row(preset_name, e, snr) for e in out}
            tbase = tpu.get(base_name)
            line = rec.finish(arm, {
                "preset": preset_name, "snr_db": snr,
                f"ratios_vs_{base_name}": {
                    k: v["bler"] / max(base["bler"], 1e-12) for k, v in out.items()},
                "tpu_ratios": {k: v["bler"] / tbase["bler"]
                               for k, v in tpu.items() if v and tbase}})
        lines.append(line)
    return lines


def report(lines: list) -> list:
    out = ["## bler_wavemc: the MC wave engine against the fused engine "
           "(scripts/bler_wavemc.py)", "",
           "TPU rows: fused from step7 (2.0 dB) and step8 (3.5 dB); mc from "
           "step10 (the counter threefry, K=32, 4 spares, cadence 2); mc-tf "
           "from step7 (results/hw_queue_r5/).  The engines decode different "
           "frames, so a ratio's sigma is about sqrt(2 / errors).", "",
           "| engine | Eb/N0 | K | cadence | spares | frames | errblock | BLER | "
           "frames/s | launches | TPU frames | TPU errblock | TPU BLER | z |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for x in lines:
        if "engine" not in x:
            continue
        t = x["tpu"] or {}
        out.append(
            f"| {x['engine']} | {x['snr_db']} | {x['wave_iters']} | {x['cadence'] or ''} | "
            f"{x['spares'] or ''} | {x['frames']} | {x['errblock']} | {x['bler']:.4e} | "
            f"{x['fps']:.1f} | {launches_text(x['launches'])} | "
            f"{t.get('frames', '')} | {t.get('errblock', '')} | "
            + (f"{t['bler']:.4e} | {x['z']:+.2f} |" if t else " | |"))
    out += ["", "| Eb/N0 | ratios to fused (this card) | ratios to fused (TPU) |",
            "|---|---|---|"]
    for x in lines:
        key = next((k for k in x if k.startswith("ratios_vs_")), None)
        if key:
            out.append(f"| {x['snr_db']} | "
                       + ", ".join(f"{k} {v:.4f}" for k, v in x[key].items())
                       + " | " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in x["tpu_ratios"].items())
                       + " |")
    runs = sorted({(x["preset"], x["snr_db"]) for x in lines if "engine" in x})
    hist = [(s, history_row(name, s)) for name, s in runs]
    out += ["", "History (not held): the TPU's hardware-PRNG mc rows, rejected "
            "(docs/ROOFLINE.md:368-372): "
            + "; ".join(f"{s} dB {h['errblock']}/{h['frames']} ({h['file']})"
                        for s, h in hist if h) + ".", ""]
    return out


def checks(lines: list) -> list:
    return z_over(lines, lambda x: f"bler_wavemc {x['engine']} @ {x['snr_db']}")


def main_args(args) -> dict:
    return dict(snrs=[float(s) for s in args.snrs.split(",")],
                preset_name=args.preset or PRESET,
                engines=args.engines.split(","), batch=args.batch or BATCH,
                mc_k=args.mc_k, mc_cadence=args.mc_cadence,
                fused_k=args.fused_k, error_blocks=args.error_blocks,
                max_frames=args.max_frames)
