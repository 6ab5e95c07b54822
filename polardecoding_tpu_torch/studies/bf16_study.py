"""The precision study (results/REPRODUCTION.md, "Precision study", both
parts), each arm to at least 1000 error blocks.

Part 2 is the port of scripts/bf16_study.py: BP with its message state in
bfloat16 against float32 on the same frame stream (make_frame_step with
llr_dtype, the key PRNGKey(seed), the LLRs made in float32 in both arms),
BP_128 at 4.0 dB and BP_1024 at 3.5 dB, batch 8192.  The JAX study ran
both arms on its jnp engine.  Here the decode kernels are float32-only, so
the bfloat16 arm runs the plain versions (engine="plain") on the card, and
the float32 arm runs row 1's kernel and the frame channel, which give the
plain float32 version's bits on every frame.

Part 1 (no script archived): the float64 C engine (native.golden_mc, the
reference's algorithm on its own Ranq1 noise) against the float32 port,
BP_128 and SC_128 at 4.0 dB.  The C arm runs on the host in chunks of
C_CHUNK frames, chunk c under seed C_SEED + c, one thread a core (ctypes
lets go of the interpreter lock in the call); it counts whole rounds of
chunks.  The float32 arm is run_point at batch 8192 through the kernels (SC
as the list kernel at L=1).

The TPU's records are the table rows of results/REPRODUCTION.md (:76-77,
:96-97): BLERs only, so an arm's z takes the TPU arm as 1000 error blocks
at its archived BLER.
"""
from __future__ import annotations

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

from polardecoding_tpu_torch.studies._common import (
    Recorder,
    launches_text,
    run_point_resumable,
    run_resumable,
    z_against,
    z_over,
)

FILE = "precision.jsonl"
# bf16_study.py:68-69: (preset, SNR, batch, max frames)
POINTS = [("BP_128", 4.0, 8192, int(3e6)),
          ("BP_1024", 3.5, 8192, int(3e7))]
BLOCKS = 1000
QUICK_BLOCKS = 100
DTYPES = ("f32", "bfloat16")
# part 1: (preset, SNR, f32 batch, max frames)
PART1 = [("BP_128", 4.0, 8192, int(3e6)), ("SC_128", 4.0, 8192, int(3e6))]
C_CHUNK = 32768
C_SEED = 1024
REPRODUCTION = "results/REPRODUCTION.md"
# REPRODUCTION.md:76-77 and :96-97: BLER of each arm, ratio and its CI
TPU = {
    ("BP_128", 4.0, "c64"): (1.913e-3, 76), ("BP_128", 4.0, "f32_tpu"): (2.035e-3, 76),
    ("SC_128", 4.0, "c64"): (2.016e-3, 77), ("SC_128", 4.0, "f32_tpu"): (2.073e-3, 77),
    ("BP_128", 4.0, "f32"): (1.899e-3, 96), ("BP_128", 4.0, "bfloat16"): (1.886e-3, 96),
    ("BP_1024", 3.5, "f32"): (2.151e-4, 97), ("BP_1024", 3.5, "bfloat16"): (2.157e-4, 97),
}
TPU_RATIOS = {("BP_128", 4.0, 1): (1.06, 0.09), ("SC_128", 4.0, 1): (1.03, 0.09),
              ("BP_128", 4.0, 2): (0.993, 0.044), ("BP_1024", 3.5, 2): (1.003, 0.045)}
TPU_BLOCKS = 1000


def tpu_arm(name: str, snr: float, arm: str):
    """A TPU arm as a line carries it, its counts taken as TPU_BLOCKS error
    blocks at its BLER."""
    got = TPU.get((name, snr, arm))
    if got is None:
        return None
    bler, line = got
    return {"bler": bler, "errblock": TPU_BLOCKS,
            "frames": round(TPU_BLOCKS / bler),
            "file": f"{REPRODUCTION}:{line}",
            "counts": f"taken as {TPU_BLOCKS} error blocks at the archived BLER"}


def arm_line(res, extra: dict, tpu) -> dict:
    blocks = max(res.errblock, 1)
    return dict({"preset": res.preset, "snr_db": res.snr_db,
                 "errblock": res.errblock, "frames": res.frames,
                 "bler": res.bler, "ci_rel": 1.0 / math.sqrt(blocks),
                 "errbit": res.errbit, "pm_ties": res.pm_ties,
                 "elapsed_s": res.elapsed_s,
                 "fps": res.frames / max(res.elapsed_s, 1e-9)},
                **extra, tpu=tpu, z=z_against(res.errblock, res.frames, tpu))


def ratio_line(name, snr, part, num, den, keys) -> dict:
    """num / den with the script's CI, ratio * hypot of the arms' 1/sqrt(blocks)."""
    ratio = num["bler"] / max(den["bler"], 1e-300)
    ci = ratio * math.hypot(num["ci_rel"], den["ci_rel"])
    t = TPU_RATIOS.get((name, snr, part))
    return {"part": part, "preset": name, "snr_db": snr, keys[0]: ratio,
            keys[1]: ci, "tpu": None if t is None else {
                keys[0]: t[0], keys[1]: t[1], "file": REPRODUCTION}}


def run_arm(rec: Recorder, name: str, snr: float, dtype: str, blocks: int,
            batch: int, max_frames: int):
    """bf16_study.py:36-57 (run_arm): the frame step under PRNGKey(seed)
    from frame 0 until `blocks` error blocks or max_frames; the bfloat16
    arm with engine="plain".  Resumable (run_resumable)."""
    import torch

    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import prng_key
    from polardecoding_tpu_torch.parallel.harness import make_frame_step

    p = preset(name)
    bf16 = dtype == "bfloat16"
    step = make_frame_step(p, batch, rec.device,
                           llr_dtype=torch.bfloat16 if bf16 else None,
                           engine="plain" if bf16 else "auto")
    key = prng_key(p.sweep.seed, rec.device)
    sigma = float(10.0 ** (-snr / 20.0))

    def advance(res, end):
        t0 = time.perf_counter()
        while res.errblock < blocks and res.frames < end:
            eb, bl, ties = (int(v) for v in step(key, res.frames, sigma))
            res.errbit += eb
            res.errblock += bl
            res.pm_ties += ties
            res.frames += batch
        res.elapsed_s += time.perf_counter() - t0

    arm = f"part2 {name}@{snr} {dtype} blocks={blocks} cap={max_frames} batch={batch}"
    return arm, run_resumable(rec, arm, p, snr, batch, blocks, max_frames, advance)


def c_arm(rec: Recorder, name: str, snr: float, blocks: int, chunk: int = C_CHUNK,
          workers: int = 0):
    """The float64 C engine until `blocks` error blocks: rounds of
    `workers` chunks (default one a core, at most 8), chunk c of `chunk`
    frames under seed C_SEED + c, a checkpoint after each round.  Returns
    (arm, PointResult)."""
    import numpy as np

    from polardecoding_tpu_torch import native
    from polardecoding_tpu_torch.analysis.construction import code_info_set
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.convert import point_result_from_json
    from polardecoding_tpu_torch.parallel.harness import PointResult

    p = preset(name)
    code, dec = p.code, p.decoder
    info = np.asarray(code_info_set(code))
    workers = workers or min(8, os.cpu_count() or 1)
    arm = f"part1 {name}@{snr} c64 blocks={blocks} chunk={chunk}"
    state = rec.checkpoint(arm)
    res = (point_result_from_json(state["point"]) if state
           else PointResult(name, snr, 0, 0, 0, C_SEED))
    chunks = state["chunks"] if state else 0

    def one(c):
        eb, ebl, _ = native.golden_mc(code.N, code.K, info, C_SEED + c, snr, chunk,
                                      decoder=dec.kind, iters=dec.bp_iters,
                                      return_bits=False)
        return eb, ebl

    with ThreadPoolExecutor(max_workers=workers) as pool:
        while res.errblock < blocks:
            t0 = time.perf_counter()
            for eb, ebl in pool.map(one, range(chunks, chunks + workers)):
                res.errbit += eb
                res.errblock += ebl
                res.frames += chunk
            chunks += workers
            res.elapsed_s += time.perf_counter() - t0
            rec.save(arm, {"point": res.to_json(code.num_info), "chunks": chunks})
            rec.log(f"{arm}: {res.frames} frames, {res.errblock} error blocks, "
                    f"{res.elapsed_s:.3f} s")
    return arm, res, chunks, workers


def run(rec: Recorder, blocks: int = BLOCKS, quick: bool = False,
        points=POINTS, part1=PART1, c_chunk: int = C_CHUNK, c_workers: int = 0) -> list:
    """Part 1's arms (C, then float32) and ratio, then part 2's (float32,
    then bfloat16) and ratio, as bf16_study.py orders its points; returns
    the lines."""
    if quick:
        blocks = QUICK_BLOCKS
    lines = []
    for name, snr, batch, maxf in part1:
        arm = f"part1 {name}@{snr} c64 blocks={blocks} chunk={c_chunk}"
        c = rec.done(arm)
        if c is None:
            arm, res, chunks, workers = c_arm(rec, name, snr, blocks, c_chunk,
                                              c_workers)
            c = rec.finish(arm, arm_line(res, {
                "part": 1, "chunks": chunks, "chunk": c_chunk,
                "threads": workers, "launches": {}},
                tpu_arm(name, snr, "c64")))
        arm = f"part1 {name}@{snr} f32 blocks={blocks} cap={maxf} batch={batch}"
        f = rec.done(arm)
        if f is None:
            from polardecoding_tpu_torch.configs import preset

            res, launches = run_point_resumable(rec, arm, preset(name), snr, batch,
                                                blocks, maxf)
            f = rec.finish(arm, arm_line(res, {
                "part": 1, "dtype": "f32", "batch": batch, "launches": launches},
                tpu_arm(name, snr, "f32_tpu")))
        lines += [c, f, _ratio(rec, f"part1 ratio {name}@{snr} blocks={blocks}",
                               lambda: ratio_line(name, snr, 1, f, c,
                                                  ("bler_ratio_f32_over_f64", "ci")))]
    for name, snr, batch, maxf in points:
        pair = {}
        for dtype in DTYPES:
            arm = f"part2 {name}@{snr} {dtype} blocks={blocks} cap={maxf} batch={batch}"
            line = rec.done(arm)
            if line is None:
                arm, (res, launches) = run_arm(rec, name, snr, dtype, blocks, batch,
                                               maxf)
                line = rec.finish(arm, arm_line(res, {
                    "part": 2, "dtype": dtype, "batch": batch,
                    "engine": "plain" if dtype == "bfloat16" else "auto",
                    "launches": launches}, tpu_arm(name, snr, dtype)))
            pair[dtype] = line
            lines.append(line)
        lines.append(_ratio(rec, f"part2 ratio {name}@{snr} blocks={blocks}",
                            lambda: ratio_line(name, snr, 2, pair["bfloat16"],
                                               pair["f32"],
                                               ("bler_ratio_bf16_over_f32", "ci"))))
    return lines


def _ratio(rec, arm, make):
    return rec.done(arm) or rec.finish(arm, make())


def checks(lines: list) -> list:
    return z_over(lines, lambda x: f"precision part {x['part']} {x['preset']} "
                                   f"{x.get('dtype', 'c64')}")


def report(lines: list, head: list) -> list:
    """PRECISION.md."""
    out = ["# Precision study (H100)", ""] + head + [
        "Each arm to at least the error blocks of its line; the TPU's arms "
        f"are BLERs only ({REPRODUCTION}:76-77, :96-97), taken as "
        f"{TPU_BLOCKS} error blocks for z.  ci: the ratio times the hypot of "
        "the arms' 1/sqrt(error blocks), as scripts/bf16_study.py.", "",
        "## Part 1: float32 against the float64 C engine", "",
        "The C arm: native/golden_ref.c through native.golden_mc on the "
        "card machine's host, the reference's own noise, in chunks of "
        f"{C_CHUNK} frames under seeds {C_SEED} + chunk.  The float32 arm: "
        "run_point at batch 8192 through the kernels (BP: row 1; SC: row 6 "
        "at L=1) and the frame channel.", "",
        "| preset | arm | frames | errblock | BLER | s | launches | TPU record's "
        "BLER | z |", "|---|---|---|---|---|---|---|---|---|"]
    out += [_row(x) for x in lines if x.get("part") == 1 and "bler" in x]
    out += ["", "| preset | ratio f32/f64 | ci | TPU ratio |", "|---|---|---|---|"]
    out += [f"| {x['preset']} @{x['snr_db']} dB | {x['bler_ratio_f32_over_f64']:.4f} | "
            f"{x['ci']:.4f} | {_tpu_ratio(x, 'bler_ratio_f32_over_f64')} |"
            for x in lines if "bler_ratio_f32_over_f64" in x]
    out += ["", "## Part 2: bfloat16 message state against float32 "
            "(scripts/bf16_study.py)", "",
            "Frames under PRNGKey(seed) from frame 0, batch 8192, the LLRs in "
            "float32 in both arms.  The float32 arm runs row 1's kernel "
            "(engine auto), which gives the plain float32 version's bits on "
            "every frame (chip_smoke.py); the bfloat16 arm the plain versions "
            "on the card (engine plain): the decode kernels are float32-only.  "
            "The JAX study ran both arms on its jnp engine.", "",
            "| preset | arm | frames | errblock | BLER | s | launches | TPU record's "
            "BLER | z |", "|---|---|---|---|---|---|---|---|---|"]
    out += [_row(x) for x in lines if x.get("part") == 2 and "bler" in x]
    out += ["", "| preset | ratio bf16/f32 | ci | TPU ratio |", "|---|---|---|---|"]
    out += [f"| {x['preset']} @{x['snr_db']} dB | {x['bler_ratio_bf16_over_f32']:.4f} | "
            f"{x['ci']:.4f} | {_tpu_ratio(x, 'bler_ratio_bf16_over_f32')} |"
            for x in lines if "bler_ratio_bf16_over_f32" in x]
    return out + [""]


def _tpu_ratio(x, key):
    t = x["tpu"]
    return f"{t[key]} ± {t['ci']}" if t else ""


def _row(x):
    t = x["tpu"] or {}
    who = x.get("dtype") or ("C float64, %d threads" % x["threads"])
    return (f"| {x['preset']} @{x['snr_db']} dB | {who} | {x['frames']} | "
            f"{x['errblock']} | {x['bler']:.4e} | {x['elapsed_s']:.3f} | "
            f"{launches_text(x['launches'])} | "
            + (f"{t['bler']:.4g} | {x['z']:+.2f} |" if t else " | |"))


def main_args(args) -> dict:
    return dict(blocks=args.blocks, quick=args.quick)
