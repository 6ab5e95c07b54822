#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (polardecoding_tpu_torch) on one GPU.

  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA source of the port (polardecoding_tpu_torch/csrc), one
   nvcc per source, all started together, and prints the build time and
   the compiler's register/shared-memory report;
3. holds the BP decode kernel against its plain PyTorch version on the card:
   u_hat bit-equal on every frame for N in {128, 1024}, B=512, LLRs from the
   port's channel at 1.0 and 2.0 dB, both min-sum flavors, early stop off
   and every 4 iterations; SPA equal on every frame the plain version
   decodes correctly (exp/log1p rounding may steer a non-converged frame);
   the whole frame step's counters equal with the kernel and with the plain
   decoder at the main path's batch, 8192; the channel on the card within
   1e-5 of the channel on the CPU;
4. holds the SCL list-decode kernel against its plain version on the card:
   u_all, PM and tie counter bit-equal on every frame at B=512, LLRs from
   the port's channel at 1.0 and 2.0 dB, N in {128, 1024} with the presets'
   masks and L in {1, 2, 8, 16, 32}; a random frozen mask at N=1024 with L=4
   and L=32 (the traced-mask kernels' contract); a forced-tie input whose
   tie counter must be non-zero; and the frame-step counters at 1.5 dB equal
   with kernel and plain decoder for SCL_1024_L8 (batch 16384),
   CASCL_1024_L8 and SC_1024 (4096) and CASCL_1024_L32 (1024);
5. the same for the kernel's rate-1 flavor (r1 in {2, 4}, wloop 2, L in
   {1, 2, 4, 8, 16, 32}): the _FASTR1 presets' masks (N=128 and 1024, CRC-24
   included) at 1.0 and 2.0 dB, all-info masks (one R1 node at the root) and
   random masks at N=32 and 1024, the forced-tie input; and the step
   counters at 1.5 dB of SCL_1024_L8_FASTR1 (batch 16384),
   CASCL_1024_L8_FASTR1 and SCL_1024_L16_FASTR1 (4096);
6. drives each main path with the launch counts at 0: four make_frame_step
   steps, then run_point at 2.0 dB; the path's kernel must have been
   launched and no other.  BP_1024 at batch 8192 to 200 error blocks, BLER
   in [0.020, 0.043] (BASELINE.md: 0.02948 and 0.03292 for two seeds);
   SCL_1024_L8 and SCL_1024_L8_FASTR1 at batch 16384 to 100 error blocks,
   BLER in [0.0055, 0.0125] (BASELINE.md: 9.128e-3, a 5-seed mean, and
   7.85e-3 from a third-party oracle; the flavor's BLER is within 0.5% of
   exact's, docs/ROOFLINE.md:618); CASCL_1024_L8_FASTR1 and
   SCL_1024_L16_FASTR1 at batch 16384 to 50 error blocks, BLER in
   [0.002, 0.007] (BASELINE.md: 4.088e-3) and [0.0045, 0.0125] (8.032e-3);
7. holds the four wave-engine kernels against their plain versions on the
   card, bit for bit on every frame: the fused wave kernel (check_every 0
   and 4) and the unfused one over four waves with retirements, N in
   {128, 1024}, B=512 (state, u_hat, done); the MC wave kernel over five
   waves, the last in drain, at K=32 with cadence 1 and 2, counter noise
   and given words (state, meta, stats); the MC channel at B=8192 in both
   noise modes; and the fused and unfused engines' per-step counters at
   B=16384, equal with kernels and plain versions and to each other;
8. drives the wave paths, each with the launch counts at 0: run_point on
   BP_1024_ES at 2.0 dB (the fused engine, K=8), run_point_waves on
   BP_1024_FASTCHK with engine="mc", K=32, cadence 2 (bench.py's BP leg)
   and on BP_1024_ES with fused=False, each at batch 16384 to 200 error
   blocks with BLER in [0.020, 0.043]; then one make_frame_step step with
   channel="mc" at batch 8192; each path's kernel must have been launched;
9. times each kernel and its plain version (plain, kernel, kernel, plain) at
   its main path's shape, BP_1024 with B=8192 and 100 iterations,
   SCL_1024_L8 with B=16384 and SCL_1024_L8_FASTR1 on the same LLRs (the
   exact kernel beside it), one wave at B=16384 (K=8 fused and unfused,
   K=32 MC) and the MC channel at B=8192, and holds the kernel's output
   bit-equal to the plain version's there on every frame; times each whole
   frame step (with its peak device memory), and its encode and channel
   stages apart, the fused ES wave step split into kernel and channel, and
   the retired frames per second of the fused and MC wave paths over one
   chunk of eight steps, with CUDA events after warmup;
10. traces three steps of each of the five paths with torch.profiler: wall
   and device time per step, the device's idle share, the device operations
   per step and the kernels that take the most time;
11. prints the kernels line (each kernel's launches on its main path, its
   largest difference from the plain version, its time, the plain
   version's, and its bound: the larger of its bytes over the H100 SXM's
   3.35 TB/s, the operations its function needs over 33.5e12 per second,
   the card's rate for float32 adds, compares and selects, and the integer
   ones among them over 16.7e12, its INT32 rate), then
   {"ok": true, "device": {...}} last.

Any failed phase raises and exits non-zero; without a CUDA device, or
without the package beside this file, it exits non-zero before printing a
result.  The port imports no JAX.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import torch

# shapes of each phase; the main path's are those of the JAX package's
# bench.py fixed-iteration BP leg
CMP_PRESETS = ("BP_128", "BP_1024")
CMP_BATCH = 512
CMP_SNRS = (1.0, 2.0)
MAIN_PRESET = "BP_1024"
MAIN_BATCH = 8192
MAIN_STEPS = 4
MAIN_SNR = 2.0
MAIN_ERROR_BLOCKS = 200
BLER_RANGE = (0.020, 0.043)
KERNEL_REPS = 10
DEVICE = "cuda"
STEP_REPS = 5
PROFILE_STEPS = 3
# the SCL path: bench.py's exact SCL leg (batch 16384)
SCL_CMP_PRESETS = ("SCL_128_L8", "SCL_1024_L8")
SCL_CMP_LISTS = (1, 2, 8, 16, 32)
SCL_RANDOM_MASK_LISTS = (4, 32)
SCL_STEP_CASES = (("SCL_1024_L8", 16384), ("CASCL_1024_L8", 4096),
                  ("SC_1024", 4096), ("CASCL_1024_L32", 1024))
# below the main path's 2.0 dB, so that CASCL_1024_L32's 1024 frames hold
# block errors
SCL_STEP_SNR = 1.5
SCL_PRESET = "SCL_1024_L8"
SCL_BATCH = 16384
SCL_ERROR_BLOCKS = 100
SCL_BLER_RANGE = (0.0055, 0.0125)
SCL_KERNEL_REPS = 5
# the rate-1 flavor: bench.py's default SCL leg (SCL_1024_L8_FASTR1, batch
# 16384) and the other _FASTR1 presets (SCL_1024_L16_FASTR1's mask is
# SCL_1024_L8_FASTR1's); wloop is the presets' (models/scl.default_wloop)
R1_CMP_PRESETS = ("SCL_128_L8_FASTR1", "SCL_1024_L8_FASTR1",
                  "CASCL_1024_L8_FASTR1")
R1_CMP_LISTS = (1, 2, 4, 8, 16, 32)
R1_CMP_R1 = (2, 4)
R1_MASK_NS = (32, 1024)
R1_STEP_CASES = (("SCL_1024_L8_FASTR1", 16384), ("CASCL_1024_L8_FASTR1", 4096),
                 ("SCL_1024_L16_FASTR1", 4096))
R1_PRESET = "SCL_1024_L8_FASTR1"
R1_MAIN_PATHS = (("SCL_1024_L8_FASTR1", 100, (0.0055, 0.0125)),
                 ("CASCL_1024_L8_FASTR1", 50, (0.002, 0.007)),
                 ("SCL_1024_L16_FASTR1", 50, (0.0045, 0.0125)))
WLOOP = 2
# the wave paths: run_point's early-stop path (the fused engine at its
# default K=8) and bench.py's BP leg (engine mc, BP_1024_FASTCHK, K=32,
# cadence 2, batch 16384; make_wave_step_mc's default spares at K=32)
WAVE_PRESET = "BP_1024_ES"
MC_PRESET = "BP_1024_FASTCHK"
WAVE_BATCH = 16384
WAVE_ITERS = 8
MC_ITERS = 32
MC_CADENCE = 2
MC_SPARES = 4
WAVE_ERROR_BLOCKS = 200
WAVE_CMP_BATCH = 512
WAVE_CMP_WAVES = 4
WAVE_STEP_CMP_STEPS = 3
MC_CMP_WAVES = 5
MC_CHANNEL_BATCH = 8192
WAVE_KERNEL_REPS = 10
WAVE_CHUNK = 8  # run_point_waves' steps per counter read-back
# H100 SXM (NVIDIA's data sheet): HBM bytes/s.  Its 67 TFLOP/s of float32
# outside the tensor cores counts an FMA as two operations (132 SMs x 128
# lanes x 1.98 GHz x 2).  The decoders do no FMA: every operation counted
# below is an add, compare, select, min, abs or xor, of which a lane issues
# at most one per clock, so their peak is half that
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
# operations of one table-corrected min-sum CHK as the plain version writes
# it (ops/chk.chk): a+b, a-b, two abs, two 3-level select trees of 3
# compares and 3 selects, the delta difference, the sign (two compares, an
# equality, a select), |a|, |b|, min, the product and the final add
CHK_OPS = 27
# PHI (ops/chk.phi_penalties_both): |l| and its 3-level delta tree, shared
# by both penalties; then per penalty a compare, a select, the add to the
# delta and the add to the path metric
PHI_BASE_OPS = 7
PHI_PEN_OPS = 4
# channel on the card vs on the CPU: log1p's last ulp may differ between
# the two math libraries; an LLR of ~20 has an ulp of 2e-6, so 1e-5 is a
# few ulp at the largest magnitudes seen at 2.0 dB
CHANNEL_ATOL = 1e-5
# An SM has 64 INT32 lanes beside its 128 float32 ones: integer operations
# issue at most 132 x 64 x 1.98e9 per second, and every operation, integer or
# float, shares the issue rate OPS_PER_S
INT_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per element of the MC channel's noise word (threefry2x32
# in csrc/noise.cuh, first output word): the key added to the counter's low
# word (the high word plus the key is one per launch), 20 mixes of an add, a
# rotate (one funnel shift) and a xor, less the last mix's rotate and xor and
# the last injection into the second word, which no output reads, and 9 key
# injections of one add (a key plus its round number is one per launch)
THREEFRY_INT_OPS = 1 + 20 * 3 - 2 + 9
# then the LLR: integer, the uniform's shift and XLA's log's exponent and
# mantissa bits (a shift, a subtraction, one three-input logic op); the
# rest, the uniform (a conversion and 4), (1-x)(1+x) (3), XLA's log (a
# conversion and 22), the negation, the branch compare, select, sqrt and
# subtractions (5), Giles' 8 fmaf and their coefficient selects (17), the
# product with x (1) and the LLR's sign select, fmaf and product (4)
LLR_INT_OPS = 1 + 3
LLR_OPS = 5 + 3 + 23 + 1 + 5 + 17 + 1 + 4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def kernels():
    """{kernel name: (wrapper module, its count's attribute, key of the count
    in a dict-valued attribute or None)}."""
    from polardecoding_tpu_torch.ops import (bp_kernel, bp_wave_kernel,
                                             bp_wave_mc_kernel, channel_kernel,
                                             scl_kernel)

    return {"bp_decode": (bp_kernel, "LAUNCHES", None),
            "scl_decode": (scl_kernel, "LAUNCHES", None),
            "scl_decode_r1": (scl_kernel, "LAUNCHES_R1", None),
            "bp_wave_fused": (bp_wave_kernel, "LAUNCHES", "bp_wave_fused"),
            "bp_wave": (bp_wave_kernel, "LAUNCHES", "bp_wave"),
            "bp_wave_mc": (bp_wave_mc_kernel, "LAUNCHES", None),
            "mc_channel": (channel_kernel, "LAUNCHES", None)}


def reset_counts():
    for mod, attr, key in kernels().values():
        if key is None:
            setattr(mod, attr, 0)
        else:
            getattr(mod, attr)[key] = 0


def launches(name) -> int:
    mod, attr, key = kernels()[name]
    count = getattr(mod, attr)
    return count if key is None else count[key]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_build(_build):
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    emit({"build": {"seconds": seconds, "sources": _build.sources(),
                    "built": sorted(logs)}})
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")


def llr_frames(name, batch, snr_db, device, seed=7):
    """Channel LLRs of frames 0..batch-1 of a preset at snr_db from the
    port's own pipeline (CRC included), with the code's frozen mask and the
    true u."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (awgn_llr, fold_in,
                                                     frame_keys, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu, scatter_info
    from polardecoding_tpu_torch.parallel.harness import (_crc_encode,
                                                          code_tables,
                                                          payload_from_index)

    code = preset(name).code
    tables = code_tables(code, device)
    fidx = torch.arange(batch, device=device)
    w = _crc_encode(code, payload_from_index(fidx, tables.pn, code.K))
    key = fold_in(prng_key(seed, device), int(round(snr_db * 100)))
    llr = awgn_llr(encode_info_mxu(w, tables.g_rows), frame_keys(key, fidx),
                   sigma_from_ebn0_db(snr_db))
    return llr, tables.frozen, scatter_info(w, tables.info_set, code.N)


def phase_compare():
    """Kernel against plain version on the card; returns the largest
    |u_kernel - u_plain| over the min-sum cases (0 when bit-equal)."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.bp import bp_decode
    from polardecoding_tpu_torch.ops.bp_kernel import bp_decode_cuda
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_frame_step

    worst = 0
    for name in CMP_PRESETS:
        for snr in CMP_SNRS:
            llr, frozen, u = llr_frames(name, CMP_BATCH, snr, DEVICE)
            check(bool(torch.isfinite(llr).all()), f"{name}: non-finite LLRs")
            cases = [(f, es) for f in ("minsum_lut", "minsum_lut_fast")
                     for es in (0, 4)] + [("spa", 0)]
            for flavor, es in cases:
                got = bp_decode_cuda(llr, frozen, iters=100, flavor=flavor,
                                     early_stop_every=es)
                want = bp_decode(llr, frozen, iters=100, flavor=flavor,
                                 early_stop_every=es)
                torch.cuda.synchronize()
                check(got.dtype == torch.int8 and got.shape == want.shape,
                      f"kernel output {got.dtype} {tuple(got.shape)}")
                equal = (got == want).all(dim=1)
                correct = (want == u).all(dim=1)
                rec = {"compare": {"preset": name, "snr_db": snr,
                                   "flavor": flavor, "early_stop_every": es,
                                   "frames": CMP_BATCH,
                                   "frames_equal": int(equal.sum()),
                                   "plain_correct": int(correct.sum())}}
                emit(rec)
                if flavor == "spa":
                    check(bool(equal[correct].all()),
                          f"spa kernel differs on a frame the plain version "
                          f"decodes correctly: {rec}")
                else:
                    check(bool(equal.all()), f"kernel != plain: {rec}")
                    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
                    worst = max(worst, int(diff.max()))

    p = preset(MAIN_PRESET)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    counters = {}
    for engine in ("auto", "plain"):
        step = make_frame_step(p, MAIN_BATCH, DEVICE, engine=engine)
        counters[engine] = [int(c) for c in step(key, 0, sigma)]
    emit({"step_counters": counters})
    check(counters["auto"] == counters["plain"],
          f"frame step counters differ between kernel and plain: {counters}")

    llr_gpu, _, _ = llr_frames(MAIN_PRESET, 64, MAIN_SNR, DEVICE)
    llr_cpu, _, _ = llr_frames(MAIN_PRESET, 64, MAIN_SNR, "cpu")
    dev = float((llr_gpu.cpu() - llr_cpu).abs().max())
    emit({"channel_gpu_vs_cpu": {"max_abs_diff": dev,
                                 "equal_share": float((llr_gpu.cpu() == llr_cpu)
                                                      .float().mean())}})
    check(dev <= CHANNEL_ATOL, f"channel on the card differs from the CPU by {dev}")
    return worst


def phase_main(name, batch, error_blocks, bler_range, kernel):
    """Drive one main path with every launch count at 0 just before: four
    make_frame_step steps, then run_point at MAIN_SNR; returns the count of
    launches of the path's kernel read just after, and checks that no other
    kernel was launched."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_frame_step, run_point

    p = preset(name)
    list_decoder = p.decoder.kind in ("scl", "cascl")
    reset_counts()
    t0 = time.perf_counter()
    step = make_frame_step(p, batch, DEVICE)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    steps = [[int(c) for c in step(key, s * batch, sigma)]
             for s in range(MAIN_STEPS)]
    res = run_point(p, MAIN_SNR, batch=batch, device=DEVICE,
                    error_blocks=error_blocks)
    torch.cuda.synchronize()
    count = launches(kernel)
    others = {k: launches(k) for k in kernels() if k != kernel and launches(k)}
    emit({"main_path": {"preset": p.name, "batch": batch,
                        "steps": steps, "point": res.to_json(p.code.num_info),
                        "seconds": time.perf_counter() - t0,
                        "kernel": kernel, "launches": count,
                        "other_launches": others}})
    for eb, ebl, ties in steps:
        check(0 <= ebl <= batch and eb >= ebl and 0 <= ties <= batch
              and (list_decoder or ties == 0),
              f"implausible step counters {steps}")
    check(res.errblock >= error_blocks and res.frames % batch == 0,
          f"run_point stopped early: {res}")
    k = res.frames // batch
    if k <= MAIN_STEPS:  # frames are pure in (seed, frame index)
        check([res.errbit, res.errblock, res.pm_ties]
              == [sum(s[i] for s in steps[:k]) for i in range(3)],
              "run_point's counters differ from the same frames' steps")
    check(bler_range[0] <= res.bler <= bler_range[1],
          f"{name}: BLER {res.bler} at {MAIN_SNR} dB outside {bler_range}")
    check(count == MAIN_STEPS + k, f"kernel launched {count} times")
    check(not others, f"{name}: other kernels launched: {others}")
    return count


def _scl_diff(got, want):
    """Largest |kernel - plain| over u_all, PM and ties (0 when bit-equal),
    and the frames equal in all three."""
    worst = 0.0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"kernel output {g.dtype} {tuple(g.shape)}, plain {w.dtype} "
              f"{tuple(w.shape)}")
        worst = max(worst, float((g.double() - w.double()).abs().max()))
    u, pm, ties = ((g == w).reshape(g.shape[0], -1).all(dim=1)
                   for g, w in zip(got, want))
    return worst, int((u & pm & ties).sum())


def phase_scl_compare():
    """SCL kernel against its plain version on the card; returns the
    largest |kernel - plain| over every case (0 when bit-equal)."""
    import numpy as np

    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.scl import scl_decode
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.scl_kernel import scl_decode_cuda
    from polardecoding_tpu_torch.parallel.harness import make_frame_step
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    worst_all = 0.0

    def compare(llr, frozen, L, **rec):
        nonlocal worst_all
        got = scl_decode_cuda(llr, frozen, L)
        want = scl_decode(llr, frozen, list_size=L, return_all=True,
                          return_ties=True)
        torch.cuda.synchronize()
        worst, equal = _scl_diff(got, want)
        rec = {"scl_compare": dict(rec, L=L, frames=llr.shape[0],
                                   frames_equal=equal,
                                   tie_frames=int((want[2] > 0).sum()),
                                   max_abs_err=worst)}
        emit(rec)
        check(worst == 0 and equal == llr.shape[0], f"kernel != plain: {rec}")
        worst_all = max(worst_all, worst)
        return want

    for name in SCL_CMP_PRESETS:
        for snr in CMP_SNRS:
            llr, frozen, _ = llr_frames(name, CMP_BATCH, snr, DEVICE)
            for L in SCL_CMP_LISTS:
                compare(llr, frozen, L, preset=name, snr_db=snr)
    # a random frozen mask, not a preset's: the contract of the two
    # traced-mask TPU kernels (subtree for L <= 8, tree for L >= 16)
    rng = np.random.default_rng(2024)
    random_mask = torch.as_tensor(rng.random(1024) < 0.5, device=DEVICE)
    llr, _, _ = llr_frames("SCL_1024_L8", CMP_BATCH, 1.0, DEVICE)
    for L in SCL_RANDOM_MASK_LISTS:
        compare(llr, random_mask, L, preset="random mask N=1024", snr_db=1.0)
    # symmetric +-1 LLRs force exact PM ties at the median
    tie_llr = torch.tensor([1.0, -1.0] * 16, device=DEVICE).repeat(64, 1)
    tie_mask = torch.as_tensor(frozen_mask(32, 20), device=DEVICE)
    want = compare(tie_llr, tie_mask, 4, preset="forced ties N=32")
    check(int(want[2].sum()) > 0, "the forced-tie input tied nowhere")

    counters = {}
    for name, batch in SCL_STEP_CASES:
        p = preset(name)
        key = fold_in(prng_key(p.sweep.seed, DEVICE),
                      int(round(SCL_STEP_SNR * 100)))
        sigma = sigma_from_ebn0_db(SCL_STEP_SNR)
        got = {}
        for engine in ("auto", "plain"):
            step = make_frame_step(p, batch, DEVICE, engine=engine)
            got[engine] = [int(c) for c in step(key, 0, sigma)]
        counters[name] = got
        check(got["auto"] == got["plain"],
              f"{name}: frame step counters differ between kernel and plain: "
              f"{got}")
    emit({"scl_step_counters": dict(counters, snr_db=SCL_STEP_SNR)})
    return worst_all


def phase_scl_r1_compare():
    """The list-decode kernel's rate-1 flavor against its plain version on
    the card; returns the largest |kernel - plain| over every case (0 when
    bit-equal)."""
    import numpy as np

    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.scl import scl_decode
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.scl_kernel import scl_decode_cuda
    from polardecoding_tpu_torch.parallel.harness import make_frame_step
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    worst_all = 0.0

    def compare(llr, frozen, L, r1, **rec):
        nonlocal worst_all
        got = scl_decode_cuda(llr, frozen, L, r1=r1, wloop=WLOOP)
        want = scl_decode(llr, frozen, list_size=L, return_all=True,
                          return_ties=True, r1=r1, wloop=WLOOP)
        torch.cuda.synchronize()
        worst, equal = _scl_diff(got, want)
        rec = {"scl_r1_compare": dict(rec, N=llr.shape[1], L=L, r1=r1,
                                      frames=llr.shape[0], frames_equal=equal,
                                      tie_frames=int((want[2] > 0).sum()),
                                      max_abs_err=worst)}
        emit(rec)
        check(worst == 0 and equal == llr.shape[0], f"kernel != plain: {rec}")
        worst_all = max(worst_all, worst)
        return want

    for name in R1_CMP_PRESETS:
        for snr in CMP_SNRS:
            llr, frozen, _ = llr_frames(name, CMP_BATCH, snr, DEVICE)
            for L in R1_CMP_LISTS:
                for r1 in R1_CMP_R1:
                    compare(llr, frozen, L, r1, preset=name, snr_db=snr)
    # an all-info code is one R1 node at the root, whose input is the channel
    rng = np.random.default_rng(2025)
    llr, _, _ = llr_frames("SCL_1024_L8", CMP_BATCH, 1.0, DEVICE)
    for N in R1_MASK_NS:
        for label, mask in (("all-info", np.zeros(N, bool)),
                            ("random", rng.random(N) < 0.5)):
            mask = torch.as_tensor(mask, device=DEVICE)
            for L in R1_CMP_LISTS:
                for r1 in R1_CMP_R1:
                    compare(llr[:, :N].contiguous(), mask, L, r1,
                            preset=f"{label} mask", snr_db=1.0)
    tie_llr = torch.tensor([1.0, -1.0] * 16, device=DEVICE).repeat(64, 1)
    tie_mask = torch.as_tensor(frozen_mask(32, 20), device=DEVICE)
    want = compare(tie_llr, tie_mask, 4, 2, preset="forced ties N=32")
    check(int(want[2].sum()) > 0, "the forced-tie input tied nowhere")

    counters = {}
    for name, batch in R1_STEP_CASES:
        p = preset(name)
        key = fold_in(prng_key(p.sweep.seed, DEVICE),
                      int(round(SCL_STEP_SNR * 100)))
        sigma = sigma_from_ebn0_db(SCL_STEP_SNR)
        got = {}
        for engine in ("auto", "plain"):
            step = make_frame_step(p, batch, DEVICE, engine=engine)
            got[engine] = [int(c) for c in step(key, 0, sigma)]
        counters[name] = dict(got, batch=batch)
        check(got["auto"] == got["plain"],
              f"{name}: frame step counters differ between kernel and plain: "
              f"{got}")
    emit({"scl_r1_step_counters": dict(counters, snr_db=SCL_STEP_SNR)})
    return worst_all


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call of fn on the card, by CUDA events, and
    the output of the last warmup call."""
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, out


def phase_timing(card, name, batch, kernel, plain, reps, compare, also=None,
                 **info):
    """Times at one main path's shape: kernel(llr, frozen) and its plain
    version in turn (plain, kernel, kernel, plain; each function of `also`,
    {key: fn(llr, frozen)}, after the first kernel turn and before the
    second), the kernel's output held against the plain version's there by
    compare(got, want, u, name), then the whole frame step (with its peak
    memory) and its encode and channel stages apart; returns (kernel ms,
    plain ms, compare's largest |kernel - plain|)."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (awgn_llr, fold_in,
                                                     frame_keys, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu
    from polardecoding_tpu_torch.parallel.harness import (code_tables,
                                                          make_frame_step,
                                                          payload_from_index)

    llr, frozen, u = llr_frames(name, batch, MAIN_SNR, DEVICE)
    plain_ms, kernel_ms, outs = [], [], {}
    also = also or {}
    also_ms = {k: [] for k in also}
    turns = ([(plain, plain_ms, 1), (kernel, kernel_ms, reps)]
             + [(fn, also_ms[k], reps) for k, fn in also.items()]
             + [(fn, also_ms[k], reps) for k, fn in reversed(also.items())]
             + [(kernel, kernel_ms, reps), (plain, plain_ms, 1)])
    for fn, acc, r in turns:
        ms, out = cuda_ms(functools.partial(fn, llr, frozen), r)
        acc.append(ms)
        if fn in (kernel, plain):
            outs.setdefault(fn, out)
        del out
    worst = compare(outs[kernel], outs[plain], u, name)
    p = preset(name)
    step = make_frame_step(p, batch, DEVICE)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    n = iter(range(1, 1 << 30))
    torch.cuda.reset_peak_memory_stats()
    step_ms, _ = cuda_ms(lambda: step(key, next(n) * batch, sigma), STEP_REPS)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    # the step's stages apart: payload + encode, then keys + channel
    tables = code_tables(p.code, DEVICE)
    fidx = torch.arange(batch, device=DEVICE)

    def encode():
        return encode_info_mxu(payload_from_index(fidx, tables.pn, p.code.K),
                               tables.g_rows)

    encode_ms, x = cuda_ms(encode, STEP_REPS)
    channel_ms, _ = cuda_ms(lambda: awgn_llr(x, frame_keys(key, fidx), sigma),
                            STEP_REPS)
    k, pl = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    emit({"timing": dict(
        {"card": card, "preset": name, "batch": batch}, **info, **also_ms,
        kernel_ms=kernel_ms, plain_ms=plain_ms,
        kernel_fps=batch / k * 1e3, plain_fps=batch / pl * 1e3,
        step_ms=step_ms, step_fps=batch / step_ms * 1e3,
        encode_ms=encode_ms, channel_ms=channel_ms,
        rest_ms=step_ms - encode_ms - channel_ms - k,
        step_peak_mib=peak_mib)})
    return k, pl, worst


def bp_timing_compare(got, want, u, name):
    """BP's u_hat from the kernel against the plain version's on every frame
    of the main path's decode; returns the largest |difference|."""
    check(got.dtype == torch.int8 and got.shape == want.shape,
          f"kernel output {got.dtype} {tuple(got.shape)}")
    equal = (got == want).all(dim=1)
    rec = {"compare": {"preset": name, "snr_db": MAIN_SNR,
                       "flavor": "minsum_lut", "early_stop_every": 0,
                       "frames": got.shape[0], "frames_equal": int(equal.sum()),
                       "plain_correct": int((want == u).all(dim=1).sum())}}
    emit(rec)
    check(bool(equal.all()), f"kernel != plain at the main path's shape: {rec}")
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def scl_timing_compare(got, want, u, name):
    """SCL's u_all, PM and ties from the kernel against the plain version's on
    every frame of the main path's decode; returns the largest
    |difference|."""
    worst, equal = _scl_diff(got, want)
    best = torch.argmin(want[1], dim=-1)
    u_hat = torch.take_along_dim(want[0], best[:, None, None], dim=1)[:, 0]
    frames = u.shape[0]
    rec = {"scl_compare": {"preset": name, "snr_db": MAIN_SNR,
                           "L": want[1].shape[1], "frames": frames,
                           "frames_equal": equal,
                           "plain_correct": int((u_hat == u).all(dim=1).sum()),
                           "max_abs_err": worst}}
    emit(rec)
    check(worst == 0 and equal == frames,
          f"kernel != plain at the main path's shape: {rec}")
    return worst


def phase_profile(card, label, batch, run):
    """torch.profiler trace of PROFILE_STEPS steps of one path after one
    warmup step; run(s) runs step s and reads its counters on the host, as
    the path's entry point does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(1, PROFILE_STEPS + 1):
            run(s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    check(dev, "the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")  # union of the device intervals, in us
    by_name = {}
    for e in dev:
        lo, hi = e.time_range.start, e.time_range.end
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (hi - lo))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    emit({"profile": {
        "card": card, "path": label, "batch": batch,
        "steps": PROFILE_STEPS, "wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
        "device_ops_per_step": len(dev) / PROFILE_STEPS,
        "top": [{"name": name[:80], "per_step": n / PROFILE_STEPS,
                 "ms_per_step": t / 1e3 / PROFILE_STEPS}
                for name, (n, t) in top]}})


def frame_step_runner(name, batch, **kw):
    """run(s): frame step s of a preset's make_frame_step at MAIN_SNR, its
    counters read on the host."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_frame_step

    p = preset(name)
    step = make_frame_step(p, batch, DEVICE, **kw)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    return lambda s: [int(c) for c in step(key, s * batch, sigma)]


def wave_runner(name, make, **kw):
    """run(s): the next step of a wave stepper (make is make_wave_step or
    make_wave_step_mc) at MAIN_SNR with batch WAVE_BATCH, its counters read
    on the host; run.carry holds the carry."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)

    p = preset(name)
    init, step, _ = make(p, WAVE_BATCH, device=DEVICE, **kw)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = float(sigma_from_ebn0_db(MAIN_SNR))

    def run(_=None, read=True):
        run.carry, out = step(key, sigma, run.carry)
        return [int(c) for c in out] if read else out

    run.carry = init(key, 0, sigma)
    run.key, run.sigma, run.preset = key, sigma, p
    return run


def _same(g, w):
    """Elementwise equality of bit patterns (-0.0 is not +0.0)."""
    if g.dtype == torch.float32:
        return g.view(torch.int32) == w.view(torch.int32)
    return g == w


def frames_equal(pairs, B):
    """(frames whose every tensor is bit-equal, largest |kernel - plain|)
    over pairs (kernel output, plain output, the frame axis)."""
    ok = torch.ones(B, dtype=torch.bool, device=DEVICE)
    worst = 0.0
    for g, w, axis in pairs:
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"kernel output {g.dtype} {tuple(g.shape)}, plain {w.dtype} "
              f"{tuple(w.shape)}")
        ok &= _same(g, w).movedim(axis, 0).reshape(B, -1).all(dim=1)
        worst = max(worst, float((g.double() - w.double()).abs().max()))
    return int(ok.sum()), worst


def phase_wave_compare():
    """The four wave kernels against their plain versions on the card;
    returns {kernel: largest |kernel - plain|} (0 when bit-equal)."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.bp import (bp_wave, bp_wave_fused,
                                                   bp_wave_mc, mc_delta,
                                                   mc_meta_init, mc_tables,
                                                   wave_decide, wave_init_state,
                                                   wave_merge)
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.channel_kernel import mc_channel
    from polardecoding_tpu_torch.ops.noise import counter_bits
    from polardecoding_tpu_torch.parallel.harness import (_mc_mode_tables,
                                                          code_tables,
                                                          make_wave_step)

    worst = dict.fromkeys(("bp_wave_fused", "bp_wave", "bp_wave_mc",
                           "mc_channel"), 0.0)
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    B = WAVE_CMP_BATCH

    def record(kernel, rec, equal, err, frames):
        rec = dict(rec, kernel=kernel, frames=frames, frames_equal=equal,
                   max_abs_err=err)
        emit({"wave_compare": rec})
        check(equal == frames and err == 0, f"kernel != plain: {rec}")
        worst[kernel] = max(worst[kernel], err)

    for name in CMP_PRESETS:
        p = preset(name)
        N, K = p.code.N, p.code.K
        tables = code_tables(p.code, DEVICE)
        for kernel, ce in (("bp_wave_fused", 0), ("bp_wave_fused", 4),
                           ("bp_wave", 0)):
            state = wave_init_state(torch.zeros(B, N, device=DEVICE),
                                    tables.frozen)
            retire = torch.ones(B, dtype=torch.bool, device=DEVICE)
            for w in range(WAVE_CMP_WAVES):
                llr, _, _ = llr_frames(name, B, MAIN_SNR, DEVICE, seed=100 + w)
                if kernel == "bp_wave":
                    got = bp_wave(state.clone(), WAVE_ITERS)
                    state = bp_wave(state, WAVE_ITERS, engine="plain")
                    pairs = [(got, state, 1)]
                    retire = wave_decide(state, tables.frozen)[1]
                    state = wave_merge(state, llr, retire)
                else:
                    got = bp_wave_fused(state.clone(), llr, retire, WAVE_ITERS,
                                        check_every=ce)
                    want = bp_wave_fused(state, llr, retire, WAVE_ITERS,
                                         check_every=ce, engine="plain")
                    pairs = [(got[0], want[0], 1), (got[1], want[1], 0),
                             (got[2], want[2], 0)]
                    state, retire = want[0], want[2]
                torch.cuda.synchronize()
                record(kernel, {"preset": name, "check_every": ce, "wave": w,
                                "retired": int(retire.sum())},
                       *frames_equal(pairs, B), B)

        utab, xtab = mc_tables(tables.info_set.cpu().numpy(), K, N, DEVICE)
        kw = dict(iters=MC_ITERS, flavor="minsum_lut_fast", delta=mc_delta(B, K),
                  spares=MC_SPARES)
        for noise in ("kernel", "words"):
            for cadence in (1, 2):
                state = wave_init_state(torch.zeros(B, N, device=DEVICE),
                                        tables.frozen)
                meta = mc_meta_init(B, N, K, DEVICE)
                for w in range(MC_CMP_WAVES):
                    seeds = (0x13198A2E, 0x03707344, 0x13198A2E ^ 0x03707344, w)
                    bits = None if noise == "kernel" else torch.stack(
                        [counter_bits(7, 8, w * MC_SPARES + g, B, N, DEVICE)
                         for g in range(MC_SPARES)])
                    drain = w == MC_CMP_WAVES - 1
                    got = bp_wave_mc(state.clone(), meta.clone(), utab, xtab,
                                     sigma, seeds, bits, gen_bits=bits is None,
                                     drain=drain, cadence=cadence, **kw)
                    state, meta, stats = bp_wave_mc(
                        state, meta, utab, xtab, sigma, seeds, bits,
                        gen_bits=bits is None, drain=drain, cadence=cadence,
                        engine="plain", **kw)
                    torch.cuda.synchronize()
                    pairs = [(got[0], state, 1), (got[1], meta, 1),
                             (got[2], stats, 0)]
                    record("bp_wave_mc", {"preset": name, "noise": noise,
                                          "cadence": cadence, "wave": w,
                                          "drain": drain,
                                          "stats": stats.sum(dim=0).tolist()},
                           *frames_equal(pairs, B), B)

    p = preset(MAIN_PRESET)
    _, xtab = _mc_mode_tables(p.code, DEVICE)
    B = MC_CHANNEL_BATCH
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    k0, k1 = key.tolist()
    m = (torch.arange(B, device=DEVICE) * (p.code.K % 63)) % 63
    for noise in ("kernel", "words"):
        bits = (None if noise == "kernel"
                else counter_bits(k1, k0, 0, B, p.code.N, DEVICE))
        args = (m, xtab, sigma, (k0, k1, k0 ^ k1, B), bits)
        got = mc_channel(*args, gen_bits=bits is None)
        want = mc_channel(*args, gen_bits=bits is None, engine="plain")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(want).all()), "non-finite MC channel LLRs")
        record("mc_channel", {"preset": MAIN_PRESET, "noise": noise},
               *frames_equal([(got, want, 0)], B), B)

    p = preset(WAVE_PRESET)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    counters = {}
    for fused in (True, False):
        for engine in ("auto", "plain"):
            init, step, _ = make_wave_step(p, WAVE_BATCH, WAVE_ITERS, DEVICE,
                                           fused=fused, engine=engine)
            carry = init(key, 0, sigma)
            rows = []
            for _ in range(WAVE_STEP_CMP_STEPS):
                carry, out = step(key, sigma, carry)
                rows.append([int(c) for c in out])
            counters[f"{'fused' if fused else 'unfused'}_{engine}"] = rows
            del carry
    emit({"wave_step_counters": dict(counters, preset=WAVE_PRESET,
                                     batch=WAVE_BATCH)})
    check(len({json.dumps(r) for r in counters.values()}) == 1,
          f"wave step counters differ: {counters}")
    return worst


def phase_wave_main(label, run, kernel):
    """Drive one wave path with every launch count at 0 just before: run()
    returns its PointResult, whose BLER must lie in BLER_RANGE; returns the
    count of the path's kernel's launches read just after."""
    reset_counts()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    counts = {kernel: launches(kernel)}
    from polardecoding_tpu_torch.configs import preset

    emit({"main_path": {"path": label, "batch": WAVE_BATCH,
                        "point": res.to_json(preset(res.preset).code.num_info),
                        "seconds": time.perf_counter() - t0,
                        "launches": counts}})
    check(res.errblock >= WAVE_ERROR_BLOCKS, f"{label} stopped early: {res}")
    check(BLER_RANGE[0] <= res.bler <= BLER_RANGE[1],
          f"{label}: BLER {res.bler} at {MAIN_SNR} dB outside {BLER_RANGE}")
    check(counts[kernel] > 0, f"{label}: launches {counts}")
    return counts[kernel]


def phase_mc_channel_main():
    """One make_frame_step step with channel="mc" at MC_CHANNEL_BATCH, the
    launch counts at 0 just before; returns the MC channel's launches."""
    reset_counts()
    counters = frame_step_runner(MAIN_PRESET, MC_CHANNEL_BATCH, channel="mc")(0)
    torch.cuda.synchronize()
    count = launches("mc_channel")
    emit({"main_path": {"path": f"{MAIN_PRESET} make_frame_step channel=mc",
                        "batch": MC_CHANNEL_BATCH, "steps": [counters],
                        "launches": {"mc_channel": count,
                                     "bp_decode": launches("bp_decode")}}})
    eb, ebl, ties = counters
    check(0 < ebl < MC_CHANNEL_BATCH and eb >= ebl and ties == 0,
          f"implausible MC-channel step counters {counters}")
    check(count == 1, f"mc_channel launched {count} times")
    return count


def hold_and_time(card, name, B, run, axes, **info):
    """run(engine, fresh) computes one kernel's function at its bench shape,
    with the kernel (engine="auto") or the plain version ("plain"), on
    copies of the inputs the kernel updates in place when fresh.  Holds the
    two bit-equal on every frame (axes: each output's frame axis), times
    them in turns (plain, kernel, kernel, plain; the plain version once per
    turn) and emits a wave_timing line; returns (kernel ms, plain ms,
    largest |kernel - plain|)."""
    got = run("auto", True)
    want = run("plain", False)
    torch.cuda.synchronize()
    equal, err = frames_equal(list(zip(got, want, axes)), B)
    del got, want
    check(equal == B and err == 0, f"{name} != plain at B={B}: {equal}")
    k, pl = [], []
    for engine, acc, reps in (("plain", pl, 1), ("auto", k, WAVE_KERNEL_REPS),
                              ("auto", k, WAVE_KERNEL_REPS), ("plain", pl, 1)):
        acc.append(cuda_ms(lambda: run(engine, False), reps)[0])
    emit({"wave_timing": dict(card=card, kernel=name, batch=B, kernel_ms=k,
                              plain_ms=pl, frames_equal=equal, **info)})
    return statistics.mean(k), statistics.mean(pl), err


def phase_wave_timing(card):
    """Each wave kernel and its plain version at the bench shape (one wave,
    B=16384, K=8 fused and unfused, K=32 MC; the MC channel at B=8192)
    through hold_and_time; the fused ES step split into kernel and channel;
    retired frames/s of the fused and MC wave paths over WAVE_CHUNK steps
    after a chunk of warmup.  Returns {kernel: (ms, plain ms, largest
    |kernel - plain|)}."""
    from polardecoding_tpu_torch.models.bp import (bp_wave, bp_wave_fused,
                                                   bp_wave_mc, mc_delta,
                                                   mc_tables)
    from polardecoding_tpu_torch.ops.channel import awgn_llr, frame_keys
    from polardecoding_tpu_torch.ops.channel_kernel import mc_channel
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu
    from polardecoding_tpu_torch.parallel.harness import (_mc_mode_tables,
                                                          code_tables,
                                                          make_wave_step,
                                                          make_wave_step_mc,
                                                          payload_from_index)

    out = {}
    B = WAVE_BATCH
    run = wave_runner(WAVE_PRESET, make_wave_step, wave_iters=WAVE_ITERS)
    for _ in range(2):
        run()
    p, key, sigma = run.preset, run.key, run.sigma
    tables = code_tables(p.code, DEVICE)
    state, fidx, _, _, retire = run.carry

    def channel():
        x = encode_info_mxu(payload_from_index(fidx, tables.pn, p.code.K),
                            tables.g_rows)
        return awgn_llr(x, frame_keys(key, fidx), sigma)

    def own(t, fresh):
        return t.clone() if fresh else t

    channel_ms, llr = cuda_ms(channel, STEP_REPS)
    out["bp_wave_fused"] = hold_and_time(
        card, "bp_wave_fused", B,
        lambda e, f: bp_wave_fused(own(state, f), llr, retire, WAVE_ITERS,
                                   engine=e),
        (1, 0, 0), preset=WAVE_PRESET, wave_iters=WAVE_ITERS)
    step_ms, _ = cuda_ms(lambda: run(read=False), STEP_REPS)
    kernel_ms = out["bp_wave_fused"][0]
    emit({"wave_step_split": {"card": card, "preset": WAVE_PRESET, "batch": B,
                              "step_ms": step_ms, "channel_ms": channel_ms,
                              "kernel_ms": kernel_ms,
                              "rest_ms": step_ms - channel_ms - kernel_ms,
                              "channel_share": channel_ms / step_ms,
                              "kernel_share": kernel_ms / step_ms}})
    out["bp_wave"] = hold_and_time(
        card, "bp_wave", B,
        lambda e, f: (bp_wave(own(state, f), WAVE_ITERS, engine=e),), (1,),
        preset=WAVE_PRESET, wave_iters=WAVE_ITERS)
    del state, llr, run

    fps = {}
    for label, r in (("fused", wave_runner(WAVE_PRESET, make_wave_step,
                                           wave_iters=WAVE_ITERS)),
                     ("mc", wave_runner(MC_PRESET, make_wave_step_mc,
                                        wave_iters=MC_ITERS, cadence=MC_CADENCE))):
        for _ in range(WAVE_CHUNK):  # a chunk of warmup past the first fill
            r(read=False)
        frames = []
        ms, _ = cuda_ms(lambda: frames.append(r(read=False)[2]), WAVE_CHUNK)
        retired = sum(int(f) for f in frames[1:])  # frames[0] is the warmup's
        fps[label] = {"steps": WAVE_CHUNK, "step_ms": ms, "retired": retired,
                      "retired_fps": retired / (ms * WAVE_CHUNK) * 1e3}
    emit({"wave_fps": dict(fps, card=card, batch=B)})

    state, meta, stepc, (k0, k1) = r.carry
    p = r.preset
    tabs = mc_tables(code_tables(p.code, DEVICE).info_set.cpu().numpy(),
                     p.code.K, p.code.N, DEVICE)
    kw = dict(iters=MC_ITERS, flavor=p.decoder.bp_flavor,
              delta=mc_delta(B, p.code.K), spares=MC_SPARES, cadence=MC_CADENCE)
    out["bp_wave_mc"] = hold_and_time(
        card, "bp_wave_mc", B,
        lambda e, f: bp_wave_mc(own(state, f), own(meta, f), *tabs, sigma,
                                (k0, k1, k0 ^ k1, stepc), engine=e, **kw),
        (1, 1, 0), preset=MC_PRESET, wave_iters=MC_ITERS, cadence=MC_CADENCE,
        spares=MC_SPARES)
    del state, meta, r

    _, xtab = _mc_mode_tables(p.code, DEVICE)
    Bc = MC_CHANNEL_BATCH
    m = (torch.arange(Bc, device=DEVICE) * (p.code.K % 63)) % 63
    k0, k1 = key.tolist()
    out["mc_channel"] = hold_and_time(
        card, "mc_channel", Bc,
        lambda e, f: (mc_channel(m, xtab, sigma, (k0, k1, k0 ^ k1, 0), engine=e),),
        (0,))
    return out


def bound(nbytes, ops, int_ops=0):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move nbytes through HBM and do ops operations, int_ops of them on
    integers: the larger of the three times at HBM_BYTES_PER_S, OPS_PER_S
    and INT_OPS_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / OPS_PER_S, int_ops / INT_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bp_work(B, N, iters):
    """Bytes and operations of one fixed-iteration BP decode: LLRs and
    frozen row in, decisions out; per butterfly and iteration 4 CHKs and
    4 adds (the R- and L-sweep equations of models/bp.bp_iteration)."""
    n = N.bit_length() - 1
    nbytes = B * N * 4 + N * 4 + B * N
    return nbytes, B * iters * n * (N // 2) * (4 * CHK_OPS + 4)


def wave_work(B, N, iters, fused):
    """Bytes and operations of one wave: the state [2(n+1), B, N] read and
    written once, and for the fused wave the LLRs and retire mask in and
    u_hat and done out; the iterations' CHKs and adds as bp_work counts
    them (the decide's xors and compares are left out)."""
    n = N.bit_length() - 1
    nbytes = 2 * 2 * (n + 1) * B * N * 4
    if fused:
        nbytes += B * N * 4 + B + B * N + B
    return nbytes, B * iters * n * (N // 2) * (4 * CHK_OPS + 4)


def noise_work(elements):
    """(operations, integer operations) of a threefry word and an LLR for
    each of `elements`."""
    int_ops = elements * (THREEFRY_INT_OPS + LLR_INT_OPS)
    return int_ops + elements * LLR_OPS, int_ops


def mc_wave_work(B, N, iters, refills):
    """Bytes, operations and integer operations of one MC wave: state and
    meta [4, B, N] read and written once, the two tables read, stats
    written; the iterations' CHKs and adds, and a row of noise and LLR for
    each of this wave's `refills` (head merges and in-wave retirements)."""
    n = N.bit_length() - 1
    nbytes = 2 * (2 * (n + 1) + 4) * B * N * 4 + 2 * 128 * N * 4 + B * 3 * 4
    ops, int_ops = noise_work(refills * N)
    return nbytes, B * iters * n * (N // 2) * (4 * CHK_OPS + 4) + ops, int_ops


def mc_channel_work(B, N):
    """Bytes, operations and integer operations of the MC channel: the
    offsets and the table in, the LLRs out; per element a threefry word and
    an LLR."""
    return (B * 4 + 128 * N * 4 + B * N * 4, *noise_work(B * N))


def scl_work(B, N, L, frozen, r1=0):
    """Bytes and operations that SCL decoding on this frozen mask needs: LLRs
    and mask in, u_all, PM and ties out.  Per path and bit j, with t =
    ntz(j) (n at j = 0) and t1 = ntz(j + 1): the g-node at stage t (a
    product and an add per element), a CHK per f-node element below it,
    PHI (one penalty at a frozen bit, both at an info bit), and the 2^t1 - 1
    partial-sum xors of the bit phase.  Per info bit, the L smallest of 2L
    candidates in a stable order take about 2L log2(2L) compares.  With
    r1 > 0, an R1 node of stage s (width w) replaces its leaves' f/g chains
    below s, PHI and forks, per path, by |alpha| and its sign (2w), t =
    min(L-1, w) argmin passes of a compare and a select per element (2tw),
    t flips and the transform's s·w/2 xors; and by t forks of 2L adds and
    the selection's compares."""
    from polardecoding_tpu_torch.models.scl_fast import r1_stages

    n = N.bit_length() - 1
    stages = r1_stages(frozen, r1, WLOOP)
    per_path, select = 0, 0
    j = 0
    while j < N:
        t = n if j == 0 else (j & -j).bit_length() - 1
        s = stages[j]
        w = 1 << s
        last = j + (w if s else 1) - 1
        t1 = min(((last + 1) & -(last + 1)).bit_length() - 1, n)
        if t < n:
            per_path += 2 * (1 << t)
        per_path += ((1 << t) - (1 << s)) * CHK_OPS
        if t1 < n:
            per_path += (1 << t1) - 1
        if s:
            forks = min(L - 1, w)
            per_path += 2 * w + 2 * forks * w + forks + s * w // 2
            select += forks * (2 * L + 2 * L * ((2 * L).bit_length() - 1))
            j += w
            continue
        per_path += PHI_BASE_OPS + PHI_PEN_OPS * (1 if frozen[j] else 2)
        if not frozen[j]:
            select += 2 * L * ((2 * L).bit_length() - 1)
        j += 1
    nbytes = B * N * 4 + N + B * L * N + B * L * 4 + B * 4
    return nbytes, B * (L * per_path + select)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.bp import bp_decode
    from polardecoding_tpu_torch.models.scl import scl_decode
    from polardecoding_tpu_torch.ops import _build
    from polardecoding_tpu_torch.ops.bp_kernel import bp_decode_cuda
    from polardecoding_tpu_torch.ops.scl_kernel import scl_decode_cuda
    from polardecoding_tpu_torch.parallel.harness import (
        code_tables, make_wave_step, make_wave_step_mc, run_point,
        run_point_waves)

    card = card_line()
    print(card, flush=True)
    phase_build(_build)
    bp_worst = phase_compare()
    scl_worst = phase_scl_compare()
    r1_worst = phase_scl_r1_compare()
    counts = {
        "bp_decode": phase_main(MAIN_PRESET, MAIN_BATCH, MAIN_ERROR_BLOCKS,
                                BLER_RANGE, "bp_decode"),
        "scl_decode": phase_main(SCL_PRESET, SCL_BATCH, SCL_ERROR_BLOCKS,
                                 SCL_BLER_RANGE, "scl_decode")}
    r1_counts = {name: phase_main(name, SCL_BATCH, blocks, bler, "scl_decode_r1")
                 for name, blocks, bler in R1_MAIN_PATHS}
    counts["scl_decode_r1"] = r1_counts[R1_PRESET]
    wave_worst = phase_wave_compare()
    counts["bp_wave_fused"] = phase_wave_main(
        f"{WAVE_PRESET} run_point (fused wave engine, K={WAVE_ITERS})",
        lambda: run_point(preset(WAVE_PRESET), MAIN_SNR, batch=WAVE_BATCH,
                          device=DEVICE, error_blocks=WAVE_ERROR_BLOCKS),
        "bp_wave_fused")
    counts["bp_wave_mc"] = phase_wave_main(
        f"{MC_PRESET} run_point_waves engine=mc K={MC_ITERS} cadence={MC_CADENCE}",
        lambda: run_point_waves(preset(MC_PRESET), MAIN_SNR, batch=WAVE_BATCH,
                                wave_iters=MC_ITERS, device=DEVICE,
                                error_blocks=WAVE_ERROR_BLOCKS, engine="mc",
                                cadence=MC_CADENCE), "bp_wave_mc")
    counts["bp_wave"] = phase_wave_main(
        f"{WAVE_PRESET} run_point_waves fused=False K={WAVE_ITERS}",
        lambda: run_point_waves(preset(WAVE_PRESET), MAIN_SNR, batch=WAVE_BATCH,
                                device=DEVICE, error_blocks=WAVE_ERROR_BLOCKS,
                                fused=False), "bp_wave")
    counts["mc_channel"] = phase_mc_channel_main()
    times = {}
    bp_ms, bp_plain_ms, worst = phase_timing(
        card, MAIN_PRESET, MAIN_BATCH,
        lambda llr, fr: bp_decode_cuda(llr, fr, iters=100),
        lambda llr, fr: bp_decode(llr, fr, iters=100),
        KERNEL_REPS, bp_timing_compare, iters=100)
    times["bp_decode"] = (bp_ms, bp_plain_ms, max(bp_worst, worst))
    L = preset(SCL_PRESET).decoder.list_size
    scl_ms, scl_plain_ms, worst = phase_timing(
        card, SCL_PRESET, SCL_BATCH,
        lambda llr, fr: scl_decode_cuda(llr, fr, L),
        lambda llr, fr: scl_decode(llr, fr, list_size=L, return_all=True,
                                   return_ties=True),
        SCL_KERNEL_REPS, scl_timing_compare, L=L)
    times["scl_decode"] = (scl_ms, scl_plain_ms, max(scl_worst, worst))
    L = preset(R1_PRESET).decoder.list_size
    r1 = preset(R1_PRESET).decoder.scl_r1
    r1_ms, r1_plain_ms, worst = phase_timing(
        card, R1_PRESET, SCL_BATCH,
        lambda llr, fr: scl_decode_cuda(llr, fr, L, r1=r1, wloop=WLOOP),
        lambda llr, fr: scl_decode(llr, fr, list_size=L, return_all=True,
                                   return_ties=True, r1=r1, wloop=WLOOP),
        SCL_KERNEL_REPS, scl_timing_compare,
        also={"exact_kernel_ms": lambda llr, fr: scl_decode_cuda(llr, fr, L)},
        L=L, r1=r1, wloop=WLOOP)
    times["scl_decode_r1"] = (r1_ms, r1_plain_ms, max(r1_worst, worst))
    for name, (ms, plain_ms, worst) in phase_wave_timing(card).items():
        times[name] = (ms, plain_ms, max(wave_worst[name], worst))
    phase_profile(card, MAIN_PRESET, MAIN_BATCH,
                  frame_step_runner(MAIN_PRESET, MAIN_BATCH))
    phase_profile(card, SCL_PRESET, SCL_BATCH,
                  frame_step_runner(SCL_PRESET, SCL_BATCH))
    phase_profile(card, R1_PRESET, SCL_BATCH,
                  frame_step_runner(R1_PRESET, SCL_BATCH))
    phase_profile(card, f"{WAVE_PRESET} fused wave step", WAVE_BATCH,
                  wave_runner(WAVE_PRESET, make_wave_step, wave_iters=WAVE_ITERS))
    mc = wave_runner(MC_PRESET, make_wave_step_mc, wave_iters=MC_ITERS,
                     cadence=MC_CADENCE)
    phase_profile(card, f"{MC_PRESET} MC wave step", WAVE_BATCH, mc)
    check("jax" not in sys.modules, "the port imported jax")

    p = preset(SCL_PRESET)
    frozen = code_tables(p.code, "cpu").frozen.tolist()
    N = p.code.N
    # this run's refills of an MC wave: its retirements at the steady state
    # of the profiled waves (at most one head merge or in-wave retirement
    # per retired frame)
    refills = int(mc(read=False)[2])
    bounds = {
        "bp_decode": bp_work(MAIN_BATCH, N, 100),
        "scl_decode": scl_work(SCL_BATCH, N, p.decoder.list_size, frozen),
        "scl_decode_r1": scl_work(SCL_BATCH, N, L, frozen, r1=r1),
        "bp_wave_fused": wave_work(WAVE_BATCH, N, WAVE_ITERS, True),
        "bp_wave": wave_work(WAVE_BATCH, N, WAVE_ITERS, False),
        "bp_wave_mc": mc_wave_work(WAVE_BATCH, N, MC_ITERS, refills),
        "mc_channel": mc_channel_work(MC_CHANNEL_BATCH, N)}
    lines = []
    for name, (mod, _, key) in kernels().items():
        ms, plain_ms, worst = times[name]
        b_ms, b_by = bound(*bounds[name])
        lines.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES if key is None else mod.REPLACES[key],
            "launches": counts[name], "max_abs_err": worst,
            "matches_plain": worst == 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
