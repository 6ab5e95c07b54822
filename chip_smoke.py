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
   masks and L in {1, 2, 8, 32}; a random frozen mask at N=1024 with L=4 and
   L=32 (the traced-mask kernels' contract); a forced-tie input whose tie
   counter must be non-zero; and the frame-step counters at 1.5 dB equal
   with kernel and plain decoder for SCL_1024_L8 (batch 16384),
   CASCL_1024_L8 and SC_1024 (4096) and CASCL_1024_L32 (1024);
5. drives the BP_1024 main path with the launch counts at 0: four
   make_frame_step steps at batch 8192, then run_point at 2.0 dB to 200
   error blocks, whose BLER must lie in [0.020, 0.043] (BASELINE.md: 0.02948
   and 0.03292 for two seeds); the BP kernel must have been launched;
6. drives the SCL_1024_L8 main path the same way: four steps at batch
   16384, then run_point at 2.0 dB to 100 error blocks, whose BLER must lie
   in [0.0055, 0.0125] (BASELINE.md: 9.128e-3, a 5-seed mean, and 7.85e-3
   from a third-party oracle); the SCL kernel must have been launched;
7. times each kernel and its plain version (plain, kernel, kernel, plain) at
   its main path's shape, BP_1024 with B=8192 and 100 iterations and
   SCL_1024_L8 with B=16384, and holds the kernel's output bit-equal to the
   plain version's there on every frame; times each whole frame step (with
   its peak device memory), and its encode and channel stages apart, with
   CUDA events after warmup;
8. traces three frame steps of each main path with torch.profiler: wall
   and device time per step, the device's idle share, the device operations
   per step and the kernels that take the most time;
9. prints the kernels line (each kernel's launches on its main path, its
   largest difference from the plain version, its time, the plain
   version's, and its bound: the larger of its bytes over the H100 SXM's
   3.35 TB/s and the operations its function needs over 33.5e12 per
   second, the card's rate for float32 adds, compares and selects), then
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
SCL_CMP_LISTS = (1, 2, 8, 32)
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


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
    port's own pipeline, with the code's frozen mask and the true u."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (awgn_llr, fold_in,
                                                     frame_keys, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu, scatter_info
    from polardecoding_tpu_torch.parallel.harness import (code_tables,
                                                          payload_from_index)

    code = preset(name).code
    tables = code_tables(code, device)
    fidx = torch.arange(batch, device=device)
    w = payload_from_index(fidx, tables.pn, code.K)
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


def phase_main(name, batch, error_blocks, bler_range, kernel, counters):
    """Drive one main path with every launch count at 0 just before: four
    make_frame_step steps, then run_point at MAIN_SNR; returns the count of
    launches of the path's kernel read just after."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_frame_step, run_point

    p = preset(name)
    list_decoder = p.decoder.kind in ("scl", "cascl")
    for mod in counters:
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    step = make_frame_step(p, batch, DEVICE)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    steps = [[int(c) for c in step(key, s * batch, sigma)]
             for s in range(MAIN_STEPS)]
    res = run_point(p, MAIN_SNR, batch=batch, device=DEVICE,
                    error_blocks=error_blocks)
    torch.cuda.synchronize()
    launches = kernel.LAUNCHES
    emit({"main_path": {"preset": p.name, "batch": batch,
                        "steps": steps, "point": res.to_json(p.code.num_info),
                        "seconds": time.perf_counter() - t0,
                        "launches": launches}})
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
    check(launches == MAIN_STEPS + k, f"kernel launched {launches} times")
    return launches


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


def phase_timing(card, name, batch, kernel, plain, reps, compare, **info):
    """Times at one main path's shape: kernel(llr, frozen) and its plain
    version in turn (plain, kernel, kernel, plain), the kernel's output held
    against the plain version's there by compare(got, want, u), then the
    whole frame step (with its peak memory) and its encode and channel
    stages apart; returns (kernel ms, plain ms, compare's largest |kernel -
    plain|)."""
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
    for fn, acc, r in ((plain, plain_ms, 1), (kernel, kernel_ms, reps),
                       (kernel, kernel_ms, reps), (plain, plain_ms, 1)):
        ms, out = cuda_ms(functools.partial(fn, llr, frozen), r)
        acc.append(ms)
        outs.setdefault(fn, out)
    worst = compare(outs[kernel], outs[plain], u)
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
        {"card": card, "preset": name, "batch": batch}, **info,
        kernel_ms=kernel_ms, plain_ms=plain_ms,
        kernel_fps=batch / k * 1e3, plain_fps=batch / pl * 1e3,
        step_ms=step_ms, step_fps=batch / step_ms * 1e3,
        encode_ms=encode_ms, channel_ms=channel_ms,
        rest_ms=step_ms - encode_ms - channel_ms - k,
        step_peak_mib=peak_mib)})
    return k, pl, worst


def bp_timing_compare(got, want, u):
    """BP's u_hat from the kernel against the plain version's on every frame
    of the main path's decode; returns the largest |difference|."""
    check(got.dtype == torch.int8 and got.shape == want.shape,
          f"kernel output {got.dtype} {tuple(got.shape)}")
    equal = (got == want).all(dim=1)
    rec = {"compare": {"preset": MAIN_PRESET, "snr_db": MAIN_SNR,
                       "flavor": "minsum_lut", "early_stop_every": 0,
                       "frames": got.shape[0], "frames_equal": int(equal.sum()),
                       "plain_correct": int((want == u).all(dim=1).sum())}}
    emit(rec)
    check(bool(equal.all()), f"kernel != plain at the main path's shape: {rec}")
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def scl_timing_compare(got, want, u):
    """SCL's u_all, PM and ties from the kernel against the plain version's on
    every frame of the main path's decode; returns the largest
    |difference|."""
    worst, equal = _scl_diff(got, want)
    best = torch.argmin(want[1], dim=-1)
    u_hat = torch.take_along_dim(want[0], best[:, None, None], dim=1)[:, 0]
    frames = u.shape[0]
    rec = {"scl_compare": {"preset": SCL_PRESET, "snr_db": MAIN_SNR,
                           "L": want[1].shape[1], "frames": frames,
                           "frames_equal": equal,
                           "plain_correct": int((u_hat == u).all(dim=1).sum()),
                           "max_abs_err": worst}}
    emit(rec)
    check(worst == 0 and equal == frames,
          f"kernel != plain at the main path's shape: {rec}")
    return worst


def phase_profile(card, name, batch):
    """torch.profiler trace of PROFILE_STEPS frame steps of one main path
    after warmup, each step's counters read on the host as run_point reads
    them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_frame_step

    p = preset(name)
    step = make_frame_step(p, batch, DEVICE)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    [int(c) for c in step(key, 0, sigma)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(1, PROFILE_STEPS + 1):
            [int(c) for c in step(key, s * batch, sigma)]
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
        "card": card, "preset": name, "batch": batch,
        "steps": PROFILE_STEPS, "wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
        "device_ops_per_step": len(dev) / PROFILE_STEPS,
        "top": [{"name": name[:80], "per_step": n / PROFILE_STEPS,
                 "ms_per_step": t / 1e3 / PROFILE_STEPS}
                for name, (n, t) in top]}})


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move nbytes through HBM and do ops adds, compares and selects."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bp_work(B, N, iters):
    """Bytes and operations of one fixed-iteration BP decode: LLRs and
    frozen row in, decisions out; per butterfly and iteration 4 CHKs and
    4 adds (the R- and L-sweep equations of models/bp.bp_iteration)."""
    n = N.bit_length() - 1
    nbytes = B * N * 4 + N * 4 + B * N
    return nbytes, B * iters * n * (N // 2) * (4 * CHK_OPS + 4)


def scl_work(B, N, L, frozen):
    """Bytes and operations that SCL decoding on this frozen mask needs: LLRs
    and mask in, u_all, PM and ties out.  Per path and bit j, with t =
    ntz(j) (n at j = 0) and t1 = ntz(j + 1): the g-node at stage t (a
    product and an add per element), a CHK per f-node element below it,
    PHI (one penalty at a frozen bit, both at an info bit), and the 2^t1 - 1
    partial-sum xors of the bit phase.  Per info bit, the L smallest of 2L
    candidates in a stable order take about 2L log2(2L) compares."""
    n = N.bit_length() - 1
    per_path, select = 0, 0
    for j, is_frozen in enumerate(frozen):
        t = n if j == 0 else (j & -j).bit_length() - 1
        t1 = min(((j + 1) & -(j + 1)).bit_length() - 1, n)
        if t < n:
            per_path += 2 * (1 << t)
        per_path += ((1 << t) - 1) * CHK_OPS
        per_path += PHI_BASE_OPS + PHI_PEN_OPS * (1 if is_frozen else 2)
        if t1 < n:
            per_path += (1 << t1) - 1
        if not is_frozen:
            select += 2 * L * ((2 * L).bit_length() - 1)
    nbytes = B * N * 4 + N + B * L * N + B * L * 4 + B * 4
    return nbytes, B * (L * per_path + select)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.bp import bp_decode
    from polardecoding_tpu_torch.models.scl import scl_decode
    from polardecoding_tpu_torch.ops import _build, bp_kernel, scl_kernel
    from polardecoding_tpu_torch.ops.bp_kernel import bp_decode_cuda
    from polardecoding_tpu_torch.ops.scl_kernel import scl_decode_cuda
    from polardecoding_tpu_torch.parallel.harness import code_tables

    counters = (bp_kernel, scl_kernel)
    card = card_line()
    print(card, flush=True)
    phase_build(_build)
    bp_worst = phase_compare()
    scl_worst = phase_scl_compare()
    bp_launches = phase_main(MAIN_PRESET, MAIN_BATCH, MAIN_ERROR_BLOCKS,
                             BLER_RANGE, bp_kernel, counters)
    scl_launches = phase_main(SCL_PRESET, SCL_BATCH, SCL_ERROR_BLOCKS,
                              SCL_BLER_RANGE, scl_kernel, counters)
    bp_ms, bp_plain_ms, worst = phase_timing(
        card, MAIN_PRESET, MAIN_BATCH,
        lambda llr, fr: bp_decode_cuda(llr, fr, iters=100),
        lambda llr, fr: bp_decode(llr, fr, iters=100),
        KERNEL_REPS, bp_timing_compare, iters=100)
    bp_worst = max(bp_worst, worst)
    L = preset(SCL_PRESET).decoder.list_size
    scl_ms, scl_plain_ms, worst = phase_timing(
        card, SCL_PRESET, SCL_BATCH,
        lambda llr, fr: scl_decode_cuda(llr, fr, L),
        lambda llr, fr: scl_decode(llr, fr, list_size=L, return_all=True,
                                   return_ties=True),
        SCL_KERNEL_REPS, scl_timing_compare, L=L)
    scl_worst = max(scl_worst, worst)
    phase_profile(card, MAIN_PRESET, MAIN_BATCH)
    phase_profile(card, SCL_PRESET, SCL_BATCH)
    check("jax" not in sys.modules, "the port imported jax")

    p = preset(SCL_PRESET)
    frozen = code_tables(p.code, "cpu").frozen.tolist()
    bp_bound = bound(*bp_work(MAIN_BATCH, preset(MAIN_PRESET).code.N, 100))
    scl_bound = bound(*scl_work(SCL_BATCH, p.code.N, p.decoder.list_size,
                                frozen))
    emit({"kernels": [
        {"name": "bp_decode", "route": "cuda", "source": bp_kernel.SOURCE,
         "replaces": bp_kernel.REPLACES, "launches": bp_launches,
         "max_abs_err": bp_worst, "matches_plain": bp_worst == 0,
         "ms": bp_ms, "plain_ms": bp_plain_ms, "bound_ms": bp_bound[0],
         "bound_by": bp_bound[1], "library_ms": None},
        {"name": "scl_decode", "route": "cuda", "source": scl_kernel.SOURCE,
         "replaces": scl_kernel.REPLACES, "launches": scl_launches,
         "max_abs_err": scl_worst, "matches_plain": scl_worst == 0,
         "ms": scl_ms, "plain_ms": scl_plain_ms, "bound_ms": scl_bound[0],
         "bound_by": scl_bound[1], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
