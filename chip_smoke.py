#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (polardecoding_tpu_torch) on one GPU.

  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA source of the port (polardecoding_tpu_torch/csrc) and
   prints the build time and the compiler's register/shared-memory report;
3. holds the BP decode kernel against its plain PyTorch version on the card:
   u_hat bit-equal on every frame for N in {128, 1024}, B=512, LLRs from the
   port's channel at 1.0 and 2.0 dB, both min-sum flavors, early stop off
   and every 4 iterations; SPA equal on every frame the plain version
   decodes correctly (exp/log1p rounding may steer a non-converged frame);
   the whole frame step's counters equal with the kernel and with the plain
   decoder at the main path's batch, 8192; the channel on the card within
   1e-5 of the channel on the CPU;
4. drives the BP_1024 main path with the launch counts at 0: four
   make_frame_step steps at batch 8192, then run_point at 2.0 dB to 200
   error blocks, whose BLER must lie in [0.020, 0.043] (BASELINE.md: 0.02948
   and 0.03292 for two seeds); the kernel must have been launched;
5. times kernel and plain version (plain, kernel, kernel, plain) at the main
   path's shape, BP_1024 with B=8192 and 100 iterations, and holds the
   kernel's u_hat there bit-equal to the plain version's on every frame;
   times the whole frame step (with its peak device memory), and its encode
   and channel stages apart, with CUDA events after warmup;
6. traces a few frame steps with torch.profiler: wall and device time per
   step, the device's idle share, the device operations per step and the
   kernels that take the most time;
7. prints the kernels line, then {"ok": true, "device": {...}} last.

Any failed phase raises and exits non-zero; without a CUDA device, or
without the package beside this file, it exits non-zero before printing a
result.  The port imports no JAX.
"""
from __future__ import annotations

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
        step = make_frame_step(p, MAIN_BATCH, DEVICE, bp_engine=engine)
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


def phase_main(bp_kernel):
    """The BP_1024 main path with the launch counts at 0; returns the
    count of kernel launches it made."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_frame_step, run_point

    p = preset(MAIN_PRESET)
    bp_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    step = make_frame_step(p, MAIN_BATCH, DEVICE)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    steps = [[int(c) for c in step(key, s * MAIN_BATCH, sigma)]
             for s in range(MAIN_STEPS)]
    res = run_point(p, MAIN_SNR, batch=MAIN_BATCH, device=DEVICE,
                    error_blocks=MAIN_ERROR_BLOCKS)
    torch.cuda.synchronize()
    launches = bp_kernel.LAUNCHES
    emit({"main_path": {"preset": p.name, "batch": MAIN_BATCH,
                        "steps": steps, "point": res.to_json(p.code.num_info),
                        "seconds": time.perf_counter() - t0,
                        "launches": launches}})
    for eb, ebl, ties in steps:
        check(0 <= ebl <= MAIN_BATCH and eb >= ebl and ties == 0,
              f"implausible step counters {steps}")
    check(res.errblock >= MAIN_ERROR_BLOCKS and res.frames % MAIN_BATCH == 0,
          f"run_point stopped early: {res}")
    k = res.frames // MAIN_BATCH
    if k <= MAIN_STEPS:  # frames are pure in (seed, frame index)
        check([res.errbit, res.errblock]
              == [sum(s[0] for s in steps[:k]), sum(s[1] for s in steps[:k])],
              "run_point's counters differ from the same frames' steps")
    check(BLER_RANGE[0] <= res.bler <= BLER_RANGE[1],
          f"BLER {res.bler} at {MAIN_SNR} dB outside {BLER_RANGE}")
    check(launches == MAIN_STEPS + k, f"kernel launched {launches} times")
    return launches


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


def phase_timing(card):
    """Times at the main path's shape, and the kernel held against the plain
    version there; returns (kernel ms, plain ms, largest |u_kernel -
    u_plain|)."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.bp import bp_decode
    from polardecoding_tpu_torch.ops.bp_kernel import bp_decode_cuda
    from polardecoding_tpu_torch.ops.channel import (awgn_llr, fold_in,
                                                     frame_keys, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu
    from polardecoding_tpu_torch.parallel.harness import (code_tables,
                                                          make_frame_step,
                                                          payload_from_index)

    llr, frozen, u = llr_frames(MAIN_PRESET, MAIN_BATCH, MAIN_SNR, DEVICE)

    def kernel():
        return bp_decode_cuda(llr, frozen, iters=100)

    def plain():
        return bp_decode(llr, frozen, iters=100)

    plain_ms, kernel_ms, outs = [], [], {}
    for fn, acc, reps in ((plain, plain_ms, 1), (kernel, kernel_ms, KERNEL_REPS),
                          (kernel, kernel_ms, KERNEL_REPS), (plain, plain_ms, 1)):
        ms, out = cuda_ms(fn, reps)
        acc.append(ms)
        outs.setdefault(fn, out)
    got, want = outs[kernel], outs[plain]
    check(got.dtype == torch.int8 and got.shape == want.shape,
          f"kernel output {got.dtype} {tuple(got.shape)}")
    equal = (got == want).all(dim=1)
    rec = {"compare": {"preset": MAIN_PRESET, "snr_db": MAIN_SNR,
                       "flavor": "minsum_lut", "early_stop_every": 0,
                       "frames": MAIN_BATCH, "frames_equal": int(equal.sum()),
                       "plain_correct": int((want == u).all(dim=1).sum())}}
    emit(rec)
    check(bool(equal.all()), f"kernel != plain at the main path's shape: {rec}")
    worst = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    p = preset(MAIN_PRESET)
    step = make_frame_step(p, MAIN_BATCH, DEVICE)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    n = iter(range(1, 1 << 30))
    torch.cuda.reset_peak_memory_stats()
    step_ms, _ = cuda_ms(lambda: step(key, next(n) * MAIN_BATCH, sigma),
                         STEP_REPS)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    # the step's stages apart: payload + encode, then keys + channel
    tables = code_tables(p.code, DEVICE)
    fidx = torch.arange(MAIN_BATCH, device=DEVICE)

    def encode():
        return encode_info_mxu(payload_from_index(fidx, tables.pn, p.code.K),
                               tables.g_rows)

    encode_ms, x = cuda_ms(encode, STEP_REPS)
    channel_ms, _ = cuda_ms(lambda: awgn_llr(x, frame_keys(key, fidx), sigma),
                            STEP_REPS)
    k, pl = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    emit({"timing": {"card": card, "preset": MAIN_PRESET, "batch": MAIN_BATCH,
                     "iters": 100, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "kernel_fps": MAIN_BATCH / k * 1e3,
                     "plain_fps": MAIN_BATCH / pl * 1e3,
                     "step_ms": step_ms,
                     "step_fps": MAIN_BATCH / step_ms * 1e3,
                     "encode_ms": encode_ms, "channel_ms": channel_ms,
                     "step_peak_mib": peak_mib}})
    return k, pl, worst


def phase_profile(card):
    """torch.profiler trace of PROFILE_STEPS main-path frame steps after
    warmup, each step's counters read on the host as run_point reads them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_frame_step

    p = preset(MAIN_PRESET)
    step = make_frame_step(p, MAIN_BATCH, DEVICE)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    [int(c) for c in step(key, 0, sigma)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(1, PROFILE_STEPS + 1):
            [int(c) for c in step(key, s * MAIN_BATCH, sigma)]
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
        "card": card, "preset": MAIN_PRESET, "batch": MAIN_BATCH,
        "steps": PROFILE_STEPS, "wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
        "device_ops_per_step": len(dev) / PROFILE_STEPS,
        "top": [{"name": name[:80], "per_step": n / PROFILE_STEPS,
                 "ms_per_step": t / 1e3 / PROFILE_STEPS}
                for name, (n, t) in top]}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from polardecoding_tpu_torch.ops import _build, bp_kernel

    card = card_line()
    print(card, flush=True)
    phase_build(_build)
    worst = phase_compare()
    launches = phase_main(bp_kernel)
    ms, plain_ms, worst_main = phase_timing(card)
    worst = max(worst, worst_main)
    phase_profile(card)
    check("jax" not in sys.modules, "the port imported jax")
    emit({"kernels": [{"name": "bp_decode", "route": "cuda",
                       "source": bp_kernel.SOURCE, "replaces": bp_kernel.REPLACES,
                       "launches": launches, "max_abs_err": worst,
                       "matches_plain": worst == 0,
                       "ms": ms, "plain_ms": plain_ms}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
