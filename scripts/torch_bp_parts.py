#!/usr/bin/env python3
"""What each part of the BP kernels' live-row sweep buys, on the card.

  python scripts/torch_bp_parts.py [--baseline CHECKOUT] [--reps 5]

Times the four kernels on the live-row sweep of csrc/bp_common.cuh at
their main paths' shapes:

  bp_decode      csrc/bp_decode.cu, BP_1024 at B=8192, 100 iterations of
                 minsum_lut, LLRs of the all-zero codeword at 2.0 dB from a
                 seed (the frame step's decode);
  bp_wave        csrc/bp_wave.cu unfused, one wave of BP_1024_ES at
                 B=16384, K=8, from the state of make_wave_step (fused)
                 after 8 steps (run_point_waves' fused=False path);
  bp_wave_fused  csrc/bp_wave.cu fused, the same wave with that step's
                 retire mask and the fresh LLRs of its slots' frames
                 (run_point's early-stop path);
  bp_wave_mc     csrc/bp_wave_mc.cu, one wave of BP_1024_FASTCHK at B=16384,
                 K=32, cadence 2, 4 spares, from the state and meta of
                 make_wave_step_mc after 8 waves (bench.py's wave leg).

Every timing of a wave starts from its state.

Each kernel six ways, in turns (the first order, then the reverse):

  full                    the kernel as built;
  padded                  a scratch copy of the sources whose launch gives
                          each frame PADDED_FRAME_BYTES of shared memory, the
                          whole lattice's 91,136 (2 frames per SM instead of
                          3): what the residency buys;
  block_barriers          a scratch copy whose sweep takes __syncthreads()
                          at every stage: what the warp-level stages buy;
  padded_block_barriers   both;
  select_lut              a scratch copy whose CHK takes the table by the
                          select tree of ops/chk._lut_tree (SELECT_LUT,
                          written into the copy) instead of the FMA chain
                          and its skip (bp::lut_fma, lut_fma_diff): what
                          moving the table to the FMA pipe buys;
  runtime_n               a scratch copy that launches the instance with n
                          taken at run time instead of the one compiled for
                          N = 1024: what the constant shape buys.

The scratch copies are built with the port's flags into
polardecoding_tpu_torch/_build/parts/ (one per source: the two wave kernels
share csrc/bp_wave.cu) and each must give the full kernel's
outputs bit for bit.  Each reading is the median of --reps CUDA-event
timings of one launch after a warmup, with the launch shape (threads, shared
memory and frames per SM from the occupancy query, registers, local memory)
and the compiler's register and spill lines; where the toolkit has
cuobjdump, also each build's instruction mix in the kernel of the main
path's flavor (SASS opcodes by the unit that runs them).  With --baseline,
also the four kernels of another checkout of the repository (its
polardecoding_tpu_torch), through its wrappers in a subprocess, in turns
with this one's (baseline, this, this, baseline), and a digest of the
outputs, equal across checkouts when the kernels agree.  Prints one JSON
line per reading with the card's name and power limit; exits 2 without a
card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DECODE_B, ITERS, EBN0_DB = 1024, 8192, 100, 2.0
MC_PRESET, MC_B, MC_K, MC_CADENCE, MC_WARMUP = "BP_1024_FASTCHK", 16384, 32, 2, 8
WAVE_PRESET, WAVE_B, WAVE_K, WAVE_WARMUP = "BP_1024_ES", 16384, 8, 8
PADDED_FRAME_BYTES = 91136
KERNELS = ("bp_decode", "bp_wave", "bp_wave_fused", "bp_wave_mc")
# each kernel's source, csrc/<source>.cu
SOURCE = {"bp_decode": "bp_decode", "bp_wave": "bp_wave",
          "bp_wave_fused": "bp_wave", "bp_wave_mc": "bp_wave_mc"}
# the texts that the scratch copies edit
SMEM_AT = "*smem = bp::live_bytes("
WARP_SYNC_AT = "__device__ __forceinline__ void warp_sync(unsigned wm) {\n"
MAIN_N_AT = "return n == kMainN ? "
# select_lut: the select tree of ops/chk._lut_tree (a value exactly at a
# threshold falls in the upper bin, NaN in bin 0), put before the CHK, and
# the CHK's table taken by it, without the skip
CHK_AT = "// The CHK of ops/chk.py"
SELECT_LUT = """__device__ __forceinline__ float lut(float x) {
  return x >= kT3 ? (x >= kT5 ? (x >= kT6 ? kV7 : kV6) : (x >= kT4 ? kV5 : kV4))
                  : (x >= kT1 ? (x >= kT2 ? kV3 : kV2) : (x >= kT0 ? kV1 : kV0));
}

"""
SELECT_CHK = (("lut_fma_diff(ap, aq);", "(lut(ap) - lut(aq));"),
              ("  if (fabsf(fabsf(a) - fabsf(b)) >= kT6) return sm + (kV7 - kV7);\n",
               ""),
              ("lut_fma(fabsf(a + b)) - lut_fma(fabsf(a - b))",
               "lut(fabsf(a + b)) - lut(fabsf(a - b))"))
VARIANTS = ("padded", "block_barriers", "padded_block_barriers", "select_lut",
            "runtime_n")
# SASS opcodes by the unit that issues them: the FP32 pipe (adds,
# multiplies, FMAs), the ALU pipe at half its rate (compares, selects,
# min/max, logic), shared memory, barriers
OPCLASS = {"fp32": ("FADD", "FMUL", "FFMA"),
           "alu": ("FSETP", "FSEL", "FMNMX", "FSET", "ISETP", "SEL", "LOP3",
                   "PLOP3", "IADD3", "SHF", "LEA", "IMNMX", "P2R", "R2P"),
           "imad": ("IMAD",),
           "shared": ("LDS", "STS"),
           "barrier": ("BAR", "WARPSYNC", "VOTE")}
# the main path's instance: its template arguments before the constant
# n = 10 (the runtime_n copy launches the one with n at run time, NC = 0)
MAIN_FLAVOR = {"bp_decode": "ILi0E", "bp_wave": "ILi0ELb0ELb0E",
               "bp_wave_fused": "ILi0ELb1ELb0E", "bp_wave_mc": "ILi1E"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def llrs(device="cuda", seed=1):
    """LLRs of the all-zero codeword through AWGN at EBN0_DB, rate 1/2."""
    rng = np.random.default_rng(seed)
    sigma = math.sqrt(1.0 / (2 * 0.5 * 10 ** (EBN0_DB / 10)))
    y = 1.0 + sigma * rng.normal(size=(DECODE_B, N))
    return torch.as_tensor((2.0 * y / sigma ** 2).astype(np.float32),
                           device=device)


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def median_ms(launch, reps, before=None):
    """Median CUDA-event time of launch() over reps, before() run outside
    each timed window; one warmup first."""
    ts = []
    for r in range(reps + 1):
        if before:
            before()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        torch.cuda.synchronize()
        if r:
            ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


def wave_cases(sigma):
    """{bp_wave, bp_wave_fused: (run(), outputs(), before)} at the wave
    kernels' main shape: the state, retire mask and fresh LLRs of
    make_wave_step (fused) after WAVE_WARMUP steps."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.bp_wave_kernel import (bp_wave_cuda,
                                                            bp_wave_fused_cuda)
    from polardecoding_tpu_torch.ops.channel import (awgn_llr, fold_in,
                                                     frame_keys, prng_key)
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu
    from polardecoding_tpu_torch.parallel.harness import (code_tables,
                                                          make_wave_step,
                                                          payload_from_index)

    p = preset(WAVE_PRESET)
    flavor = p.decoder.bp_flavor
    init, step, _ = make_wave_step(p, WAVE_B, WAVE_K, "cuda")
    key = fold_in(prng_key(p.sweep.seed, "cuda"), int(round(EBN0_DB * 100)))
    carry = init(key, 0, sigma)
    for _ in range(WAVE_WARMUP):
        carry, _ = step(key, sigma, carry)
    state0, fidx, retire = carry[0], carry[1], carry[4]
    tables = code_tables(p.code, "cuda")
    llr = awgn_llr(encode_info_mxu(payload_from_index(fidx, tables.pn, p.code.K),
                                   tables.g_rows), frame_keys(key, fidx), sigma)
    plain, fused = state0.clone(), state0.clone()
    u = torch.empty((WAVE_B, N), dtype=torch.int8, device="cuda")
    done = torch.empty(WAVE_B, dtype=torch.bool, device="cuda")

    def run_fused():
        _, u1, d1 = bp_wave_fused_cuda(fused, llr, retire, WAVE_K, flavor)
        u.copy_(u1)
        done.copy_(d1)

    return {"bp_wave": (lambda: bp_wave_cuda(plain, WAVE_K, flavor),
                        lambda: (plain,), lambda: plain.copy_(state0)),
            "bp_wave_fused": (run_fused, lambda: (fused, u, done),
                              lambda: fused.copy_(state0))}


def cases():
    """{kernel: (run(), outputs(), before or None)} of this package at the
    main paths' shapes."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.bp import mc_delta, mc_tables
    from polardecoding_tpu_torch.ops.bp_kernel import bp_decode_cuda
    from polardecoding_tpu_torch.ops.bp_wave_mc_kernel import bp_wave_mc_cuda
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_wave_step_mc
    from polardecoding_tpu_torch.utils.sequences import frozen_mask, info_set

    ch = llrs()
    fr = torch.as_tensor(frozen_mask(N, N // 2), device="cuda")
    u = torch.empty((DECODE_B, N), dtype=torch.int8, device="cuda")

    p = preset(MC_PRESET)
    init, step, _ = make_wave_step_mc(p, MC_B, MC_K, "cuda", cadence=MC_CADENCE)
    key = fold_in(prng_key(p.sweep.seed, "cuda"), int(round(EBN0_DB * 100)))
    sigma = float(sigma_from_ebn0_db(EBN0_DB))
    carry = init(key, 0, sigma)
    for _ in range(MC_WARMUP):
        carry, _ = step(key, sigma, carry)
    state0, meta0, stepc, (k0, k1) = carry
    state, meta = state0.clone(), meta0.clone()
    stats = torch.empty((MC_B, 3), device="cuda")
    tabs = mc_tables(info_set(N, p.code.K), p.code.K, N, "cuda")
    kw = dict(iters=MC_K, flavor=p.decoder.bp_flavor, iter_max=p.decoder.bp_iters,
              delta=mc_delta(MC_B, p.code.K), spares=max(2, MC_K // 8),
              cadence=MC_CADENCE)

    def mc():
        out = bp_wave_mc_cuda(state, meta, *tabs, sigma,
                              (k0, k1, k0 ^ k1, stepc), **kw)
        stats.copy_(out[2])

    def restore():
        state.copy_(state0)
        meta.copy_(meta0)

    return {"bp_decode": (lambda: u.copy_(bp_decode_cuda(ch, fr, ITERS)),
                          lambda: (u,), None),
            **wave_cases(sigma),
            "bp_wave_mc": (mc, lambda: (state, meta, stats), restore)}


def start_scratch(_build, source, variant):
    """Write the scratch copy `variant` of csrc/<source>.cu (with copies of
    the shared headers beside it) into _build/parts/ and start nvcc on it
    with the port's flags; returns (process, library path)."""
    d = os.path.join(_build.BUILD_DIR, "parts", f"{source}_{variant}")
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(_build.CSRC):
        if f.endswith(".cuh") or f == source + ".cu":
            shutil.copy(os.path.join(_build.CSRC, f), d)

    def edit(name, old, new):
        path = os.path.join(d, name)
        with open(path) as fh:
            src = fh.read()
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not where expected")
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))

    if "padded" in variant:
        edit(source + ".cu", SMEM_AT,
             f"*smem = {PADDED_FRAME_BYTES} + 0 * bp::live_bytes(")
    if "block_barriers" in variant:
        edit("bp_common.cuh", WARP_SYNC_AT, WARP_SYNC_AT + "  __syncthreads();\n"
             "  return;\n")
    if variant == "select_lut":  # every CHK of the sweep
        edit("bp_common.cuh", CHK_AT, SELECT_LUT + CHK_AT)
        for old, new in SELECT_CHK:
            edit("bp_common.cuh", old, new)
    if variant == "runtime_n":
        edit(source + ".cu", MAIN_N_AT, "return false && n == kMainN ? ")
    so = os.path.join(d, source + ".so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
           os.path.join(d, source + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def finish_scratch(variant, proc, so):
    """Wait for a scratch build; returns (library, the compiler's register
    and spill lines)."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {variant}:\n{log}")
    return ctypes.CDLL(so), ptxas_lines(log)


def instruction_mix(so, kernel, variant):
    """{class: count} of the SASS of `kernel` in its main path's flavor and
    mode, in the instance the variant launches at N = 1024, in the library
    `so` (OPCLASS), or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True)
    if out.returncode:
        return None
    mix, inside = {}, False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            nc = "Li0EE" if variant == "runtime_n" else "Li10EE"
            inside = (f"{SOURCE[kernel]}_kernel" in line
                      and MAIN_FLAVOR[kernel] + nc in line)
            continue
        if not inside or "/*" not in line or ";" not in line:
            continue
        m = re.match(r"\s*(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)",
                     line.split("*/", 1)[1])
        if not m:
            continue
        op = m.group(1)
        cls = next((c for c, ops in OPCLASS.items() if op in ops), "other")
        mix[cls] = mix.get(cls, 0) + 1
    return mix


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


@contextlib.contextmanager
def library(_build, source, lib):
    """The port's wrappers launch `lib` as csrc/<source>.cu's library."""
    old = _build._libs.get(source)
    _build._libs[source] = lib
    try:
        yield
    finally:
        _build._libs[source] = old


def shape_of(kernel):
    from polardecoding_tpu_torch.ops.bp_kernel import bp_decode_shape
    from polardecoding_tpu_torch.ops.bp_wave_kernel import bp_wave_shape
    from polardecoding_tpu_torch.ops.bp_wave_mc_kernel import bp_wave_mc_shape

    if kernel == "bp_decode":
        return bp_decode_shape(N)
    if kernel == "bp_wave_mc":
        return bp_wave_mc_shape(N, "minsum_lut_fast")
    return bp_wave_shape(N, "minsum_lut", fused=kernel == "bp_wave_fused")


def parts(reps, card):
    from polardecoding_tpu_torch.ops import _build

    _build.build_all()
    runs = cases()
    summary = {}
    started, built = {}, {}
    for source in sorted(set(SOURCE.values())):  # every scratch build at once
        for variant in VARIANTS:
            started[source, variant] = start_scratch(_build, source, variant)
    for kernel in KERNELS:
        run, outputs, before = runs[kernel]
        source = SOURCE[kernel]
        with open(_build._target(source)[:-3] + ".log") as f:
            libs = {"full": (_build.load(source), ptxas_lines(f.read()))}
        paths = {"full": _build._target(source)}
        for (s, variant), job in started.items():
            if s == source:
                if (s, variant) not in built:
                    built[s, variant] = finish_scratch(variant, *job)
                libs[variant] = built[s, variant]
                paths[variant] = job[1]
        for name, so in paths.items():
            emit({"bp_part_sass": {"kernel": kernel, "variant": name,
                                   "mix": instruction_mix(so, kernel, name),
                                   "card": card}})
        ref = None
        order = list(libs)
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                lib, ptxas = libs[name]
                with library(_build, source, lib):
                    ms = median_ms(run, reps, before)
                    shape = shape_of(kernel)
                got = [t.clone() for t in outputs()]
                if ref is None:
                    ref = got
                equal = all(_bits_equal(a, b) for a, b in zip(got, ref))
                if not equal:
                    raise RuntimeError(f"{kernel} {name}: outputs differ from "
                                       "the full kernel's")
                summary.setdefault((kernel, name), []).append(ms)
                emit({"bp_part": dict(kernel=kernel, variant=name, turn=turn,
                                      ms=ms, equal_to_full=equal, **shape,
                                      ptxas=ptxas, card=card)})
        emit({"bp_digest": {"kernel": kernel, "digest": digest(*ref),
                            "card": card}})
    for (kernel, name), ms in summary.items():
        emit({"bp_part_summary": {"kernel": kernel, "variant": name, "ms": ms,
                                  "mean_ms": sum(ms) / len(ms), "card": card}})


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return bool((a.view(torch.int32) == b.view(torch.int32)).all())
    return bool((a == b).all())


def kernel_only(reps, card):
    """The four kernels of the package on sys.path, through its wrappers."""
    runs = cases()
    root = os.environ.get("BP_PARTS_ROOT", ROOT)
    for kernel in KERNELS:
        run, outputs, before = runs[kernel]
        ms = median_ms(run, reps, before)
        emit({"bp_kernel": {"root": root, "kernel": kernel, "ms": ms,
                            "digest": digest(*outputs()), "card": card}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another checkout of the repository")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernel-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bp_parts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.environ.get("BP_PARTS_ROOT", ROOT))
    from polardecoding_tpu_torch.utils.card import card_line

    card = card_line()
    if args.kernel_only:
        kernel_only(args.reps, card)
        return 0
    parts(args.reps, card)
    if args.baseline:
        for r in (args.baseline, ROOT, ROOT, args.baseline):
            env = dict(os.environ, BP_PARTS_ROOT=os.path.abspath(r))
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--kernel-only", "--reps", str(args.reps)],
                                 env=env, capture_output=True, text=True)
            if out.returncode:
                print(out.stderr, file=sys.stderr)
                return out.returncode
            print(out.stdout, end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
