#!/usr/bin/env python3
"""What each part of the two channel kernels' design buys, on the card.

  python scripts/torch_channel_parts.py [--baseline CHECKOUT] [--reps 5]

Times the kernels built on csrc/noise.cuh at their main paths' shapes:

  mc_channel     csrc/mc_channel.cu (TPU kernel row 5), BP_1024's MC-mode
                 table at B=8192, counter noise (make_frame_step(channel=
                 "mc")'s channel);
  frame_channel  csrc/frame_channel.cu, the frame step's threefry channel
                 at B=16384, N=1024 (the SCL steps' shape): codewords of
                 frames 0.. of BP_1024 under its 2.0 dB point key.

Each kernel against scratch copies of its source and noise.cuh, built with
the port's flags into polardecoding_tpu_torch/_build/parts/, each taking
one part of the design out by a text substitution in the copy:

  division       every element's frame and lane from its flat index by a
                 64-bit division by N, which the compiler cannot see is a
                 power of two (the parent kernel's indexing);
  elems_K        K elements a thread instead of the kernel's 2^kElemsLog;
  runtime_n      the instance with n at run time instead of the one
                 compiled for N = 1024;
  i2f            the uniform's and XLA's log's integers converted by I2F
                 instead of the exact bit forms (mc_channel: both; frame
                 channel: the log's exponent);
  giles_selects  (mc_channel) Giles' pair as one chain whose 8 coefficients
                 are selected per step, instead of a branch per element.

Every copy must give the full kernel's outputs bit for bit.  Each reading
is the median of --reps readings of utils/card.queued_ms (20 launches
enqueued behind a sleep kernel, so the host's enqueue is hidden).  For each
build, the instruction mix of the kernel at N = 1024 (cuobjdump -sass, by
the unit that issues each opcode) in all and per element (the static count
over the elements a thread takes).  With --baseline, also the MC channel and
the MC wave kernel (csrc/bp_wave_mc.cu, which shares noise.cuh; one wave of
BP_1024_FASTCHK at B=16384, K=32, cadence 2 from the state after 8 waves)
of another checkout of the repository (its polardecoding_tpu_torch),
through its wrappers in a subprocess, in turns with this one's (baseline,
this, this, baseline), with a digest of each output, equal across
checkouts when the kernels agree, and the baseline's MC channel's
instruction mix.  Prints one JSON line per reading with the card's name and
power limit; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
PRESET, SNR_DB = "BP_1024", 2.0
MC_B, FRAME_B, N = 8192, 16384, 1024
WAVE_PRESET, WAVE_B, WAVE_K, WAVE_CADENCE, WAVE_WARMUP = ("BP_1024_FASTCHK",
                                                          16384, 32, 2, 8)
QUEUED_REPS = 20
KERNELS = ("mc_channel", "frame_channel")
# the texts that the scratch copies edit: (file, old, new)
TILE_AT = """  __device__ __forceinline__ int frame(int i) const {
    return n >= kTileLog ? 0 : i >> n;
  }
  __device__ __forceinline__ int lane(int i) const {
    return n >= kTileLog ? c0 + i : i & ((1 << n) - 1);
  }
"""
TILE_DIVISION = """  __device__ __forceinline__ unsigned long long flat(int i) const {
    return static_cast<unsigned long long>(blockIdx.x) * kTile + i;
  }
  __device__ __forceinline__ unsigned long long opaque_n() const {
    unsigned v;
    asm("mov.b32 %0, %1;" : "=r"(v) : "r"(1u << n));
    return v;
  }
  __device__ __forceinline__ int frame(int i) const {
    return static_cast<int>(flat(i) / opaque_n() - b0);
  }
  __device__ __forceinline__ int lane(int i) const {
    const unsigned long long e = flat(i);
    return static_cast<int>(e - e / opaque_n() * opaque_n());
  }
"""
GILES_AT = """  const float p = w < 5.0f ? giles_lt5(w - 2.5f)
                           : giles_ge5(__fsqrt_rn(w) - 3.0f);
"""
GILES_SELECTS = """  constexpr float kLt5[9] = {
      0x1.e2cb1p-26f,  0x1.70966cp-22f, -0x1.d8e6aep-19f,
      -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
      -0x1.11c9dep-8f,  0x1.f91ec6p-3f,  0x1.805c5ep+0f};
  constexpr float kGe5[9] = {
      -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
      -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
      0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
  const bool lt = w < 5.0f;
  const float ws = lt ? w - 2.5f : __fsqrt_rn(w) - 3.0f;
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) p = fmaf(p, ws, lt ? kLt5[k] : kGe5[k]);
"""
EDITS = {
    "division": [("noise.cuh", TILE_AT, TILE_DIVISION)],
    "runtime_n": [("{source}.cu", "return n == kMainN ? ",
                   "return false && n == kMainN ? ")],
    "i2f": [("noise.cuh", "float e = small_int_to_float((bits >> 23) - 127) + 1.0f;",
             "float e = static_cast<float>((bits >> 23) - 127) + 1.0f;"),
            ("noise.cuh", """  const float one = __uint_as_float((bits >> 9) | 0x3F800000u);
  const float x = ((one + one) - 3.0f) + 0x1p-23f;
""", """  const float f = static_cast<float>((bits >> 9) & 0x7FFFFFu);
  const float x = 2.0f * ((f + 0.5f) * 0x1p-23f) - 1.0f;
""")],
    "giles_selects": [("noise.cuh", GILES_AT, GILES_SELECTS)],
}
VARIANTS = {"mc_channel": ("division", "elems_2", "elems_4", "elems_8",
                           "runtime_n", "i2f", "giles_selects"),
            "frame_channel": ("division", "elems_1", "elems_2", "elems_8",
                              "runtime_n", "i2f")}
ELEMS_AT = re.compile(r"constexpr int kElemsLog = \d+;")
# SASS opcodes by the unit that issues them
OPCLASS = {"fp32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FSET",
                    "FCHK"),
           "int": ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "IMNMX",
                   "IABS", "PLOP3", "P2R", "R2P", "IMAD", "IMUL", "POPC",
                   "FLO", "BREV"),
           "conversion": ("I2F", "F2I", "I2FP", "F2IP", "F2F", "I2I"),
           "mufu": ("MUFU",),
           "memory": ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LD", "ST"),
           "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR",
                       "WARPSYNC", "BMOV", "YIELD")}


def emit(obj):
    print(json.dumps(obj), flush=True)


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def card_module():
    """This checkout's utils/card.py, loaded by path, so that a baseline's
    turns are timed the same way whatever its package holds."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_channel_parts_card",
        os.path.join(ROOT, "polardecoding_tpu_torch", "utils", "card.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def median_ms(run, reps):
    queued_ms = card_module().queued_ms
    ts = sorted(queued_ms(run, QUEUED_REPS)[0] for _ in range(reps))
    return ts[len(ts) // 2]


def channel_cases(with_frame=True):
    """{kernel: run() -> outputs} at the main paths' shapes, through the
    wrappers of the package on sys.path (the frame channel with_frame)."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops import channel_kernel
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu
    from polardecoding_tpu_torch.parallel.harness import (_mc_mode_tables,
                                                          code_tables,
                                                          payload_from_index)

    p = preset(PRESET)
    key = fold_in(prng_key(p.sweep.seed, "cuda"), int(round(SNR_DB * 100)))
    sigma = float(sigma_from_ebn0_db(SNR_DB))
    k0, k1 = key.tolist()
    _, xtab = _mc_mode_tables(p.code, "cuda")
    m = (torch.arange(MC_B, device="cuda") * (p.code.K % 63)) % 63
    cases = {"mc_channel": lambda: (channel_kernel.mc_channel_cuda(
        m, xtab, sigma, (k0, k1, k0 ^ k1, 0)),)}
    if with_frame:
        from polardecoding_tpu_torch.ops.frame_channel_kernel import frame_llr_cuda

        tables = code_tables(p.code, "cuda")
        fidx = torch.arange(FRAME_B, device="cuda")
        x = encode_info_mxu(payload_from_index(fidx, tables.pn, p.code.K),
                            tables.g_rows)
        cases["frame_channel"] = lambda: (frame_llr_cuda(x, key, fidx, sigma),)
    return cases


def wave_mc_case():
    """run() -> outputs of one MC wave (csrc/bp_wave_mc.cu) from the state
    of make_wave_step_mc after WAVE_WARMUP waves, restored before each."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.bp import mc_delta, mc_tables
    from polardecoding_tpu_torch.ops.bp_wave_mc_kernel import bp_wave_mc_cuda
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_wave_step_mc
    from polardecoding_tpu_torch.utils.sequences import info_set

    p = preset(WAVE_PRESET)
    init, step, _ = make_wave_step_mc(p, WAVE_B, WAVE_K, "cuda",
                                      cadence=WAVE_CADENCE)
    key = fold_in(prng_key(p.sweep.seed, "cuda"), int(round(SNR_DB * 100)))
    sigma = float(sigma_from_ebn0_db(SNR_DB))
    carry = init(key, 0, sigma)
    for _ in range(WAVE_WARMUP):
        carry, _ = step(key, sigma, carry)
    state0, meta0, stepc, (k0, k1) = carry
    state, meta = state0.clone(), meta0.clone()
    tabs = mc_tables(info_set(N, p.code.K), p.code.K, N, "cuda")
    kw = dict(iters=WAVE_K, flavor=p.decoder.bp_flavor,
              iter_max=p.decoder.bp_iters, delta=mc_delta(WAVE_B, p.code.K),
              spares=max(2, WAVE_K // 8), cadence=WAVE_CADENCE)

    def run():
        state.copy_(state0)
        meta.copy_(meta0)
        out = bp_wave_mc_cuda(state, meta, *tabs, sigma,
                              (k0, k1, k0 ^ k1, stepc), **kw)
        return state, meta, out[2]

    return run


def start_scratch(_build, source, variant):
    """Write the scratch copy `variant` of csrc/<source>.cu and noise.cuh
    into _build/parts/ and start nvcc on it with the port's flags; returns
    (process, library path)."""
    d = os.path.join(_build.BUILD_DIR, "parts", f"{source}_{variant}")
    os.makedirs(d, exist_ok=True)
    for f in ("noise.cuh", f"{source}.cu"):
        shutil.copy(os.path.join(_build.CSRC, f), d)
    edits = EDITS.get(variant, [])
    if variant.startswith("elems_"):
        k = int(variant[len("elems_"):]).bit_length() - 1
        with open(os.path.join(d, f"{source}.cu")) as fh:
            at = ELEMS_AT.search(fh.read()).group(0)
        edits = [("{source}.cu", at, f"constexpr int kElemsLog = {k};")]
    for name, old, new in edits:
        path = os.path.join(d, name.format(source=source))
        with open(path) as fh:
            src = fh.read()
        if src.count(old) != 1:
            raise RuntimeError(f"{variant}: {old!r} is not where expected")
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))
    so = os.path.join(d, source + ".so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
           os.path.join(d, source + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def instruction_mix(so, source, elems, runtime_n=False):
    """{class: count} of the SASS of csrc/<source>.cu's kernel that N = 1024
    launches in the library `so` (the instance with constant n where there
    is one, unless runtime_n), the total, the total per element (over
    `elems` a thread) and the most frequent opcodes, or None without
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True)
    if out.returncode:
        return None
    funcs, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = ({}, {})
            continue
        if name is None or "/*" not in line or ";" not in line:
            continue
        m = re.match(r"\s*(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)",
                     line.split("*/", 1)[1])
        if not m or m.group(1) == "NOP":
            continue
        op = m.group(1).split(".")[0]
        cls = next((c for c, ops in OPCLASS.items() if op in ops), "other")
        mix, ops = funcs[name]
        mix[cls] = mix.get(cls, 0) + 1
        ops[op] = ops.get(op, 0) + 1
    mine = {k: v for k, v in funcs.items() if f"{source}_kernel" in k}
    const = [k for k in mine if ("Li0E" if runtime_n else "Li10E") in k]
    if not mine:
        return None
    mix, ops = mine[const[0] if const else sorted(mine)[0]]
    total = sum(mix.values())
    top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:16])
    return {"mix": mix, "total": total, "per_element": total / elems,
            "elements_a_thread": elems, "top_opcodes": top}


@contextlib.contextmanager
def library(_build, source, lib):
    """The port's wrappers launch `lib` as csrc/<source>.cu's library."""
    old = _build._libs.get(source)
    _build._libs[source] = lib
    try:
        yield
    finally:
        _build._libs[source] = old


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return bool((a.view(torch.int32) == b.view(torch.int32)).all())
    return bool((a == b).all())


def elems_per_thread(csrc, source):
    """Elements a thread of csrc/<source>.cu takes (its kElemsLog; 1
    without one)."""
    with open(os.path.join(csrc, source + ".cu")) as f:
        m = re.search(r"constexpr int kElemsLog = (\d+);", f.read())
    return 1 << int(m.group(1)) if m else 1


def parts(reps, card):
    from polardecoding_tpu_torch.ops import _build

    _build.build_all()
    runs = channel_cases()
    started = {(s, v): start_scratch(_build, s, v)
               for s in KERNELS for v in VARIANTS[s]}
    summary = {}
    for kernel in KERNELS:
        with open(_build._target(kernel)[:-3] + ".log") as f:
            libs = {"full": (_build.load(kernel), ptxas_lines(f.read()),
                             _build._target(kernel))}
        for v in VARIANTS[kernel]:
            proc, so = started[kernel, v]
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {kernel} {v}:\n{log}")
            libs[v] = (ctypes.CDLL(so), ptxas_lines(log), so)
        for name, (_, ptxas, so) in libs.items():
            emit({"channel_part_sass": dict(
                kernel=kernel, variant=name, ptxas=ptxas, card=card,
                **(instruction_mix(so, kernel, elems_per_thread(
                    os.path.dirname(so) if name != "full" else _build.CSRC,
                    kernel), name == "runtime_n") or {}))})
        ref = None
        order = list(libs)
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                with library(_build, kernel, libs[name][0]):
                    ms = median_ms(runs[kernel], reps)
                    got = [t.clone() for t in runs[kernel]()]
                torch.cuda.synchronize()
                ref = ref or got
                if not all(_bits_equal(a, b) for a, b in zip(got, ref)):
                    raise RuntimeError(f"{kernel} {name}: outputs differ from "
                                       "the full kernel's")
                summary.setdefault((kernel, name), []).append(ms)
                emit({"channel_part": dict(kernel=kernel, variant=name,
                                           turn=turn, ms=ms, card=card)})
        emit({"channel_digest": {"kernel": kernel, "digest": digest(*ref),
                                 "card": card}})
    for (kernel, name), ms in summary.items():
        emit({"channel_part_summary": {"kernel": kernel, "variant": name,
                                       "ms": ms, "mean_ms": sum(ms) / len(ms),
                                       "card": card}})


def kernel_only(reps, card):
    """The MC channel and the MC wave kernel of the package on sys.path,
    through its wrappers, with the MC channel's instruction mix."""
    from polardecoding_tpu_torch.ops import _build

    root = os.environ.get("CHANNEL_PARTS_ROOT", ROOT)
    runs = dict(channel_cases(with_frame=False), bp_wave_mc=wave_mc_case())
    for kernel, run in runs.items():
        ms = median_ms(run, reps)
        emit({"channel_kernel": {"root": root, "kernel": kernel, "ms": ms,
                                 "digest": digest(*run()), "card": card}})
    mix = instruction_mix(_build._target("mc_channel"), "mc_channel",
                          elems_per_thread(_build.CSRC, "mc_channel"))
    emit({"channel_kernel_sass": dict(root=root, kernel="mc_channel",
                                      card=card, **(mix or {}))})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another checkout of the repository")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernel-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_channel_parts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.environ.get("CHANNEL_PARTS_ROOT", ROOT))
    card = card_module().card_line()
    if args.kernel_only:
        kernel_only(args.reps, card)
        return 0
    parts(args.reps, card)
    if args.baseline:
        for r in (args.baseline, ROOT, ROOT, args.baseline):
            env = dict(os.environ, CHANNEL_PARTS_ROOT=os.path.abspath(r))
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
