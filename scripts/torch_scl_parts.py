#!/usr/bin/env python3
"""What each part of the SCL list-decode kernel's design buys, on the card.

  python scripts/torch_scl_parts.py [--baseline CHECKOUT] [--reps 5] [--phases]

Times csrc/scl_decode.cu at the SCL main path's shape (N=1024, L=8,
B=16384, the 5G mask at rate 1/2, LLRs of the all-zero codeword at 2.0 dB
from a seed) in both modes, exact and the FASTR1 flavor (r1=4, wloop 2),
four ways each, in turns:

  full             the node table of ops/scl_kernel.leaf_codes;
  no_nodes         every R0 and REP node taken bit by bit (the flavor keeps
                   its R1 nodes): what the node schedule buys;
  padded           a scratch copy of the source, built into
                   polardecoding_tpu_torch/_build/, whose launch gives each
                   frame PADDED_FRAME_BYTES of shared memory, the first
                   kernel's 50,564 (4 frames per SM instead of 13 in exact
                   mode, 10 in the flavor): what the smaller frame buys;
  padded_no_nodes  both.

Each is the median of --reps CUDA-event timings of one launch after a
warmup, and must give the full kernel's outputs (R0 and REP nodes decode
exactly as bit by bit does).  With --baseline, also the list-decode kernel of
another checkout of the repository (its polardecoding_tpu_torch), timed
through its scl_decode_cuda in a subprocess in turns with this one's
(baseline, this, this, baseline).  With --phases, also where a frame's
time goes: a second scratch copy that adds clock64() counters at the
boundaries of the kernel's phases (PHASES) and, per warp, their sums; one
launch per mode at the shape above, printed as cycles and counts per frame
(the counters cost time of their own: compare shares, not totals).  Prints
one JSON line per reading with the card's name and power limit; exits 2
without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, L, B, EBN0_DB, R1 = 1024, 8, 16384, 2.0, 4
PADDED_FRAME_BYTES = 50564
LAYOUT_TOTAL = "layout(n, L, tm, xw, top_regs(n, L, r1)).total"
# the phases: (name, the source line before which its counter stops); each
# counter runs from the previous one (or the step's start)
PHASES = (
    ("partial_sums", "        // B. the g-node at stage t\n"),
    ("g_node", "      // f-nodes at stages t-1 .. s, each reading the path's own row\n"),
    ("f_nodes", "      if (s == n) {  // a node of width N: its input is the channel\n"),
    ("leaf", "        j += 1;\n"),
    ("r0_rep", "        j += w;\n      } else {\n"),
    ("r1_ranks", "        // B. tt forks: candidates PM + 0"),
    ("r1_forks", "        // C. x of every path, its flips applied"),
    ("r1_x", "        // the bits slots below s and the last bit of path `lane`, then u"),
    ("r1_u", "        // D. the history: the origin at leaf j, the path itself after it\n"),
    ("r1_history", "        j += w;\n      }\n      __syncwarp();\n    }\n"),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def llrs(device="cuda", seed=1):
    """LLRs of the all-zero codeword through AWGN at EBN0_DB, rate 1/2."""
    rng = np.random.default_rng(seed)
    sigma = math.sqrt(1.0 / (2 * 0.5 * 10 ** (EBN0_DB / 10)))
    y = 1.0 + sigma * rng.normal(size=(B, N))
    return torch.as_tensor((2.0 * y / sigma ** 2).astype(np.float32),
                           device=device)


def median_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


def padded_library(_build):
    """The scratch copy: scl_decode.cu with every frame's shared memory
    raised to PADDED_FRAME_BYTES, built beside the port's libraries."""
    with open(os.path.join(_build.CSRC, "scl_decode.cu")) as f:
        src = f.read()
    if src.count(LAYOUT_TOTAL) != 1:
        raise RuntimeError("the launch's frame size is not where expected")
    src = src.replace(LAYOUT_TOTAL, f"std::max<size_t>({LAYOUT_TOTAL}, "
                                    f"{PADDED_FRAME_BYTES})")
    src = src.replace("#include <stdint.h>\n",
                      "#include <stdint.h>\n#include <algorithm>\n", 1)
    return build_copy(_build, "scl_decode_padded", src)


def build_copy(_build, name, src):
    """Build a scratch copy of the source with the port's flags into
    polardecoding_tpu_torch/_build/ and load it."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, name + ".cu")
    so = os.path.join(_build.BUILD_DIR, name + ".so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
           so, cu]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(so)


def phases_library(_build):
    """The scratch copy with phase counters (PHASES, and the traceback)."""
    with open(os.path.join(_build.CSRC, "scl_decode.cu")) as f:
        src = f.read()
    k = len(PHASES)

    def insert(text, before, add):
        if text.count(before) != 1:
            raise RuntimeError(f"phase marker not found once: {before!r}")
        return text.replace(before, add + before)

    def stop(i):
        return (f"{{ const long long t1 = clock64(); acc_[{i}] += t1 - t0_; "
                f"++cnt_[{i}]; t0_ = t1; }}\n")

    for i, (_, before) in enumerate(PHASES):
        src = insert(src, before, stop(i))
    src = insert(src, "  for (int frame = blockIdx.x * F + warp; frame < B;",
                 f"  long long acc_[{k + 1}] = {{0}}, t0_ = 0;\n"
                 f"  unsigned cnt_[{k + 1}] = {{0}};\n")
    src = insert(src, "    while (j < N) {\n", "    t0_ = clock64();\n")
    src = src.replace("    while (j < N) {\n", "    while (j < N) {\n"
                      "      t0_ = clock64();\n", 1)
    src = insert(src, "    // Trace each final path back", "    t0_ = clock64();\n")
    end = "  }\n}\n\n}  // namespace\n"  # the frame loop's and kernel's ends
    src = insert(src, end, "    " + stop(k))
    src = src.replace(end, "  }\n"
                      f"  if (lane == 0) for (int q = 0; q <= {k}; ++q) {{\n"
                      "    atomicAdd(&phase_cycles[q], (unsigned long long)acc_[q]);\n"
                      "    atomicAdd(&phase_counts[q], (unsigned long long)cnt_[q]);\n"
                      "  }\n}\n\n}  // namespace\n")
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long "
                      f"long phase_cycles[{k + 1}], phase_counts[{k + 1}];\n", 1)
    src += (f"\nextern \"C\" int scl_phases(unsigned long long* out, int reset) {{\n"
            f"  unsigned long long z[{2 * k + 2}] = {{0}};\n"
            f"  if (reset) {{\n"
            f"    cudaMemcpyToSymbol(phase_cycles, z, sizeof(phase_cycles));\n"
            f"    return (int)cudaMemcpyToSymbol(phase_counts, z, sizeof(phase_counts));\n"
            f"  }}\n"
            f"  cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));\n"
            f"  return (int)cudaMemcpyFromSymbol(out + {k + 1}, phase_counts,\n"
            f"                                   sizeof(phase_counts));\n}}\n")
    return build_copy(_build, "scl_decode_phases", src)


def phases(card):
    from polardecoding_tpu_torch.ops import _build, scl_kernel
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    lib = phases_library(_build)
    names = [p for p, _ in PHASES] + ["traceback"]
    mask = frozen_mask(N, N // 2)
    ch = llrs()
    u = torch.empty((B, L, N), dtype=torch.int8, device="cuda")
    pm = torch.empty((B, L), device="cuda")
    ties = torch.empty(B, dtype=torch.int32, device="cuda")
    lib.scl_decode_launch.argtypes = scl_kernel._ARGTYPES + [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * (2 * len(names)))()
    for mode, r1 in (("exact", 0), ("flavor", R1)):
        codes = scl_kernel.leaf_codes(mask, r1, 2)
        widest = max((1 << ((c >> 1) & 15) for c in codes if c >> 5 == 3),
                     default=0)
        tm, xw = min(L - 1, widest), (max(1, widest // 32) if widest else 0)
        tab = torch.tensor(codes, dtype=torch.uint8, device="cuda")
        for reset in (1, 0):  # a warmup launch, then the counted one
            lib.scl_phases(out, 1)
            rc = lib.scl_decode_launch(
                ch.data_ptr(), tab.data_ptr(), u.data_ptr(), pm.data_ptr(),
                ties.data_ptr(), B, N, L, tm, xw, int(widest > 0),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"phases {mode}: launch failed ({rc})")
            torch.cuda.synchronize()
        lib.scl_phases(out, 0)
        cycles = {nm: out[i] / B for i, nm in enumerate(names)}
        total = sum(cycles.values())
        emit({"scl_phases": {
            "mode": mode, "cycles_per_frame": total,
            "phases": {nm: {"cycles": c, "share": c / total,
                            "count": out[len(names) + i] / B}
                       for i, (nm, c) in enumerate(cycles.items())},
            "card": card}})


def parts(reps, card):
    from polardecoding_tpu_torch.ops import _build, scl_kernel
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    lib = _build.load("scl_decode")
    libs = {"": lib, "padded": padded_library(_build)}
    mask = frozen_mask(N, N // 2)
    ch = llrs()
    u = torch.empty((B, L, N), dtype=torch.int8, device="cuda")
    pm = torch.empty((B, L), device="cuda")
    ties = torch.empty(B, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for lb in libs.values():
        lb.scl_decode_launch.argtypes = scl_kernel._ARGTYPES + [ctypes.c_void_p]
    results = {}
    for mode, r1 in (("exact", 0), ("flavor", R1)):
        codes = scl_kernel.leaf_codes(mask, r1, 2)
        widest = max((1 << ((c >> 1) & 15) for c in codes if c >> 5 == 3),
                     default=0)
        tm, xw = min(L - 1, widest), (max(1, widest // 32) if widest else 0)
        tables = {"full": codes,
                  "no_nodes": [c if c >> 5 in (0, 3) else c & 1 for c in codes]}
        ref = None
        for turn in (0, 1):
            order = [(t, p) for t in tables for p in libs]
            for tname, pad in order if turn == 0 else order[::-1]:
                name = f"{pad}_{tname}".strip("_")
                lb = libs[pad]
                tab = torch.tensor(tables[tname], dtype=torch.uint8,
                                   device="cuda")

                def go():
                    rc = lb.scl_decode_launch(
                        ch.data_ptr(), tab.data_ptr(), u.data_ptr(),
                        pm.data_ptr(), ties.data_ptr(), B, N, L, tm, xw,
                        int(widest > 0), stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed ({rc})")

                ms = median_ms(go, reps)
                got = (u.clone(), pm.clone(), ties.clone())
                if ref is None:
                    ref = got
                equal = all(bool((a == b).all()) for a, b in zip(got, ref))
                if not equal:
                    raise RuntimeError(f"{mode} {name}: outputs differ from "
                                       "the full kernel's")
                shape = [ctypes.c_int(), ctypes.c_int(), ctypes.c_size_t(),
                         ctypes.c_int()]
                lb.scl_decode_shape(B, N, L, tm, xw, int(widest > 0),
                                    *(ctypes.byref(x) for x in shape))
                results.setdefault((mode, name), []).append(ms)
                emit({"scl_part": {"mode": mode, "variant": name, "turn": turn,
                                   "ms": ms, "frames_per_block":
                                   shape[0].value // 32, "blocks_per_sm":
                                   shape[3].value, "smem_bytes": shape[2].value,
                                   "equal_to_full": equal, "card": card}})
    for (mode, name), ms in results.items():
        emit({"scl_part_summary": {"mode": mode, "variant": name,
                                   "ms": ms, "mean_ms": sum(ms) / len(ms),
                                   "card": card}})


def kernel_only(reps, card):
    """The list-decode kernel of the package on sys.path, through its
    scl_decode_cuda, in both modes."""
    from polardecoding_tpu_torch.ops.scl_kernel import scl_decode_cuda
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    fr = torch.as_tensor(frozen_mask(N, N // 2), device="cuda")
    ch = llrs()
    for mode, r1 in (("exact", 0), ("flavor", R1)):
        ms = median_ms(lambda: scl_decode_cuda(ch, fr, L, r1=r1), reps)
        emit({"scl_kernel": {"root": os.environ.get("SCL_PARTS_ROOT", ROOT),
                             "mode": mode, "ms": ms, "card": card}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another checkout of the repository")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--phases", action="store_true",
                    help="also the cycles of the kernel's phases per frame")
    ap.add_argument("--kernel-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_scl_parts: no CUDA device", file=sys.stderr)
        return 2
    root = os.environ.get("SCL_PARTS_ROOT", ROOT)
    sys.path.insert(0, root)
    from polardecoding_tpu_torch.utils.card import card_line

    card = card_line()
    if args.kernel_only:
        kernel_only(args.reps, card)
        return 0
    parts(args.reps, card)
    if args.phases:
        phases(card)
    if args.baseline:
        for r in (args.baseline, ROOT, ROOT, args.baseline):
            env = dict(os.environ, SCL_PARTS_ROOT=os.path.abspath(r))
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
