#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (polardecoding_tpu_torch) on one GPU.

  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA source of the port (polardecoding_tpu_torch/csrc), one
   nvcc per source, all started together, and prints the build time and
   the compiler's register/shared-memory report;
3. prints the live-row BP kernels' launch shapes (shared memory per frame,
   frames per SM, registers, spills) at N=1024 and 128, the wave kernels in
   every flavor, and checks 3 frames per SM, at most 74,752 bytes a frame
   and no spills at N=1024; the SCL kernel's, exact and rate-1 at N=1024
   (L=8, 16, 32) and N=128 (L=8), and checks no spills and 13 frames per
   SM in exact mode at L=8; holds the frame step's channel kernel
   (csrc/frame_channel.cu) against its plain version on the card, bit for
   bit on every element: N in {8, 64, 128, 1024}, B in {1, 33, 512,
   16384}, at -2, 0, 2, 6 and 10 dB, frame indices 0.. and 2^31 - 3 ..
   2^31 + 1, 2^32 - 2, -1 and 2^32 - 1 (the last two one key), two point
   keys; and, with given words, every uniform that bits 9..31 give (2^23
   words) with x = 0 and 1 at -2 and 6 dB, the MC channel (row 5) on the
   same words; holds the BP decode kernel against its
   plain PyTorch version on the card:
   u_hat, written over a buffer filled with 90, bit-equal on every frame
   for N in {128, 1024}, and for BP_1024's decoder on N=8 and 64 codes at
   rate 1/2 (a frame one warp), B=512, LLRs from the
   port's channel at 1.0 and 2.0 dB, both min-sum flavors, early stop off
   and every 4 iterations; SPA equal on every frame the plain version
   decodes correctly (exp/log1p rounding may steer a non-converged frame);
   the whole frame step's counters equal with the kernel and with the plain
   decoder at the main path's batch, 8192; the frame channel's kernel on the
   card bit-equal to its plain version on the CPU on 64 frames;
4. holds the SCL list-decode kernel against its plain version on the card:
   u_all, PM and tie counter bit-equal on every frame at B=512, LLRs from
   the port's channel at 1.0 and 2.0 dB, N in {128, 1024} with the presets'
   masks and L in {1, 2, 8, 16, 32}; a random frozen mask at N=1024 with L=4
   and L=32 (the traced-mask kernels' contract); the node masks (node_masks:
   an R0 and a REP node of every width, all-info, random masks at N = 2, 4
   and 16) at L in {1, 2, 8, 16, 32}, B=128; a forced-tie input whose tie
   counter must be non-zero; every output written over buffers filled with
   90, so that a store left out shows; and the frame-step counters at 1.5 dB equal
   with kernel and plain decoder for SCL_1024_L8 (batch 16384),
   CASCL_1024_L8 and SC_1024 (4096) and CASCL_1024_L32 (1024);
5. the same for the kernel's rate-1 flavor (r1 in {2, 4}, wloop 2, L in
   {1, 2, 4, 8, 16, 32}): the _FASTR1 presets' masks (N=128 and 1024, CRC-24
   included) at 1.0 and 2.0 dB, all-info masks (one R1 node at the root) and
   random masks at N=32 and 1024, the node masks at r1 in {2, 4}, the
   forced-tie input, over buffers filled with 90; and the step
   counters at 1.5 dB of SCL_1024_L8_FASTR1 (batch 16384),
   CASCL_1024_L8_FASTR1 and SCL_1024_L16_FASTR1 (4096);
6. drives each main path with the launch counts at 0: four make_frame_step
   steps, then run_point at 2.0 dB; the path's decoder kernel and the frame
   channel must have been launched once a step, and no other kernel.
   BP_1024 at batch 8192 to 200 error blocks, BLER
   in [0.020, 0.043] (BASELINE.md: 0.02948 and 0.03292 for two seeds);
   SCL_1024_L8 and SCL_1024_L8_FASTR1 at batch 16384 to 100 error blocks,
   BLER in [0.0055, 0.0125] (BASELINE.md: 9.128e-3, a 5-seed mean, and
   7.85e-3 from a third-party oracle; the flavor's BLER is within 0.5% of
   exact's, docs/ROOFLINE.md:618); CASCL_1024_L8_FASTR1 and
   SCL_1024_L16_FASTR1 at batch 16384 to 50 error blocks, BLER in
   [0.002, 0.007] (BASELINE.md: 4.088e-3) and [0.0045, 0.0125] (8.032e-3);
7. holds the four wave-engine kernels against their plain versions on the
   card, bit for bit on every frame, at B=512 on the N=128 and 1024 presets'
   codes and BP_1024's cut to N=8 and 64: the fused wave kernel (check_every
   0 and 4) and the unfused one over four waves with retirements (state,
   u_hat, done); both, in both min-sum flavors, on one wave from a state
   three iterations in with every odd slot retired, at 0, 1 and 8
   iterations, the fused one with check_every 0, 1, 4 and 8; the MC wave
   kernel over five waves of 32, 0, 1, 32 and 32 iterations, the last in
   drain, with cadence 1 and 2, counter noise and given words (state, meta,
   stats); at one iteration or more the planes that an iteration
   overwrites (L[0], R[1..n]) hold NaN before the call.  Then the MC
   channel at B=8192 in both noise modes, and with counter noise from a
   first row of 4096 and of 2^22 - 4096 (a rank's slice of a global batch;
   the last one's counters pass 2^32); and the fused and unfused
   engines' per-step counters at B=16384, equal with kernels and plain
   versions and to each other;
8. drives the wave paths, each with the launch counts at 0: run_point on
   BP_1024_ES at 2.0 dB (the fused engine, K=8), run_point_waves on
   BP_1024_FASTCHK with engine="mc", K=32, cadence 2 (bench.py's BP leg)
   and on BP_1024_ES with fused=False, each at batch 16384 to 200 error
   blocks with BLER in [0.020, 0.043]; then one make_frame_step step with
   channel="mc" at batch 8192; each path's kernel must have been launched,
   the frame channel once a step of the fused engine, once a step and at
   init of the unfused one, never on the MC paths;
9. times each kernel and its plain version (plain, kernel, kernel, plain) at
   its main path's shape, BP_1024 with B=8192 and 100 iterations,
   SCL_1024_L8 with B=16384 and SCL_1024_L8_FASTR1 on the same LLRs (the
   exact kernel beside it), one wave at B=16384 (K=8 fused and unfused,
   K=32 MC), the MC channel at B=8192 and the frame channel at B=16384 (both
   timed behind a sleep kernel, utils/card.queued_ms, so that the host's
   enqueue is hidden), and holds the kernel's output
   bit-equal to the plain version's there on every frame; times each whole
   frame step (with its peak device memory), and its encode and channel
   (the frame channel's kernel) stages apart, CASCL_1024_L32's frame step
   at B=4096 (the SCL kernel at L=32), the fused ES wave step split
   into kernel and channel, and
   the retired frames per second of the fused and MC wave paths over one
   chunk of eight steps, with CUDA events after warmup;
10. traces three steps of each of the five paths with torch.profiler: wall
   and device time per step, the device's idle share, the device operations
   per step and the kernels that take the most time;
11. holds the probe kernels (the ports of the TPU probes) against their
   plain versions on the card, bit for bit, the floor's outputs written over
   buffers filled with 90 so that a store left out shows: the floor
   kernel's variants at the SCL main path's shape (N=1024, L=8, B=16384;
   bare and init with three outputs, bare, noscratch, no_u, u_i32 and no_in
   with two), ten launches back to back and a CUDA graph of twenty; the
   three probes' bare bodies at the drivers' other batches (512 to 65536);
   each operation pattern at the driver's shapes (gather at L=8 and 32,
   gather_rows on 8, 32 and 128 rows, lut on 8 and 32, rank at L=8 and 32,
   chk on 8 and 64) after 7 iterations on one tile and on 8 per SM;
12. runs the four probe drivers (scripts/torch_probe_floor{,2,3}.py,
   scripts/torch_microbench_rolls.py) at short settings in this process,
   each with the launch counts at 0: each must exit 0, print its lines and
   launch its kernel.  Each probe's time in the kernels line is its
   driver's (PROBE_TIMES, MB_TIME), beside its plain version's at the same
   shape timed here; the SCL floor's share of the SCL kernel's two modes;
13. runs the benchmark entry points at their defaults with the launch counts
   at 0: polardecoding_tpu_torch.bench.main() must print bench.py's keys,
   every leg a positive rate, value the worse of the wave and SCL legs, each
   rate rounded to 0.1 and the two vs_baseline ratios to 1e-4 as bench.py
   rounds them, and launch each leg's kernel; `cli bench` must print its
   preset and its rate rounded to 0.1;
14. BPr (BPr_128, batch 256, 2.0 dB): bpr_decode's u_hat and stage-error
   table E bit-equal with the wave kernel and with the plain iterations,
   and E again from the kernel's segments on a state whose overwritten
   planes hold NaN; with the launch counts at 0, one make_bpr_step step
   (the wave kernel 7 times, the frame channel once, no other kernel;
   counters and E equal to engine="plain"'s) and run_bpr_point to 200 error
   blocks, BLER in [0.08, 0.16] (BPr_128.c: 35/300 = 0.117); times the
   step, a snapshot and the iterations, and profiles the step;
15. the fused SNR sweep: the frame channel with a sigma table bit-equal to
   its plain version on every element (S in {1, 3, 7} over -2 .. 10 dB, B
   in {33, 16384}, N in {128, 1024}; S = 1 also against the scalar
   launch); make_multisnr_step at 1.5, 2.0 and 2.5 dB on BP_1024 (batch
   8192) and SCL_1024_L8_FASTR1 (16384), the launch counts at 0: per-SNR
   counters equal with kernels and plain versions, one frame-channel and
   one decoder launch a step; each step timed and profiled (the sigma
   table's launch is timed beside the scalar one in phase 9's line);
16. run_multiseed on SCL_1024_L8_FASTR1 with two seeds at 2.0 dB to 50 error
   blocks, each seed's record equal to its own run_sweep; run_point on
   BP_1024 (8192) and SCL_1024_L8_FASTR1 (16384) on a budget of 16 steps
   at sync_every 1, 8, 8, 1: wall time, frames counted, frames/s;
17. golden mode, the frames of the C reference at matched seeds, decoded by
   the kernels (rows 1 and 6) through bp_decode_auto, sc_decode_auto,
   scl_decode_auto (L=8) and cascl_decode (L=8), each call with the launch
   counts at 0 (its kernel once, no other): the five C frame dumps of
   tests/golden (N=128, K=64, 1.0 dB, seed 1024, 8 frames; SC, SC_fag,
   SCL, CA-SCL with CRC-6, BP at 100 iterations), whose payload U and
   float64 y the port reproduces bit for bit (utils/rng.golden_noise,
   utils/pn.payload_bits_host, utils/gf2.encode_dense) and whose decoded H
   the kernels give on every frame (BP: on the 5 frames C decoded right);
   then the port's native C engine (native.py, native/golden_ref.c built
   with cc into polardecoding_tpu_torch/_build/) at N=1024, K=512, 2.0 dB,
   seed 1024: its noise equal to golden_noise on 64 frames, and frames
   whose decoded info bits differ from C's: SC 0 of 8192, SCL 0 of 1024,
   CA-SCL (CRC-24) 0 of 512, BP at most 1 of 256, with 696, 9, 1 and 6
   error blocks on both sides; and `cli analyze --tool bpdega` at N=128,
   2.0 dB within 2e-6 of BPDEGA_128.c's BLER.  Its `golden` line gives the
   counts, the launches, the C engine's and golden_noise's host seconds
   and each decode's milliseconds;
18. the reproduction's pins (polardecoding_tpu_torch/reproduce.py): each
   pinned point of the four plans (reproduce.pinned_runs: a preset's first
   point, 1.0 dB, one step of 4096 frames; BP_1024_GA's the fused wave
   engine to its retired frames) through the run half, run_presets, into
   a temporary directory, each with the launch counts at 0 just before:
   (errbit, errblock, frames) equal to reproduce.JAX_CPU_PINS, the JAX
   package's run_sweep on the CPU, and the preset's path kernels
   (reproduce.path_kernels: rows 1, 2 or 6 and the frame channel)
   launched, no other.  N = 128 and 1024, L = 1 to 32, CRC-6 and CRC-24,
   multiplicative and systematic, Lee and Kao wiring, the GA-constructed
   mask; its `reproduce_pins` line gives each point's counts, launches and
   milliseconds.  Then a profile line (as phase 10's) of three steps at
   batch 4096 of SC_1024, BP_1024, CASCL_1024_L8, CASCL_1024_sys_L8,
   CASCL_1024_L32 and BP_1024_GA's fused wave engine: the host's share of
   a reproduction step;
19. the studies (polardecoding_tpu_torch/studies), each through its run
   entry at a short setting (STUDIES_QUICK) into a temporary directory,
   with the launch counts at 0 just before: every entry of STUDY_PINS
   exact (the JAX package's counts on the CPU: bler_r1's exact and rate-1
   arms on SCL_128_L8 at 3.0 dB and bf16_study's float32 and bfloat16 arms
   on BP_128 at 4.0 dB, each one step of 8192 frames; the tie study's
   CASCL_128_L32 record, 8192 frames at 2.0 dB); scl_parity_hw (64 frames,
   L = 8, 16, 32 and the rate-1 flavor) and es_sanity_hw (256 frames)
   bit-equal; bler_wavemc's fused, mc and mc-tf arms at 2.0 dB for one
   chunk at K=32, cadence 2, each within |z| <= 4 of its TPU row;
   precision part 1's C arm one round of 1024-frame chunks; each run's
   kernels launched (STUDIES_QUICK_LAUNCHES), no other, and each wave arm
   only its engine's (mc-tf: the MC wave kernel, its words from the plain
   random_bits).  The tie study launches the SCL kernel alone: its channel
   is the script's constant-sigma form, in plain PyTorch.  Its
   `studies_quick` line gives the pins, each run's launches, milliseconds
   and failed checks;
20. the multi-rank path: two gloo ranks on the one card (NCCL refuses two
   ranks on one card) and a one-rank nccl group, each a subprocess of this
   script (`chip_smoke.py --rank RANK WORLD BACKEND STORE OUT`) with a time
   limit, while this process runs the same paths alone (each path once
   as a warmup, then counted, checked and timed): the global
   counters of two ranks equal one process's at the same global batch on
   BP_1024's frame step (8192, 2 steps), SCL_1024_L8_FASTR1's (16384, 2
   steps), BP_1024_ES's fused wave engine (16384, 4 steps and the drain to
   0) and BP_1024's channel="mc" step (8192, 1 step); every rank launched
   its path's kernels (rows 1, 6, 2, 5 and the frame channel) on its half;
   the nccl rank's run_point on BP_1024 (BLER in [0.020, 0.043]) and `cli
   scale --preset BP_1024` (one record, one card).  Its `multi_rank` line
   gives the compares, each rank's launches, the host time of a gather and
   of a sum of three counters on each backend, and the phase's wall time;
   the `row5` line the MC channel kernel's time beside its 0.0587 ms
   before the first-row argument (PERF.md section 6);
21. ROADMAP queue A's drivers, each in this process at a short setting
   (QUEUE_A_QUICK) into a temporary directory, with the launch counts at 0
   just before: the ab_chkfast study (perf at one rep, both BLER pairs at
   4.0 dB to 10 error blocks or 262,144 frames, every check held), and
   scripts/torch_verify_drive.py --fast in full (VERIFY PASS, each check's
   counts equal to the JAX package's on the CPU, torch_verify_drive.JAX_CPU),
   torch_bench_scl.py --quick, torch_ab_r1.py at N=1024, L=8, B=2048 with
   r1 0 and 4 (both parity lines bit-equal), torch_bench_wave.py --quick
   and torch_ab_wavecheck.py at B=4096 over 4 steps: each exits 0 and
   launches its path's kernels, no other.  Its `queue_a_quick` line gives
   each run's exit, launches, seconds and the verify counts;
22. prints the kernels line (each kernel's launches on its main path, its
   largest difference from the plain version, its time, the plain
   version's, and its bound: the larger of its bytes over the H100 SXM's
   3.35 TB/s, the operations its function needs over 33.5e12 per second,
   the card's rate for float32 adds, compares and selects, and the integer
   ones among them over 16.7e12, its INT32 rate; a probe's launches are
   those of its driver's run; the frame channel's those of the
   SCL_1024_L8 path; golden_launches, studies_launches and
   queue_a_launches those of phases 17, 19 and 21).  A BP kernel's
   operations are counted on
   the timed inputs, by a plain run on them (counted_chks, its line
   chk_counts): a CHK whose table difference is +0 there counts only the
   operations it needs without the table; the frame channel's count the
   branch of log1p and erf_inv each element of its timed inputs takes
   (channel_branches).  Then {"ok": true, "device": {...}} last.

Any failed phase raises and exits non-zero; without a CUDA device, or
without the package beside this file, it exits non-zero before printing a
result.  The port imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import io
import os
import runpy
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from polardecoding_tpu_torch.utils.card import card_line, cuda_ms, queued_ms

# shapes of each phase; the main path's are those of the JAX package's
# bench.py fixed-iteration BP leg
CMP_PRESETS = ("BP_128", "BP_1024")
# BP_1024's decoder and channel on codes of N = 8 and 64 at rate 1/2 (the
# 5G mask): a frame of the BP kernel is one warp there
CMP_SMALL_NS = (8, 64)
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
# the node masks: every node kind of the kernel's schedule at every width,
# in both modes, at these list sizes and batch
NODE_MASK_LISTS = (1, 2, 8, 16, 32)
NODE_MASK_BATCH = 128
NODE_MASK_SMALL_NS = (2, 4, 16)
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
# the SCL kernel's instantiations whose launch shapes phase_shapes prints:
# (N, L, r1), the presets' N=1024 and the generic one (N=128)
SCL_SHAPES = tuple((N, L, r1) for r1 in (0, 4)
                   for N, L in ((1024, 8), (1024, 16), (1024, 32), (128, 8)))
# CASCL_1024_L32's frame step, timed apart (3 frames per SM either way)
L32_PRESET, L32_BATCH = "CASCL_1024_L32", 4096
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
# the MC comparison's waves: their iterations (one of none, one of one), the
# last in drain
MC_CMP_ITERS = (MC_ITERS, 0, 1, MC_ITERS, MC_ITERS)
# the wave kernels' one-wave cases: iterations and fused check cadences
WAVE_CMP_ITERS = (0, 1, WAVE_ITERS)
WAVE_CMP_CHECKS = (0, 1, 4, WAVE_ITERS)
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
# of the fast flavor (ops/chk.chk_fast): a+b, a-b, two abs, the two
# select trees, the delta difference, |a+b| - |a-b|, its half, the final add
CHK_FAST_OPS = 20
# a BP CHK whose table difference is +0 (ops/chk.table_zero) needs fewer:
# min-sum the sign, |a|, |b|, the min and the product (8), ||a| - |b||
# (the smaller of |a+b| and |a-b|, rounded alike) and its compare with the
# last threshold (3), and the add of +0, which makes a -0.0 +0.0 (1); the
# fast flavor a+b, a-b, two abs, their min and its compare, the difference
# and its half (8)
CHK_BP_OPS = {"minsum_lut": (CHK_OPS, 12), "minsum_lut_fast": (CHK_FAST_OPS, 8)}
# PHI (ops/chk.phi_penalties_both): |l| and its 3-level delta tree, shared
# by both penalties; then per penalty a compare, a select, the add to the
# delta and the add to the path metric
PHI_BASE_OPS = 7
PHI_PEN_OPS = 4
# the frame channel's compare: codes, batches, SNRs, frame indices (near
# 2^31 and 2^32; -1 and 2^32 - 1 give the same key) and two point keys
FC_NS = (8, 64, 128, 1024)
SCL_BATCHES = (1, 33, 512, 16384)
FC_SNRS = (-2.0, 0.0, 2.0, 6.0, 10.0)
FC_FRAMES = ((1 << 31) - 3, (1 << 31) - 2, (1 << 31) - 1, 1 << 31,
             (1 << 31) + 1, (1 << 32) - 2, -1, (1 << 32) - 1)
FC_SEEDS = (0, 1024)
# the exhaustive words: every uniform that bits 9..31 give, [8192, 1024]
WORDS_BATCH = 8192
WORDS_SNRS = (-2.0, 6.0)
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
# the frame step's channel (csrc/frame_channel.cu): a two-word threefry
# block, its counter's first word 0 (so its first injection is the key):
# the key added to the second word, 20 mixes of an add, a rotate and a xor,
# and 10 key injections of one add (a key plus its round number is one per
# frame); per frame one block folds the index in, per element one more
# makes the word, whose two halves are xored
THREEFRY2_INT_OPS = 1 + 20 * 3 + 10
# per element besides: integer, the xor and the uniform's shift and or;
# float, the uniform (a subtraction, the product, the add and the clamp),
# t = u * -u, log1p's branch compare, erf_inv's branch compare, its
# argument (one subtraction; the sqrt branch one more), Giles' 8 fmaf, the
# product with u, and the LLR (1 - 2x, the fma, y + y, the divide)
FRAME_INT_OPS = 1 + 2
FRAME_OPS = 4 + 1 + 1 + 1 + 1 + 8 + 1 + 5
# log1p's branch for |t| < sqrt(2) - 1: 6 + 6 fmaf, t^2, t^3, P/Q, the
# product, the fma and the add; else t + 1 and XLA's log (integer: its
# exponent's and mantissa's shift, subtraction and logic op; float: the
# exponent's conversion and 22)
LOG1P_SMALL_OPS = 12 + 6
LOG1P_LOG_OPS, LOG1P_LOG_INT_OPS = 1 + 23, 3
# the probes (TPU kernels 9-12): the floors at the SCL main path's shape
# (N=1024, L=8, B=SCL_BATCH), row 9 with the leaf table and three outputs,
# rows 10 and 11 with two; (row, variant, switches)
PROBE_N, PROBE_L = 1024, 8
FLOOR_CASES = (("probe_floor", "bare", {}), ("probe_floor", "init", {"init": True}),
               ("probe_floor2", "bare", {"ties": False}),
               ("probe_floor2", "noscratch", {"scratch": False, "ties": False}),
               ("probe_floor2", "no_u", {"u_rows": 1, "ties": False}),
               ("probe_floor2", "u_i32", {"u_dtype": torch.int32, "ties": False}),
               ("probe_floor2", "no_in", {"dma_in": False, "ties": False}))
# probe_floor3's body (no scratch, two outputs), its burst and graph sizes
FLOOR3 = {"scratch": False, "ties": False}
FLOOR3_BURST, FLOOR3_GRAPH = 10, 20
# the drivers' other batches, at which rows 9-11's bare bodies are compared
FLOOR_BATCHES = (512, 2048, 8192, 65536)
PROBE_REPS = 10
# the patterns (kind, L, rows) the driver runs, at 7 iterations, where the
# values are still far from 0, on one tile and on 8 per SM
MB_CASES = (("gather", 8, 1), ("gather", 32, 1), ("gather_rows", 8, 8),
            ("gather_rows", 8, 32), ("gather_rows", 8, 128), ("lut", 8, 8),
            ("lut", 8, 32), ("rank", 8, 1), ("rank", 32, 1), ("chk", 8, 8),
            ("chk", 8, 64))
MB_CMP_ITERS = 7
MB_TIME_ITERS = 1000
# the four probe drivers at short settings: (kernel, script, argv)
PROBE_RUNS = (("probe_floor", "torch_probe_floor.py",
               [str(PROBE_N), str(PROBE_L), str(SCL_BATCH), "20", "3"]),
              ("probe_floor2", "torch_probe_floor2.py", ["20", "3"]),
              ("probe_floor3", "torch_probe_floor3.py", ["20", "3"]),
              ("microbench_rolls", "torch_microbench_rolls.py",
               ["--iters", str(MB_TIME_ITERS)]))
# each floor's time in the kernels line, per launch in a CUDA graph, from its
# driver's line: {kernel: (the line's fields, its time's key, batch, switches)}
PROBE_TIMES = {
    "probe_floor": ({"variant": "bare", "B": SCL_BATCH}, "graph_ms_per_call",
                    SCL_BATCH, {}),
    "probe_floor2": ({"variant": "bare", "blocks": 8192}, "graph_ms_per_call",
                     8192, {"ties": False}),
    "probe_floor3": ({"variant": "C64_scan20"}, "ms_per_inner_call", 8192,
                     FLOOR3)}
# the patterns' time: gather_rows on 8 rows at L=8, 8 tiles per SM
MB_TIME = ("gather_rows", 8, 8)
# the fused sweep's frame channel: a sigma table of S entries over SNRs
# spread from -2 to 10 dB, frame i at sigmas[i % S]; and its timing beside
# the scalar launch's (S = 3, the fused sweep's)
SIGMA_TABLE_SIZES = (1, 3, 7)
SIGMA_TABLE_BATCHES = (33, 16384)
SIGMA_TABLE_NS = (128, 1024)
SIGMA_TABLE_SPAN = (-2.0, 10.0)
# BPr: BPr_128 at the C reference's batch (cli bpr's default); BPr_128.c gave
# 35/300 = 0.117 at 2.0 dB (tests/golden/bpr_128_snr2.txt), BP_128 0.1127
# (BASELINE.md:28); its 90 iterations and checkpoints (3, 6, 10, 20, 40, 80)
# are 7 segments of the wave kernel: 3, 3, 4, 10, 20, 40 and 10
BPR_PRESET = "BPr_128"
BPR_BATCH = 256
BPR_ERROR_BLOCKS = 200
BPR_BLER_RANGE = (0.08, 0.16)
BPR_WAVE_LAUNCHES = 7
# the fused SNR sweep: the frame-step legs' presets and batches at three SNRs
FUSED_SNRS = (1.5, 2.0, 2.5)
FUSED_CASES = (("BP_1024", MAIN_BATCH, "bp_decode"),
               ("SCL_1024_L8_FASTR1", 16384, "scl_decode_r1"))
# multi-seed: two seeds of the FASTR1 leg, each its own run_sweep too
MULTISEED_PRESET = "SCL_1024_L8_FASTR1"
MULTISEED_SEEDS = (1024, 2048)
MULTISEED_ERROR_BLOCKS = 50
# run_point's chunked reads: a fixed budget of 16 steps (no error-block
# stop), sync_every 1 and 8 in turns
SYNC_CASES = (("BP_1024", MAIN_BATCH), ("SCL_1024_L8_FASTR1", 16384))
SYNC_STEPS = 16
SYNC_TURNS = (1, 8, 8, 1)
# the multi-rank phase: two gloo ranks on the one card against one process
# at the same global batch; (label, preset, global batch, steps, options)
MR_WORLD = 2
MR_CASES = (("BP_1024 frame step", "BP_1024", MAIN_BATCH, 2, {}),
            ("SCL_1024_L8_FASTR1 frame step", "SCL_1024_L8_FASTR1", SCL_BATCH,
             2, {}),
            ("BP_1024_ES fused wave engine", WAVE_PRESET, WAVE_BATCH, 4,
             {"wave_iters": WAVE_ITERS}),
            ("BP_1024 frame step channel=mc", "BP_1024", MC_CHANNEL_BATCH, 1,
             {"channel": "mc"}))
# each case's kernels, launched on every rank: (kernel, launches a step)
MR_KERNELS = {"BP_1024 frame step": (("bp_decode", 1), ("frame_channel", 1)),
              "SCL_1024_L8_FASTR1 frame step": (("scl_decode_r1", 1),
                                                ("frame_channel", 1)),
              "BP_1024_ES fused wave engine": (("bp_wave_fused", None),
                                               ("frame_channel", 1)),
              "BP_1024 frame step channel=mc": (("mc_channel", 1),
                                                ("bp_decode", 1))}
MR_TIMEOUT_S = 300  # a rank's whole run, and any collective's wait
MR_COLLECTIVE_REPS = 200
# a first row of the MC channel whose counters pass 2^32 (N = 1024)
MC_WRAP_ROW = (1 << 22) - MC_CHANNEL_BATCH // 2
# the MC channel kernel's time before its first-row argument (PERF.md
# section 6)
ROW5_BEFORE_MS = 0.0587
# the keys of the JAX package's bench.py line (bench.py:266-289)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "bp_1024_wave_fps",
              "wave_preset", "wave_engine", "wave_itermax",
              "bp_1024_fixed100_fps", "scl_preset", "scl_fps",
              "scl_1024_l8_fps", "vs_baseline_fixed_iters"}


# the reproduction's presets whose steps are profiled at its batch, 4096:
# its five heaviest (SC_1024, the most frames; BP_1024, CASCL_1024_L8, its
# systematic CRC-24 flavor and L=32) and the wave engine (BP_1024_GA)
REPRODUCE_PROFILES = ("SC_1024", "BP_1024", "CASCL_1024_L8", "CASCL_1024_sys_L8",
                      "CASCL_1024_L32", "BP_1024_GA")

# golden mode: the C reference's frame dumps (N=128, K=64, 1.0 dB, seed
# 1024, 8 frames each) and the port's native C engine (native/golden_ref.c)
# at N=1024, K=512, 2.0 dB, seed 1024, on the reference's own noise stream
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
GOLDEN_SEED = 1024
GOLDEN_LIST = 8
GOLDEN_BP_ITERS = 100
# (decoder, fixture file); CA-SCL's CRC is CRC-6 at N=128
GOLDEN_FIXTURES = (("sc", "sc128_frames.txt"), ("sc_fag", "sc_128_fag_frames.txt"),
                   ("scl", "scl_128_frames.txt"),
                   ("cascl", "cascl_128_frames.txt"), ("bp", "bp_128_frames.txt"))
GOLDEN_FIXTURE_CODE = (128, 64, 1.0)
GOLDEN_CODE = (1024, 512, 2.0)
# (decoder, frames, differing frames allowed, error blocks of C and card):
# the counts of the plain versions on the CPU against the C engine; BP may
# steer one non-converged (chaotic) frame elsewhere.  CRC-24 at N=1024
GOLDEN_CASES = (("sc", 8192, 0, 696), ("scl", 1024, 0, 9),
                ("cascl", 512, 0, 1), ("bp", 256, 1, 6))
GOLDEN_NOISE_FRAMES = 64
# cli analyze's BPDEGA at N=128, K=64, 2.0 dB against BPDEGA_128.c's output
GOLDEN_DEGA_SNR = 2.0
GOLDEN_DEGA_TOL = 2e-6

# the studies' quick phase (polardecoding_tpu_torch.studies): each study's
# run entry at a short setting, in the order of studies.STUDIES.  bler_r1
# and bf16_study one step of their scripts' batch, 8192 (the STUDY_PINS
# steps; part 1's C arm one round of 1024-frame chunks), the tie study in
# full (its CPU record is a pin), scl_parity_hw and es_sanity_hw on
# 64 and 256 frames, bler_wavemc's three arms at 2.0 dB for one chunk at
# the TPU run's settings (K=32, cadence 2)
STUDIES_QUICK = {
    "bler_r1": dict(cases=[("SCL_128_L8", 3.0, 8192)], error_blocks=1),
    "bler_wavemc": dict(snrs=[2.0], error_blocks=1, mc_k=MC_ITERS,
                        mc_cadence=MC_CADENCE),
    "scl_parity_hw": dict(frames=64, flavors=True),
    "es_sanity_hw": dict(frames=256),
    "tie_impact_study": {},
    "bf16_study": dict(blocks=1, points=[("BP_128", 4.0, 8192, 8192)],
                       part1=[("BP_128", 4.0, 8192, 8192),
                              ("SC_128", 4.0, 8192, 8192)], c_chunk=1024)}
# the kernels each quick run launches on the card, with their counts where
# the run fixes them (None: any positive count); each wave arm's line
# launches only its engine's kernels
STUDIES_QUICK_LAUNCHES = {
    "bler_r1": {"scl_decode": 1, "scl_decode_r1": 1, "frame_channel": 2},
    "bler_wavemc": {"bp_wave_fused": None, "frame_channel": None,
                    "bp_wave_mc": None},
    "scl_parity_hw": {"scl_decode": 6, "scl_decode_r1": 1, "frame_channel": 2},
    "es_sanity_hw": {"bp_decode": 2, "frame_channel": 2},
    "tie_impact_study": {"scl_decode": 16},
    "bf16_study": {"bp_decode": 2, "scl_decode": 1, "frame_channel": 3}}
STUDIES_WAVE_KERNELS = {"fused": {"bp_wave_fused", "frame_channel"},
                        "mc": {"bp_wave_mc"}, "mc-tf": {"bp_wave_mc"}}
# phase 21: the ab_chkfast study's short run (studies.run_study keywords),
# then each queue A driver's (script, argv), each with the kernels it
# launches, no other
QUEUE_A_CHKFAST = dict(perf=True, bler=True, error_blocks=10,
                       max_frames=262_144, reps=1)
QUEUE_A_QUICK = (
    ("torch_verify_drive.py", ["--fast"],
     {"bp_decode", "scl_decode", "frame_channel"}),
    ("torch_bench_scl.py", ["--quick"], {"scl_decode", "frame_channel"}),
    ("torch_ab_r1.py", ["1024", "8", "2048", "4", "1", "--r1s", "0,4"],
     {"scl_decode", "scl_decode_r1"}),
    ("torch_bench_wave.py", ["--quick"],
     {"bp_decode", "bp_wave_fused", "frame_channel"}),
    ("torch_ab_wavecheck.py", ["4096", "4", "1"],
     {"bp_wave_fused", "frame_channel"}))
QUEUE_A_CHKFAST_KERNELS = {"bp_decode", "bp_wave_fused", "frame_channel"}


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
                                             frame_channel_kernel,
                                             microbench_kernel, probe_kernel,
                                             scl_kernel)

    return {"bp_decode": (bp_kernel, "LAUNCHES", None),
            "scl_decode": (scl_kernel, "LAUNCHES", None),
            "scl_decode_r1": (scl_kernel, "LAUNCHES_R1", None),
            "bp_wave_fused": (bp_wave_kernel, "LAUNCHES", "bp_wave_fused"),
            "bp_wave": (bp_wave_kernel, "LAUNCHES", "bp_wave"),
            "bp_wave_mc": (bp_wave_mc_kernel, "LAUNCHES", None),
            "mc_channel": (channel_kernel, "LAUNCHES", None),
            "frame_channel": (frame_channel_kernel, "LAUNCHES", None),
            # one floor kernel serves the three floor probes; each probe
            # path is driven alone, so the one count reads each
            "probe_floor": (probe_kernel, "LAUNCHES", None),
            "probe_floor2": (probe_kernel, "LAUNCHES", None),
            "probe_floor3": (probe_kernel, "LAUNCHES", None),
            "microbench_rolls": (microbench_kernel, "LAUNCHES", None)}


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


def phase_shapes():
    """Each live-row BP kernel's launch shape at N=1024 and 128: the decode
    and MC kernels in their main paths' flavors, the wave kernels in every
    flavor (the fused one with check_every 0 and 4, two instances): shared
    memory per frame, frames per SM from the occupancy query, registers and
    local memory per thread (spills and stack frames).  No local memory at
    either N (N=128 launches the instances for n at run time); at N=1024 3
    frames per SM and at most 74,752 bytes a frame.  Then the SCL kernel's
    (SCL_SHAPES): no local memory in any instantiation, and exact mode at
    N=1024, L=8 (the stage n-1 row in registers) 13 frames per SM."""
    from polardecoding_tpu_torch.ops.bp_kernel import FLAVORS, bp_decode_shape
    from polardecoding_tpu_torch.ops.bp_wave_kernel import bp_wave_shape
    from polardecoding_tpu_torch.ops.bp_wave_mc_kernel import bp_wave_mc_shape
    from polardecoding_tpu_torch.ops.probe_kernel import scl_shape

    for N in (1024, 128):
        shapes = [("bp_decode", bp_decode_shape(N)),
                  ("bp_decode early stop", bp_decode_shape(N, early_stop_every=4)),
                  ("bp_wave_mc", bp_wave_mc_shape(N, "minsum_lut_fast"))]
        for flavor in FLAVORS:
            shapes.append((f"bp_wave {flavor}", bp_wave_shape(N, flavor)))
            for ce in (0, 4):
                shapes.append((f"bp_wave_fused {flavor} check_every={ce}",
                               bp_wave_shape(N, flavor, fused=True,
                                             check_every=ce)))
        for name, shape in shapes:
            emit({"kernel_shape": dict(kernel=name, N=N, **shape)})
            check(shape["local_bytes"] == 0, f"{name} at N={N}: {shape}")
            if N == 1024:
                check(shape["frames_per_sm"] == 3
                      and shape["smem_bytes"] <= 74752,
                      f"{name} at N=1024: {shape}")
    for N, L, r1 in SCL_SHAPES:
        name = "scl_decode_r1" if r1 else "scl_decode"
        shape = scl_shape(SCL_BATCH, N, L, *((L - 1, max(1, N // 32)) if r1
                                             else (0, 0)))
        emit({"kernel_shape": dict(kernel=name, N=N, L=L, **shape)})
        check(shape["local_bytes"] == 0, f"{name} at N={N}, L={L}: {shape}")
        if (N, L, r1) == (1024, 8, 0):
            check(shape["top_regs"] and shape["frames_per_sm"] == 13,
                  f"{name} at N=1024, L=8: {shape}")


def llr_frames(name, batch, snr_db, device, seed=7, N=None):
    """Channel LLRs of frames 0..batch-1 of a preset at snr_db from the
    port's own pipeline (CRC included; the frame channel's kernel on the
    card, its plain version on the CPU), with the code's frozen mask and
    the true u; with N, of the preset's code cut to length N at rate
    1/2."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, frame_llr,
                                                     prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu, scatter_info
    from polardecoding_tpu_torch.parallel.harness import (_crc_encoder,
                                                          code_tables,
                                                          payload_from_index)

    code = preset(name).code
    if N is not None:
        code = dataclasses.replace(code, N=N, K=N // 2)
    tables = code_tables(code, device)
    fidx = torch.arange(batch, device=device)
    w = _crc_encoder(code, device)(payload_from_index(fidx, tables.pn, code.K))
    key = fold_in(prng_key(seed, device), int(round(snr_db * 100)))
    llr = frame_llr(encode_info_mxu(w, tables.g_rows), key, fidx,
                    sigma_from_ebn0_db(snr_db))
    return llr, tables.frozen, scatter_info(w, tables.info_set, code.N)


def exhaustive_words(device):
    """[WORDS_BATCH, 1024] 32-bit words (int64) whose bits 9..31 run over
    all 2^23 values, bits 0..8 zero: every uniform of either channel."""
    return (torch.arange(1 << 23, dtype=torch.int64, device=device) << 9
            ).reshape(WORDS_BATCH, -1)


def phase_frame_channel_compare():
    """The frame channel's kernel against its plain version on the card,
    bit for bit on every element: threefry words for N in FC_NS, B in
    SCL_BATCHES, at FC_SNRS, with frame indices 0.. and FC_FRAMES, under two
    point keys (frames -1 and 2^32 - 1 given one codeword must give one
    LLR row); then the exhaustive words (bits mode) with x = 0 and 1 at
    WORDS_SNRS, and the MC channel (row 5) on the same words.  Returns
    {kernel: largest |kernel - plain|} (0 when bit-equal)."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (awgn_llr_from_words,
                                                     fold_in, frame_llr,
                                                     prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.channel_kernel import mc_channel
    from polardecoding_tpu_torch.ops.frame_channel_kernel import frame_llr_cuda
    from polardecoding_tpu_torch.parallel.harness import _mc_mode_tables

    worst = {"frame_channel": 0.0, "mc_channel": 0.0}

    def record(kernel, got, want, **rec):
        equal, err = frames_equal([(got, want, 0)], got.shape[0])
        rec = dict(rec, kernel=kernel, frames=got.shape[0], frames_equal=equal,
                   max_abs_err=err)
        emit({"frame_channel_compare": rec})
        check(equal == got.shape[0] and err == 0, f"kernel != plain: {rec}")
        worst[kernel] = max(worst[kernel], err)

    gen = torch.Generator(device=DEVICE).manual_seed(10)
    edge = torch.tensor(FC_FRAMES, device=DEVICE)
    for N in FC_NS:
        for B in SCL_BATCHES:
            x = torch.randint(0, 2, (B, N), generator=gen, device=DEVICE
                              ).to(torch.float32)
            fidx = torch.arange(B, device=DEVICE)
            fidx[-len(edge):] = edge[-B:]  # B = 1: 2^32 - 1 alone
            if B > 1:  # frames -1 and 2^32 - 1 on one codeword
                x[-2] = x[-1]
            for seed in FC_SEEDS:
                key = fold_in(prng_key(seed, DEVICE), 200)
                for snr in FC_SNRS:
                    sigma = sigma_from_ebn0_db(snr)
                    got = frame_llr(x, key, fidx, sigma)
                    want = frame_llr(x, key, fidx, sigma, engine="plain")
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(want).all()),
                          "non-finite frame channel LLRs")
                    if B > 1:
                        check(bool(_same(got[-2], got[-1]).all()),
                              "frames -1 and 2^32 - 1 differ")
                    record("frame_channel", got, want, N=N, B=B, seed=seed,
                           snr_db=snr)
    words = exhaustive_words(DEVICE)
    for snr in WORDS_SNRS:
        sigma = sigma_from_ebn0_db(snr)
        for bit in (0.0, 1.0):
            x = torch.full(words.shape, bit, device=DEVICE)
            got = frame_llr_cuda(x, None, None, sigma, bits=words)
            want = awgn_llr_from_words(x, words, sigma)
            torch.cuda.synchronize()
            record("frame_channel", got, want, words="all 2^23 uniforms",
                   x=bit, snr_db=snr)
        p = preset(MAIN_PRESET)
        _, xtab = _mc_mode_tables(p.code, DEVICE)
        m = (torch.arange(words.shape[0], device=DEVICE) * (p.code.K % 63)) % 63
        args = (m, xtab, sigma, (1, 2, 3, 4), words)
        got = mc_channel(*args, gen_bits=False)
        want = mc_channel(*args, gen_bits=False, engine="plain")
        torch.cuda.synchronize()
        record("mc_channel", got, want, words="all 2^23 uniforms", snr_db=snr)
    return worst


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
    codes = ([(name, None) for name in CMP_PRESETS]
             + [(MAIN_PRESET, N) for N in CMP_SMALL_NS])
    for name, N in codes:
        for snr in CMP_SNRS:
            llr, frozen, u = llr_frames(name, CMP_BATCH, snr, DEVICE, N=N)
            check(bool(torch.isfinite(llr).all()), f"{name}: non-finite LLRs")
            cases = [(f, es) for f in ("minsum_lut", "minsum_lut_fast")
                     for es in (0, 4)] + [("spa", 0)]
            for flavor, es in cases:
                out = torch.full(llr.shape, 90, dtype=torch.int8, device=DEVICE)
                got = bp_decode_cuda(llr, frozen, iters=100, flavor=flavor,
                                     early_stop_every=es, out=out)
                want = bp_decode(llr, frozen, iters=100, flavor=flavor,
                                 early_stop_every=es)
                torch.cuda.synchronize()
                check(got is out and got.shape == want.shape,
                      f"kernel output {got.dtype} {tuple(got.shape)}")
                equal = (got == want).all(dim=1)
                correct = (want == u).all(dim=1)
                rec = {"compare": {"preset": name, "N": llr.shape[1],
                                   "snr_db": snr,
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

    # the frame channel's kernel on the card against its plain version on
    # the CPU, bit for bit
    llr_gpu, _, _ = llr_frames(MAIN_PRESET, 64, MAIN_SNR, DEVICE)
    llr_cpu, _, _ = llr_frames(MAIN_PRESET, 64, MAIN_SNR, "cpu")
    same = _same(llr_gpu.cpu(), llr_cpu)
    emit({"channel_gpu_vs_cpu": {
        "frames": 64, "max_abs_diff": float((llr_gpu.cpu() - llr_cpu).abs().max()),
        "equal_share": float(same.float().mean())}})
    check(bool(same.all()), "the frame channel on the card differs from the "
          "plain channel on the CPU")
    return worst


def phase_main(name, batch, error_blocks, bler_range, kernel):
    """Drive one main path with every launch count at 0 just before: four
    make_frame_step steps, then run_point at MAIN_SNR; returns the counts of
    launches of the path's kernel and of the frame channel read just after,
    and checks that each ran once a step and no other kernel was
    launched."""
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
    count, channel = launches(kernel), launches("frame_channel")
    others = {k: launches(k) for k in kernels()
              if k not in (kernel, "frame_channel") and launches(k)}
    emit({"main_path": {"preset": p.name, "batch": batch,
                        "steps": steps, "point": res.to_json(p.code.num_info),
                        "seconds": time.perf_counter() - t0,
                        "kernel": kernel, "launches": count,
                        "frame_channel_launches": channel,
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
    check(channel == MAIN_STEPS + k,
          f"{name}: frame channel launched {channel} times in "
          f"{MAIN_STEPS + k} steps")
    check(not others, f"{name}: other kernels launched: {others}")
    return count, channel


def node_masks():
    """(label, [N] bool mask) that exercise every node kind of the SCL
    kernel's schedule at every width: one R0 of width N (all frozen), one
    REP of width N (only the last bit info), no frozen bit (exact: bit by
    bit; the flavor: one R1 node at the root), two ladders at N=1024 with an
    R0 and a REP node of each width from 512 down to 2 between them
    (ladder_r0 starts with the R0 of width 512, ladder_rep with the REP),
    a second half that is one R0 or REP node of width 512 (the kernel takes
    it as two halves), and seeded random masks at N = 2, 4 and 16."""
    import numpy as np

    def ladder(kind):
        m = []
        for s in range(9, 0, -1):
            blk = [True] * (1 << s)
            if kind == "rep":
                blk[-1] = False
            m += blk
            kind = "r0" if kind == "rep" else "rep"
        return np.array(m + [False, False])

    rng = np.random.default_rng(2026)
    half = rng.random(1024) < 0.5
    half[512:] = True
    half_rep = half.copy()
    half_rep[-1] = False
    out = [("all-frozen", np.ones(1024, bool)),
           ("last-info", np.arange(1024) < 1023),
           ("all-info", np.zeros(1024, bool)),
           ("ladder_r0", ladder("r0")), ("ladder_rep", ladder("rep")),
           ("half_r0", half), ("half_rep", half_rep)]
    out += [(f"random N={N}", rng.random(N) < 0.5) for N in NODE_MASK_SMALL_NS]
    return out


def _scl_out(B, L, N):
    """Output buffers for scl_decode_cuda(out=...) filled with 90, so that a
    store the kernel leaves out shows."""
    return (torch.full((B, L, N), 90, dtype=torch.int8, device=DEVICE),
            torch.full((B, L), 90.0, device=DEVICE),
            torch.full((B,), 90, dtype=torch.int32, device=DEVICE))


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
        got = scl_decode_cuda(llr, frozen, L,
                              out=_scl_out(llr.shape[0], L, llr.shape[1]))
        want = scl_decode(llr, frozen, list_size=L, return_all=True,
                          return_ties=True)
        torch.cuda.synchronize()
        worst, equal = _scl_diff(got, want)
        rec = {"scl_compare": dict(rec, N=llr.shape[1], L=L,
                                   frames=llr.shape[0],
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
    llr = llr[:NODE_MASK_BATCH]
    for label, mask in node_masks():
        N = mask.shape[0]
        for L in NODE_MASK_LISTS:
            compare(llr[:, :N].contiguous(), torch.as_tensor(mask, device=DEVICE),
                    L, preset=f"{label} mask", snr_db=1.0)
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
        got = scl_decode_cuda(llr, frozen, L, r1=r1, wloop=WLOOP,
                              out=_scl_out(llr.shape[0], L, llr.shape[1]))
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
    llr = llr[:NODE_MASK_BATCH]
    for label, mask in node_masks():
        N = mask.shape[0]
        for L in NODE_MASK_LISTS:
            for r1 in R1_CMP_R1:
                compare(llr[:, :N].contiguous(),
                        torch.as_tensor(mask, device=DEVICE), L, r1,
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
    from polardecoding_tpu_torch.ops.channel import (fold_in, frame_llr,
                                                     prng_key,
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
    # the step's stages apart: payload + encode, then the channel (the
    # frame channel's kernel, host time included)
    tables = code_tables(p.code, DEVICE)
    fidx = torch.arange(batch, device=DEVICE)

    def encode():
        return encode_info_mxu(payload_from_index(fidx, tables.pn, p.code.K),
                               tables.g_rows)

    encode_ms, x = cuda_ms(encode, STEP_REPS)
    channel_ms, _ = cuda_ms(lambda: frame_llr(x, key, fidx, sigma), STEP_REPS)
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


def phase_l32_step(card):
    """CASCL_1024_L32's whole frame step at MAIN_SNR, batch L32_BATCH: the
    list-decode kernel at L=32, which keeps 3 frames per SM."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import make_frame_step

    p = preset(L32_PRESET)
    step = make_frame_step(p, L32_BATCH, DEVICE)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    n = iter(range(1, 1 << 30))
    step_ms, _ = cuda_ms(lambda: step(key, next(n) * L32_BATCH, sigma),
                         STEP_REPS)
    emit({"timing": {"card": card, "preset": L32_PRESET, "batch": L32_BATCH,
                     "step_ms": step_ms,
                     "step_fps": L32_BATCH / step_ms * 1e3}})


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


def wave_runner(name, make, batch=None, **kw):
    """run(s): the next step of a wave stepper (make is make_wave_step or
    make_wave_step_mc) at MAIN_SNR with `batch` (default WAVE_BATCH), its
    counters read on the host; run.carry holds the carry."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)

    p = preset(name)
    init, step, _ = make(p, WAVE_BATCH if batch is None else batch,
                         device=DEVICE, **kw)
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

    codes = ([(name, None) for name in CMP_PRESETS]
             + [(MAIN_PRESET, N) for N in CMP_SMALL_NS])
    for name, cut in codes:
        code = preset(name).code
        if cut is not None:
            code = dataclasses.replace(code, N=cut, K=cut // 2)
        N, K = code.N, code.K
        tables = code_tables(code, DEVICE)
        # the planes an iteration writes before it reads them: L[0], R[1..n]
        n = N.bit_length() - 1
        dead = [0] + list(range(n + 2, 2 * n + 2))
        for kernel, ce in (("bp_wave_fused", 0), ("bp_wave_fused", 4),
                           ("bp_wave", 0)):
            state = wave_init_state(torch.zeros(B, N, device=DEVICE),
                                    tables.frozen)
            retire = torch.ones(B, dtype=torch.bool, device=DEVICE)
            for w in range(WAVE_CMP_WAVES):
                llr, _, _ = llr_frames(name, B, MAIN_SNR, DEVICE, seed=100 + w,
                                       N=cut)
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
                record(kernel, {"preset": name, "N": N, "check_every": ce,
                                "wave": w, "retired": int(retire.sum())},
                       *frames_equal(pairs, B), B)

        # one wave from a state three iterations in, every odd slot retired,
        # at 0, 1 and K iterations; at >= 1 the planes that an iteration
        # overwrites hold NaN, which the kernels must not read
        llr0, _, _ = llr_frames(name, B, MAIN_SNR, DEVICE, seed=90, N=cut)
        llr, _, _ = llr_frames(name, B, MAIN_SNR, DEVICE, seed=91, N=cut)
        retire = torch.arange(B, device=DEVICE) % 2 == 1
        for flavor in ("minsum_lut", "minsum_lut_fast"):
            base = bp_wave(wave_init_state(llr0, tables.frozen), 3, flavor,
                           engine="plain")
            for iters in WAVE_CMP_ITERS:
                for kernel, ce in ([("bp_wave", 0)] + [("bp_wave_fused", c)
                                                      for c in WAVE_CMP_CHECKS]):
                    state = base.clone()
                    if iters:
                        state[dead] = float("nan")
                    if kernel == "bp_wave":
                        got = (bp_wave(state.clone(), iters, flavor),)
                        want = (bp_wave(state, iters, flavor, engine="plain"),)
                    else:
                        got = bp_wave_fused(state.clone(), llr, retire, iters,
                                            flavor, check_every=ce)
                        want = bp_wave_fused(state, llr, retire, iters, flavor,
                                             check_every=ce, engine="plain")
                    torch.cuda.synchronize()
                    rec = {"preset": name, "N": N, "flavor": flavor,
                           "iters": iters, "check_every": ce,
                           "sentinel": iters > 0}
                    if kernel == "bp_wave_fused":
                        rec.update(retired=int(retire.sum()),
                                   done=int(want[2].sum()))
                    record(kernel, rec,
                           *frames_equal(list(zip(got, want, (1, 0, 0))), B), B)

        utab, xtab = mc_tables(tables.info_set.cpu().numpy(), K, N, DEVICE)
        kw = dict(flavor="minsum_lut_fast", delta=mc_delta(B, K),
                  spares=MC_SPARES)
        for noise in ("kernel", "words"):
            for cadence in (1, 2):
                state = wave_init_state(torch.zeros(B, N, device=DEVICE),
                                        tables.frozen)
                meta = mc_meta_init(B, N, K, DEVICE)
                for w, iters in enumerate(MC_CMP_ITERS):
                    seeds = (0x13198A2E, 0x03707344, 0x13198A2E ^ 0x03707344, w)
                    bits = None if noise == "kernel" else torch.stack(
                        [counter_bits(7, 8, w * MC_SPARES + g, B, N, DEVICE)
                         for g in range(MC_SPARES)])
                    drain = w == len(MC_CMP_ITERS) - 1
                    if iters:
                        state[dead] = float("nan")
                    got = bp_wave_mc(state.clone(), meta.clone(), utab, xtab,
                                     sigma, seeds, bits, gen_bits=bits is None,
                                     iters=iters, drain=drain, cadence=cadence,
                                     **kw)
                    state, meta, stats = bp_wave_mc(
                        state, meta, utab, xtab, sigma, seeds, bits,
                        gen_bits=bits is None, iters=iters, drain=drain,
                        cadence=cadence, engine="plain", **kw)
                    torch.cuda.synchronize()
                    pairs = [(got[0], state, 1), (got[1], meta, 1),
                             (got[2], stats, 0)]
                    record("bp_wave_mc", {"preset": name, "N": N,
                                          "noise": noise, "cadence": cadence,
                                          "wave": w, "iters": iters,
                                          "drain": drain, "sentinel": iters > 0,
                                          "stats": stats.sum(dim=0).tolist()},
                           *frames_equal(pairs, B), B)

    p = preset(MAIN_PRESET)
    _, xtab = _mc_mode_tables(p.code, DEVICE)
    B = MC_CHANNEL_BATCH
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    k0, k1 = key.tolist()
    m = (torch.arange(B, device=DEVICE) * (p.code.K % 63)) % 63
    # a first row other than 0: a rank's slice of a global batch, the last
    # one with counters past 2^32
    for noise, row0 in (("kernel", 0), ("words", 0), ("kernel", B // 2),
                        ("kernel", MC_WRAP_ROW)):
        bits = (None if noise == "kernel"
                else counter_bits(k1, k0, 0, B, p.code.N, DEVICE))
        args = (m, xtab, sigma, (k0, k1, k0 ^ k1, B), bits)
        got = mc_channel(*args, gen_bits=bits is None, row0=row0)
        want = mc_channel(*args, gen_bits=bits is None, engine="plain",
                          row0=row0)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(want).all()), "non-finite MC channel LLRs")
        record("mc_channel", {"preset": MAIN_PRESET, "noise": noise,
                              "row0": row0},
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


@contextlib.contextmanager
def counted_steppers():
    """Within the block, harness.make_wave_step and make_wave_step_mc hand
    out steppers whose init, step and drain calls are counted.  Yields
    {"engine": "fused", "unfused" or "mc", "init", "step", "drain"}, the
    counts of the last stepper made."""
    from polardecoding_tpu_torch.parallel import harness

    made = {"engine": None, "init": 0, "step": 0, "drain": 0}
    makers = {name: getattr(harness, name)
              for name in ("make_wave_step", "make_wave_step_mc")}

    def counted(label, fn):
        def call(*args, **kw):
            made[label] += 1
            return fn(*args, **kw)
        return call

    def wrap(name):
        def make(*args, **kw):
            made["engine"] = ("mc" if name == "make_wave_step_mc" else
                              "fused" if kw.get("fused", True) else "unfused")
            return tuple(counted(label, fn) for label, fn in
                         zip(("init", "step", "drain"), makers[name](*args, **kw)))
        return make

    for name in makers:
        setattr(harness, name, wrap(name))
    try:
        yield made
    finally:
        for name, fn in makers.items():
            setattr(harness, name, fn)


def phase_wave_main(label, run, kernel):
    """Drive one wave path with every launch count at 0 just before: run()
    returns its PointResult, whose BLER must lie in BLER_RANGE; returns the
    counts of the path's kernel's launches and of the frame channel's read
    just after.  The frame channel draws a step's fresh LLRs: once a step
    on the fused engine, once a step and at init on the unfused one, never
    on the MC engine.  Each drain of the fused engine, and no other call,
    gives the wave kernel a live mask (bp_wave_kernel.MASKED)."""
    from polardecoding_tpu_torch.ops.bp_wave_kernel import MASKED

    reset_counts()
    masked = MASKED["bp_wave_fused"]
    t0 = time.perf_counter()
    with counted_steppers() as made:
        res = run()
    torch.cuda.synchronize()
    counts = {kernel: launches(kernel), "frame_channel": launches("frame_channel")}
    masked = MASKED["bp_wave_fused"] - masked
    want = {"fused": made["step"], "unfused": made["step"] + made["init"],
            "mc": 0}[made["engine"]]
    from polardecoding_tpu_torch.configs import preset

    emit({"main_path": {"path": label, "batch": WAVE_BATCH,
                        "point": res.to_json(preset(res.preset).code.num_info),
                        "seconds": time.perf_counter() - t0,
                        "launches": counts, "masked": masked,
                        "stepper": made}})
    want_masked = made["drain"] if made["engine"] == "fused" else 0
    check(masked == want_masked,
          f"{label}: {masked} masked wave launches, want {want_masked}")
    check(res.errblock >= WAVE_ERROR_BLOCKS, f"{label} stopped early: {res}")
    check(BLER_RANGE[0] <= res.bler <= BLER_RANGE[1],
          f"{label}: BLER {res.bler} at {MAIN_SNR} dB outside {BLER_RANGE}")
    check(counts[kernel] > 0, f"{label}: launches {counts}")
    check(counts["frame_channel"] == want,
          f"{label}: frame channel launched {counts['frame_channel']} times, "
          f"want {want} ({made})")
    return counts[kernel], counts["frame_channel"]


def phase_mc_channel_main():
    """One make_frame_step step with channel="mc" at MC_CHANNEL_BATCH, the
    launch counts at 0 just before; returns the MC channel's launches (one;
    the frame channel's none)."""
    reset_counts()
    counters = frame_step_runner(MAIN_PRESET, MC_CHANNEL_BATCH, channel="mc")(0)
    torch.cuda.synchronize()
    count = launches("mc_channel")
    emit({"main_path": {"path": f"{MAIN_PRESET} make_frame_step channel=mc",
                        "batch": MC_CHANNEL_BATCH, "steps": [counters],
                        "launches": {"mc_channel": count,
                                     "bp_decode": launches("bp_decode"),
                                     "frame_channel": launches("frame_channel")}}})
    eb, ebl, ties = counters
    check(0 < ebl < MC_CHANNEL_BATCH and eb >= ebl and ties == 0,
          f"implausible MC-channel step counters {counters}")
    check(count == 1, f"mc_channel launched {count} times")
    check(launches("frame_channel") == 0, "the MC step launched the frame channel")
    return count


def hold_and_time(card, name, B, run, axes, flavor=None, timer=cuda_ms,
                  **info):
    """run(engine, fresh) computes one kernel's function at its bench shape,
    with the kernel (engine="auto") or the plain version ("plain"), on
    copies of the inputs the kernel updates in place when fresh.  Holds the
    two bit-equal on every frame (axes: each output's frame axis), times
    them in turns (plain, kernel, kernel, plain; the plain version once per
    turn, the kernel by `timer`) and emits a wave_timing line; returns
    (kernel ms, plain ms, largest |kernel - plain|, the plain BP's CHKs of
    `flavor` counted by counted_chks, or None without)."""
    got = run("auto", True)
    with (counted_chks(flavor) if flavor else contextlib.nullcontext()) as chks:
        want = run("plain", False)
    torch.cuda.synchronize()
    equal, err = frames_equal(list(zip(got, want, axes)), B)
    del got, want
    check(equal == B and err == 0, f"{name} != plain at B={B}: {equal}")
    k, pl = [], []
    for engine, acc, reps in (("plain", pl, 1), ("auto", k, WAVE_KERNEL_REPS),
                              ("auto", k, WAVE_KERNEL_REPS), ("plain", pl, 1)):
        time_it = timer if engine == "auto" else cuda_ms
        acc.append(time_it(lambda: run(engine, False), reps)[0])
    emit({"wave_timing": dict(card=card, kernel=name, batch=B, kernel_ms=k,
                              plain_ms=pl, frames_equal=equal, **info)})
    return statistics.mean(k), statistics.mean(pl), err, chks


def phase_k8_wave_timing(card):
    """The two K=8 wave kernels and their plain versions at the bench shape
    (one wave of WAVE_PRESET's state after two steps, B=WAVE_BATCH) through
    hold_and_time, and the fused ES step split into kernel and channel.
    Returns ({kernel: hold_and_time's result}, {kernel: wave_work of the
    very inputs timed})."""
    from polardecoding_tpu_torch.models.bp import bp_wave, bp_wave_fused
    from polardecoding_tpu_torch.ops.channel import frame_llr
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu
    from polardecoding_tpu_torch.parallel.harness import (code_tables,
                                                          make_wave_step,
                                                          payload_from_index)

    out, work = {}, {}
    run = wave_runner(WAVE_PRESET, make_wave_step, wave_iters=WAVE_ITERS)
    for _ in range(2):
        run()
    p, key, sigma = run.preset, run.key, run.sigma
    tables = code_tables(p.code, DEVICE)
    state, fidx, retire = run.carry[0], run.carry[1], run.carry[4]
    _, B, N = state.shape

    def channel():
        x = encode_info_mxu(payload_from_index(fidx, tables.pn, p.code.K),
                            tables.g_rows)
        return frame_llr(x, key, fidx, sigma)

    channel_ms, llr = cuda_ms(channel, STEP_REPS)
    out["bp_wave_fused"] = hold_and_time(
        card, "bp_wave_fused", B,
        lambda e, f: bp_wave_fused(_own(state, f), llr, retire, WAVE_ITERS,
                                   engine=e),
        (1, 0, 0), flavor=p.decoder.bp_flavor, preset=WAVE_PRESET,
        wave_iters=WAVE_ITERS, retired=int(retire.sum()))
    work["bp_wave_fused"] = wave_work(B, N, True, out["bp_wave_fused"][3],
                                      retire)
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
        lambda e, f: (bp_wave(_own(state, f), WAVE_ITERS, engine=e),), (1,),
        flavor=p.decoder.bp_flavor, preset=WAVE_PRESET, wave_iters=WAVE_ITERS)
    work["bp_wave"] = wave_work(B, N, False, out["bp_wave"][3])
    return out, work


def _own(t, fresh):
    return t.clone() if fresh else t


def phase_wave_timing(card):
    """Each wave kernel and its plain version at the bench shape (one wave,
    B=16384, K=8 fused and unfused by phase_k8_wave_timing, K=32 MC; the MC
    channel at B=8192) through hold_and_time; retired frames/s of the fused
    and MC wave paths over WAVE_CHUNK steps after a chunk of warmup.
    Returns ({kernel: (ms, plain ms, largest |kernel - plain|, the plain
    BP's CHK counts or None)}, the K=8 kernels' wave_work)."""
    from polardecoding_tpu_torch.models.bp import bp_wave_mc, mc_delta, mc_tables
    from polardecoding_tpu_torch.ops.channel_kernel import mc_channel
    from polardecoding_tpu_torch.parallel.harness import (_mc_mode_tables,
                                                          code_tables,
                                                          make_wave_step,
                                                          make_wave_step_mc)

    out, k8_work = phase_k8_wave_timing(card)
    B = WAVE_BATCH
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
    p, key, sigma = r.preset, r.key, r.sigma
    tabs = mc_tables(code_tables(p.code, DEVICE).info_set.cpu().numpy(),
                     p.code.K, p.code.N, DEVICE)
    kw = dict(iters=MC_ITERS, flavor=p.decoder.bp_flavor,
              delta=mc_delta(B, p.code.K), spares=MC_SPARES, cadence=MC_CADENCE)
    out["bp_wave_mc"] = hold_and_time(
        card, "bp_wave_mc", B,
        lambda e, f: bp_wave_mc(_own(state, f), _own(meta, f), *tabs, sigma,
                                (k0, k1, k0 ^ k1, stepc), engine=e, **kw),
        (1, 1, 0), flavor=p.decoder.bp_flavor, preset=MC_PRESET,
        wave_iters=MC_ITERS, cadence=MC_CADENCE, spares=MC_SPARES)
    del state, meta, r

    _, xtab = _mc_mode_tables(p.code, DEVICE)
    Bc = MC_CHANNEL_BATCH
    m = (torch.arange(Bc, device=DEVICE) * (p.code.K % 63)) % 63
    k0, k1 = key.tolist()
    out["mc_channel"] = hold_and_time(
        card, "mc_channel", Bc,
        lambda e, f: (mc_channel(m, xtab, sigma, (k0, k1, k0 ^ k1, 0), engine=e),),
        (0,), timer=queued_ms)
    return out, k8_work


def phase_frame_channel_timing(card):
    """The frame channel's kernel and its plain version at the SCL paths'
    shape (SCL_PRESET's codewords of frames 0..SCL_BATCH-1 under its key at
    MAIN_SNR) in turns (plain, kernel, kernel, plain; the kernel by
    queued_ms, the host's enqueue hidden), held bit-equal there; the
    branches of log1p and erf_inv that these inputs take (channel_branches)
    for the bound.  Returns (kernel ms, plain ms, largest |kernel - plain|,
    frame_channel_work)."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, frame_keys,
                                                     frame_llr, prng_key,
                                                     random_bits,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.ops.encode import encode_info_mxu
    from polardecoding_tpu_torch.parallel.harness import (_crc_encoder,
                                                          code_tables,
                                                          payload_from_index)

    p = preset(SCL_PRESET)
    N = p.code.N
    tables = code_tables(p.code, DEVICE)
    fidx = torch.arange(SCL_BATCH, device=DEVICE)
    x = encode_info_mxu(_crc_encoder(p.code, DEVICE)(payload_from_index(
        fidx, tables.pn, p.code.K)), tables.g_rows)
    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    # the fused sweep's launch: a sigma table of its three SNRs
    table = torch.tensor([sigma_from_ebn0_db(v) for v in FUSED_SNRS],
                         dtype=torch.float32, device=DEVICE)
    outs, k, pl, tab = {}, [], [], []
    for engine, acc, timer, reps, sig in (
            ("plain", pl, cuda_ms, 1, sigma),
            ("auto", k, queued_ms, WAVE_KERNEL_REPS, sigma),
            ("table", tab, queued_ms, WAVE_KERNEL_REPS, table),
            ("table", tab, queued_ms, WAVE_KERNEL_REPS, table),
            ("auto", k, queued_ms, WAVE_KERNEL_REPS, sigma),
            ("plain", pl, cuda_ms, 1, sigma)):
        ms, out = timer(lambda: frame_llr(x, key, fidx, sig, engine.replace(
            "table", "auto")), reps)
        acc.append(ms)
        outs.setdefault(engine, out)
    equal, err = frames_equal([(outs["auto"], outs["plain"], 0)], SCL_BATCH)
    check(equal == SCL_BATCH and err == 0,
          f"frame channel != plain at B={SCL_BATCH}: {equal}")
    small, ge5 = channel_branches(random_bits(frame_keys(key, fidx), N))
    emit({"frame_channel_timing": dict(
        card=card, preset=SCL_PRESET, batch=SCL_BATCH, kernel_ms=k, plain_ms=pl,
        sigma_table_kernel_ms=tab, sigma_table_snrs=list(FUSED_SNRS),
        frames_equal=equal, log1p_rational=small, erf_inv_sqrt=ge5,
        elements=SCL_BATCH * N)})
    return (statistics.mean(k), statistics.mean(pl), err,
            frame_channel_work(SCL_BATCH, N, small, ge5))


def probe_inputs(B):
    """The floors' inputs at (B, PROBE_N): LLRs from a seed and the SCL
    main path's leaf table (its frozen mask, exact mode)."""
    import numpy as np

    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import code_tables

    rng = np.random.default_rng(9)
    ch = torch.as_tensor(rng.normal(size=(B, PROBE_N)).astype(np.float32) * 2,
                         device=DEVICE)
    leaf = code_tables(preset(SCL_PRESET).code, DEVICE).frozen.to(torch.uint8)
    return ch, leaf


def tiles(copies, rows, seed=0):
    import numpy as np

    return torch.as_tensor(np.random.default_rng(seed).normal(
        size=(copies, rows, 8, 128)).astype(np.float32), device=DEVICE)


def outputs_diff(got, want):
    """(bit-equal, largest |kernel - plain|) over tuples of outputs, None
    entries matching None."""
    equal, worst = True, 0.0
    for g, w in zip(got, want):
        check((g is None) == (w is None), "kernel and plain outputs differ in count")
        if g is None:
            continue
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"kernel output {g.dtype} {tuple(g.shape)}, plain {w.dtype} "
              f"{tuple(w.shape)}")
        equal &= bool(_same(g, w).all())
        worst = max(worst, float((g.double() - w.double()).abs().max()))
    return equal, worst


def phase_probe_compare():
    """The floor kernel's variants at the SCL main path's shape, its burst
    and its graph, the bare bodies at FLOOR_BATCHES, and each pattern on one
    tile and on 8 per SM, against their plain versions; the floor writes
    over buffers filled with 90.  Returns {kernel: largest |kernel -
    plain|}."""
    from polardecoding_tpu_torch.ops import microbench_kernel as mk
    from polardecoding_tpu_torch.ops.probe_kernel import (floor_burst,
                                                          floor_cuda,
                                                          floor_graph,
                                                          floor_plain)

    worst = dict.fromkeys(("probe_floor", "probe_floor2", "probe_floor3",
                           "microbench_rolls"), 0.0)

    def record(kernel, rec, equal, err):
        emit({"probe_compare": dict(rec, kernel=kernel, equal=equal,
                                    max_abs_err=err)})
        check(equal and err == 0, f"kernel != plain: {rec}")
        worst[kernel] = max(worst[kernel], err)

    def dirty(want):
        return tuple(None if w is None else torch.full_like(w, 90) for w in want)

    def floor_case(row, variant, ch, lf, kw):
        want = floor_plain(ch, lf, PROBE_L, **kw)
        got = floor_cuda(ch, lf, PROBE_L, out=dirty(want), **kw)
        torch.cuda.synchronize()
        record(row, {"variant": variant, "batch": ch.shape[0]},
               *outputs_diff(got, want))

    # the first rows of one draw: every batch's LLRs start alike
    ch_all, leaf = probe_inputs(max(FLOOR_BATCHES + (SCL_BATCH,)))
    ch = ch_all[:SCL_BATCH]
    for row, variant, kw in FLOOR_CASES:
        floor_case(row, variant, ch, leaf if row == "probe_floor" else None, kw)
    for B in FLOOR_BATCHES:
        for row, kw in (("probe_floor", {}), ("probe_floor2", {"ties": False}),
                        ("probe_floor3", FLOOR3)):
            floor_case(row, "bare", ch_all[:B],
                       leaf if row == "probe_floor" else None, kw)
    want = floor_plain(ch, None, PROBE_L, **FLOOR3)
    out = dirty(want)
    burst = floor_burst(FLOOR3_BURST, ch, None, PROBE_L, out=out, **FLOOR3)
    torch.cuda.synchronize()
    record("probe_floor3", {"variant": f"x{FLOOR3_BURST}", "batch": SCL_BATCH},
           *outputs_diff(burst, want))
    replay = floor_graph(FLOOR3_GRAPH, ch, None, PROBE_L, out=out, **FLOOR3)
    for t in out:
        if t is not None:
            t.fill_(90)
    got = replay()
    torch.cuda.synchronize()
    record("probe_floor3", {"variant": f"graph{FLOOR3_GRAPH}", "batch": SCL_BATCH},
           *outputs_diff(got, want))
    del ch_all, ch, want, out, burst, replay, got

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, L, rows in MB_CASES:
        for copies in (1, 8 * sms):
            x = tiles(copies, rows, seed=copies)
            got = mk.microbench_cuda(kind, x, MB_CMP_ITERS, L)
            want = mk.microbench_plain(kind, x, MB_CMP_ITERS, L)
            torch.cuda.synchronize()
            record("microbench_rolls",
                   {"pattern": kind, "L": L, "rows": rows, "copies": copies,
                    "iters": MB_CMP_ITERS,
                    "max_abs_value": float(want.abs().max())},
                   *outputs_diff((got,), (want,)))
    return worst


def run_script(script, argv):
    """scripts/<script> run as __main__ in this process with argv, every
    launch count at 0 just before: (its exit code, what it printed, its
    seconds)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        script)
    reset_counts()
    out, saved = io.StringIO(), sys.argv
    sys.argv = [path, *argv]
    code = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = saved
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return code, out.getvalue(), time.perf_counter() - t0


def phase_probe_paths():
    """Run the four probe drivers at short settings in this process, each
    with every launch count at 0 just before; each must exit 0, print its
    JSON lines and launch its kernel.  Returns ({kernel: launches},
    {kernel: the driver's lines})."""
    counts, printed = {}, {}
    for kernel, script, argv in PROBE_RUNS:
        code, text, seconds = run_script(script, argv)
        counts[kernel] = launches(kernel)
        lines = [json.loads(line) for line in text.splitlines()]
        printed[kernel] = lines
        emit({"probe_run": {"script": f"scripts/{script}", "argv": argv,
                            "exit": code, "launches": counts[kernel],
                            "seconds": seconds, "lines": lines}})
        check(code == 0 and lines, f"scripts/{script} exited {code}")
        check(counts[kernel] > 0, f"scripts/{script} launched no {kernel}")
    return counts, printed


def driver_value(lines, fields, key):
    """`key` of the one driver line that has it and the given fields."""
    found = [line[key] for line in lines
             if key in line and all(line.get(k) == v for k, v in fields.items())]
    check(len(found) == 1, f"{len(found)} driver lines with {key} and {fields}")
    return found[0]


def floor_work(B, leaf, ties):
    """Bytes a floor call at (B, PROBE_N, PROBE_L) must move: the LLRs and
    the table in, int8 u, pm and ties out."""
    nbytes = B * PROBE_N * 4 + (PROBE_N if leaf else 0)
    nbytes += B * PROBE_L * PROBE_N + B * PROBE_L * 4 + (B * 4 if ties else 0)
    return nbytes, 0


def phase_probe_timing(card, printed, scl_ms, r1_ms):
    """Each probe's kernel time from its driver's lines (PROBE_TIMES,
    MB_TIME) and its plain version's at the same shape, timed here.  Returns
    {kernel: (ms, plain ms, (bytes, operations))}."""
    from polardecoding_tpu_torch.ops import microbench_kernel as mk
    from polardecoding_tpu_torch.ops.probe_kernel import floor_plain

    out = {}
    for name, (fields, key, B, kw) in PROBE_TIMES.items():
        ch, leaf = probe_inputs(B)
        lf = leaf if name == "probe_floor" else None
        plain_ms, _ = cuda_ms(lambda: floor_plain(ch, lf, PROBE_L, **kw),
                              PROBE_REPS)
        out[name] = (driver_value(printed[name], fields, key), plain_ms,
                     floor_work(B, lf is not None, kw.get("ties", True)))
        del ch

    kind, L, rows = MB_TIME
    copies = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    ms = driver_value(printed["microbench_rolls"],
                      {"pattern": kind, "L": L, "rows": rows, "copies": copies},
                      "seconds") * 1e3
    x = tiles(copies, rows)
    plain_ms, _ = cuda_ms(lambda: mk.microbench_plain(kind, x, MB_TIME_ITERS, L), 1)
    # what the function needs per element and iteration: L products and L
    # sums, and the halving; the TPU count also has a roll and a mask per
    # term, a shared-memory read and a loop constant here
    ops = MB_TIME_ITERS * x.numel() * (2 * L + 1)
    out["microbench_rolls"] = (ms, plain_ms, (2 * x.numel() * 4, ops))
    floor_ms = out["probe_floor"][0]
    emit({"probe_timing": {
        "card": card, "ms": {k: v[0] for k, v in out.items()},
        "plain_ms": {k: v[1] for k, v in out.items()},
        "pattern_ops_per_s": ops / ms * 1e3,
        "pattern_of_ops_per_s": ops / ms * 1e3 / OPS_PER_S,
        "scl_decode_ms": scl_ms, "scl_decode_r1_ms": r1_ms,
        "floor_share_of_scl_decode": floor_ms / scl_ms,
        "floor_share_of_scl_decode_r1": floor_ms / r1_ms}})
    return out


def phase_bench():
    """bench.main() and `cli bench` at their defaults, the launch counts at
    0 just before: bench.py's keys, every leg a positive rate, value the
    worse of the wave and SCL legs, and each leg's kernel launched."""
    from polardecoding_tpu_torch import bench, cli

    reset_counts()
    t0 = time.perf_counter()
    rec = bench.main([])
    counts = {k: launches(k) for k in ("bp_decode", "scl_decode",
                                       "scl_decode_r1", "bp_wave_mc",
                                       "frame_channel")}
    emit({"bench_run": {"seconds": time.perf_counter() - t0,
                        "launches": counts}})
    check(set(rec) == BENCH_KEYS, f"bench keys {sorted(rec)}")
    legs = ("bp_1024_wave_fps", "bp_1024_fixed100_fps", "scl_fps",
            "scl_1024_l8_fps")
    check(all(isinstance(rec[k], float) and rec[k] > 0 for k in legs),
          f"bench legs {rec}")
    check(rec["value"] == min(rec["bp_1024_wave_fps"], rec["scl_fps"]),
          f"bench value {rec['value']}")
    # rounded as bench.py's record: rates to 0.1, the baseline ratios to 1e-4
    check(all(rec[k] == round(rec[k], 1) for k in legs + ("value",))
          and all(rec[k] == round(rec[k], 4)
                  for k in ("vs_baseline", "vs_baseline_fixed_iters")),
          f"bench rates not rounded as bench.py's: {rec}")
    check(all(counts.values()), f"bench launches {counts}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["bench"])
    line = json.loads(out.getvalue().splitlines()[-1])
    emit({"cli_bench": line})
    check(set(line) == {"preset", "frames_per_sec"} and line["frames_per_sec"] > 0
          and line["frames_per_sec"] == round(line["frames_per_sec"], 1),
          f"cli bench printed {line}")
    return rec


def phase_sigma_table_compare():
    """The frame channel's kernel with a sigma table (the fused sweep's
    launch: frame i at sigmas[i % S]) against its plain version on the card,
    bit for bit on every element: S in SIGMA_TABLE_SIZES over SNRs spread
    across SIGMA_TABLE_SPAN, B in SIGMA_TABLE_BATCHES, N in SIGMA_TABLE_NS,
    frames from 5; with S = 1 also against the scalar launch.  Returns the
    largest |kernel - plain|."""
    from polardecoding_tpu_torch.ops.channel import (fold_in, frame_llr,
                                                     prng_key,
                                                     sigma_from_ebn0_db)

    worst = 0.0
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    key = fold_in(prng_key(3, DEVICE), 150)
    for N in SIGMA_TABLE_NS:
        for B in SIGMA_TABLE_BATCHES:
            x = torch.randint(0, 2, (B, N), generator=gen, device=DEVICE
                              ).to(torch.float32)
            fidx = torch.arange(B, device=DEVICE) + 5
            for S in SIGMA_TABLE_SIZES:
                snrs = torch.linspace(*SIGMA_TABLE_SPAN, S,
                                      dtype=torch.float64).tolist()
                table = torch.tensor([sigma_from_ebn0_db(v) for v in snrs],
                                     dtype=torch.float32, device=DEVICE)
                got = frame_llr(x, key, fidx, table)
                pairs = [(got, frame_llr(x, key, fidx, table, engine="plain"), 0)]
                if S == 1:
                    pairs.append((got, frame_llr(x, key, fidx, float(table[0])), 0))
                torch.cuda.synchronize()
                equal, err = frames_equal(pairs, B)
                rec = {"N": N, "B": B, "S": S, "snr_db": snrs,
                       "frames_equal": equal, "max_abs_err": err,
                       "scalar_launch_too": S == 1}
                emit({"sigma_table_compare": rec})
                check(equal == B and err == 0, f"sigma table != plain: {rec}")
                worst = max(worst, err)
    return worst


def bpr_segments(checkpoints, iters):
    """The iterations of each wave-kernel launch of a BPr decode: from one
    sorted checkpoint to the next, then on to `iters`; empty segments are
    not launched."""
    segs, it = [], 0
    for c in sorted(checkpoints):
        segs.append(c - it)
        it = c
    segs.append(max(iters - it, 0))
    return [g for g in segs if g]


def phase_bpr(card):
    """BPr on the card (BPR_PRESET at BPR_BATCH and MAIN_SNR).  bpr_decode
    with the wave kernel and with the plain iterations: u_hat and E
    bit-equal, and E again from the kernel's segments run by hand on a
    state whose planes that an iteration overwrites (L[0], R[1..n]) hold
    NaN, so that every plane the snapshot reads is one the kernel wrote
    back.  Then, the launch counts at 0: one make_bpr_step step must launch
    the wave kernel BPR_WAVE_LAUNCHES times and the frame channel once, no
    other kernel, its counters and E equal to engine="plain"'s; and
    run_bpr_point to BPR_ERROR_BLOCKS, BLER in BPR_BLER_RANGE, 7 wave and 1
    channel launches a step.  Times the step (CUDA events; the host's
    launches included), a snapshot, the 90 iterations' kernels with the
    state's init (queued behind a sleep) and profiles the step."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.models.bp import (bpr_decode, bpr_stage_errors,
                                                   wave_init_state)
    from polardecoding_tpu_torch.ops.bp_wave_kernel import bp_wave_cuda
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import (code_tables,
                                                          make_bpr_step,
                                                          run_bpr_point)

    p = preset(BPR_PRESET)
    dec, N = p.decoder, p.code.N
    n = N.bit_length() - 1
    segs = bpr_segments(dec.bpr_checkpoints, dec.bp_iters)
    check(len(segs) == BPR_WAVE_LAUNCHES, f"BPr segments {segs}")
    info = code_tables(p.code, DEVICE).info_set
    llr, frozen, u = llr_frames(BPR_PRESET, BPR_BATCH, MAIN_SNR, DEVICE)
    kw = dict(iters=dec.bp_iters, flavor=dec.bp_flavor,
              checkpoints=dec.bpr_checkpoints)
    got = bpr_decode(llr, frozen, u, info, **kw)
    want = bpr_decode(llr, frozen, u, info, engine="plain", **kw)
    state = wave_init_state(llr, frozen)
    state[[0] + list(range(n + 2, 2 * n + 2))] = float("nan")
    rows, it = [], 0
    for c in sorted(dec.bpr_checkpoints):
        if c > it:
            bp_wave_cuda(state, c - it, dec.bp_flavor)
        it = c
        rows.append(bpr_stage_errors(state, info, u[:, info]))
    torch.cuda.synchronize()
    by_hand = torch.stack(rows)
    equal, err = frames_equal([(got[0], want[0], 0)], BPR_BATCH)
    rec = {"preset": BPR_PRESET, "batch": BPR_BATCH, "snr_db": MAIN_SNR,
           "segments": segs, "u_hat_frames_equal": equal,
           "E_equal": bool((got[1] == want[1]).all()),
           "E_from_nan_planes_equal": bool((by_hand == want[1]).all()),
           "E": want[1].tolist()}
    emit({"bpr_compare": rec})
    check(equal == BPR_BATCH and err == 0 and rec["E_equal"]
          and rec["E_from_nan_planes_equal"], f"BPr kernel != plain: {rec}")

    key = fold_in(prng_key(p.sweep.seed, DEVICE), int(round(MAIN_SNR * 100)))
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    step = make_bpr_step(p, BPR_BATCH, DEVICE)
    plain_step = make_bpr_step(p, BPR_BATCH, DEVICE, engine="plain")
    reset_counts()
    k_out = step(key, 0, sigma)
    torch.cuda.synchronize()
    counts = {k: launches(k) for k in kernels() if launches(k)}
    p_out = plain_step(key, 0, sigma)
    same = ([int(v) for v in k_out[:2]] == [int(v) for v in p_out[:2]]
            and bool((k_out[2] == p_out[2]).all()))
    emit({"main_path": {"path": f"{BPR_PRESET} make_bpr_step",
                        "batch": BPR_BATCH,
                        "counters": [int(v) for v in k_out[:2]],
                        "E": k_out[2].tolist(), "plain_equal": same,
                        "launches": counts}})
    check(same, "BPr step counters or E differ between kernel and plain")
    check(counts == {"bp_wave": BPR_WAVE_LAUNCHES, "frame_channel": 1},
          f"BPr step launches {counts}")

    reset_counts()
    t0 = time.perf_counter()
    res, E = run_bpr_point(p, MAIN_SNR, batch=BPR_BATCH, device=DEVICE,
                           error_blocks=BPR_ERROR_BLOCKS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = res.frames // BPR_BATCH
    counts = {k: launches(k) for k in kernels() if launches(k)}
    emit({"main_path": {
        "path": f"{BPR_PRESET} run_bpr_point", "batch": BPR_BATCH,
        "point": res.to_json(p.code.num_info), "seconds": seconds,
        "checkpoints": list(dec.bpr_checkpoints),
        "stage_errors_per_frame": (E / max(res.frames, 1)).round(6).tolist(),
        "launches": counts}})
    check(res.errblock >= BPR_ERROR_BLOCKS, f"run_bpr_point stopped early: {res}")
    check(BPR_BLER_RANGE[0] <= res.bler <= BPR_BLER_RANGE[1],
          f"BPr BLER {res.bler} at {MAIN_SNR} dB outside {BPR_BLER_RANGE}")
    check(counts == {"bp_wave": BPR_WAVE_LAUNCHES * steps,
                     "frame_channel": steps}, f"BPr point launches {counts}")

    step_ms = [cuda_ms(lambda: step(key, 0, sigma), STEP_REPS)[0]
               for _ in range(2)]
    snap_ms = cuda_ms(lambda: bpr_stage_errors(state, info, u[:, info]),
                      KERNEL_REPS)[0]

    def iterations():
        fresh = wave_init_state(llr, frozen)
        for g in segs:
            bp_wave_cuda(fresh, g, dec.bp_flavor)

    iter_ms = queued_ms(iterations, KERNEL_REPS)[0]
    emit({"bpr_timing": {
        "card": card, "preset": BPR_PRESET, "batch": BPR_BATCH,
        "step_ms": step_ms, "snapshot_ms": snap_ms,
        "snapshots_per_step": len(dec.bpr_checkpoints),
        "init_and_iterations_queued_ms": iter_ms, "wave_launches": len(segs)}})
    phase_profile(card, f"{BPR_PRESET} BPr step", BPR_BATCH,
                  lambda s: [int(v) for v in step(key, s * BPR_BATCH, sigma)[:2]])


def phase_fused_sweep(card):
    """make_multisnr_step at FUSED_SNRS on each of FUSED_CASES, the launch
    counts at 0: the per-SNR counters equal with the kernels and with
    engine="plain", one frame-channel launch (the sigma table) and one
    decoder launch a step and no other kernel, every frame counted once;
    each step's time (CUDA events, host included) and a profile of it."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import prng_key, sigma_from_ebn0_db
    from polardecoding_tpu_torch.parallel.harness import make_multisnr_step

    sigmas = torch.tensor([sigma_from_ebn0_db(v) for v in FUSED_SNRS],
                          dtype=torch.float32, device=DEVICE)
    S = len(FUSED_SNRS)
    for name, batch, kernel in FUSED_CASES:
        p = preset(name)
        key = prng_key(p.sweep.seed, DEVICE)
        step = make_multisnr_step(p, batch, S, DEVICE)
        reset_counts()
        got = [c.tolist() for c in step(key, 0, sigmas)]
        torch.cuda.synchronize()
        counts = {k: launches(k) for k in kernels() if launches(k)}
        want = [c.tolist() for c in make_multisnr_step(
            p, batch, S, DEVICE, engine="plain")(key, 0, sigmas)]
        ms = [cuda_ms(lambda: step(key, batch, sigmas), STEP_REPS)[0]
              for _ in range(2)]
        emit({"main_path": {"path": f"{name} make_multisnr_step",
                            "batch": batch, "snr_db": list(FUSED_SNRS),
                            "counters": got, "plain": want, "launches": counts,
                            "card": card, "step_ms": ms}})
        check(got == want, f"{name}: multi-SNR counters kernel {got} != plain {want}")
        check(sum(got[2]) == batch and all(0 <= e <= f for e, f in zip(got[1], got[2])),
              f"{name}: multi-SNR frames {got}")
        check(counts == {kernel: 1, "frame_channel": 1},
              f"{name}: multi-SNR step launches {counts}")
        phase_profile(card, f"{name} multi-SNR step", batch,
                      lambda s: [c.tolist() for c in step(key, s * batch, sigmas)])


def phase_sweeps(card):
    """run_multiseed on MULTISEED_PRESET at MAIN_SNR: each seed's record
    equal to that seed's own run_sweep; then run_point on SYNC_CASES on a
    fixed budget of SYNC_STEPS steps (the error-block target out of reach)
    at sync_every 1 and 8 in turns (SYNC_TURNS), one step function built
    and warmed beforehand: the wall time, the frames counted (8 counts
    whole chunks, one past the budget) and frames per second."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import (make_frame_step,
                                                          run_multiseed,
                                                          run_point, run_sweep)

    p = preset(MULTISEED_PRESET)
    kw = dict(snr_points=[MAIN_SNR], error_blocks=MULTISEED_ERROR_BLOCKS,
              batch=SCL_BATCH, device=DEVICE)
    reset_counts()
    per_seed, averaged = run_multiseed(p, list(MULTISEED_SEEDS), **kw)
    torch.cuda.synchronize()
    counts = {k: launches(k) for k in kernels() if launches(k)}
    alone = {seed: run_sweep(p, seed=seed, **kw) for seed in MULTISEED_SEEDS}

    def fields(r):
        return r.snr_db, r.errbit, r.errblock, r.frames, r.seed, r.pm_ties

    emit({"main_path": {"path": f"{MULTISEED_PRESET} run_multiseed",
                        "averaged": averaged, "launches": counts,
                        "per_seed": {str(s): [r.to_json(p.code.num_info)
                                              for r in rs]
                                     for s, rs in per_seed.items()}}})
    for seed in MULTISEED_SEEDS:
        check([fields(r) for r in per_seed[seed]]
              == [fields(r) for r in alone[seed]],
              f"seed {seed}: run_multiseed's record differs from run_sweep's")
    check(averaged[0]["errblock"] >= len(MULTISEED_SEEDS) * MULTISEED_ERROR_BLOCKS
          and counts.get("scl_decode_r1", 0) > 0, f"multi-seed {averaged}")

    for name, batch in SYNC_CASES:
        q = preset(name)
        step = make_frame_step(q, batch, DEVICE)
        cap = SYNC_STEPS * batch
        run_point(q, MAIN_SNR, batch=batch, device=DEVICE, step_fn=step,
                  error_blocks=1 << 40, max_frames=2 * batch)  # warmup
        turns = []
        for k in SYNC_TURNS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_point(q, MAIN_SNR, batch=batch, device=DEVICE,
                            step_fn=step, error_blocks=1 << 40,
                            max_frames=cap, sync_every=k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            turns.append({"sync_every": k, "wall_s": wall,
                          "frames": res.frames, "errblock": res.errblock,
                          "frames_per_s": res.frames / wall})
            # every chunk read counts, and the one pending at the stop
            chunks = 1 if k == 1 else -(-SYNC_STEPS // k) + 1
            check(res.frames == (cap if k == 1 else chunks * k * batch),
                  f"{name} sync_every={k}: {res.frames} frames")
        emit({"sync_every_timing": {"card": card, "preset": name,
                                    "batch": batch, "budget_steps": SYNC_STEPS,
                                    "turns": turns}})


def golden_frames(name):
    """A C frame dump of tests/golden: {frame: {"U", "Y", "H"}}, U and H
    int8 [N], Y float64 [N]."""
    frames = {}
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        for line in f:
            parts = line.split()
            if parts[0] != "FRAME":
                continue
            frames.setdefault(int(parts[1]), {})[parts[2]] = (
                np.array([float(v) for v in parts[3:]]) if parts[2] == "Y"
                else np.array([int(v) for v in parts[3:]], dtype=np.int8))
    return frames


def golden_code(decoder, N, K):
    """(frozen [N] bool, the info positions carrying [message || CRC] in
    encode order, CRC exponents or None): CA-SCL reserves K + r channels,
    CRC-6 at N=128 and CRC-24 above, as the presets."""
    from polardecoding_tpu_torch.ops.crc import CRC6_EXPONENTS, CRC24_EXPONENTS
    from polardecoding_tpu_torch.utils.sequences import frozen_mask, info_set

    exps = None
    if decoder == "cascl":
        exps = CRC6_EXPONENTS if N <= 128 else CRC24_EXPONENTS
    KI = K + (max(exps) if exps else 0)
    return frozen_mask(N, KI), info_set(N, KI), exps


def golden_words(frames, N, K, info, exps):
    """The C engine's frames 0..frames-1: w [frames, K + r] (the PN payload,
    multiplied by the CRC's g(D) for CA-SCL) and u [frames, N] int8 with w
    on the info positions."""
    from polardecoding_tpu_torch.ops.crc import crc_encode_multiplicative
    from polardecoding_tpu_torch.utils.pn import payload_bits_host

    w = np.stack([payload_bits_host(f, K) for f in range(frames)])
    if exps:
        w = crc_encode_multiplicative(torch.as_tensor(w), exps).numpy()
    u = np.zeros((frames, N), dtype=np.int8)
    u[:, info] = w
    return w, u


def golden_y(u, noise):
    """y = BPSK(u . F^{tensor n}) + noise in float64, the C order (x ? -1 :
    1, then + n), the codeword by encode_dense.  The payload window repeats
    every 63 frames, so at most 63 rows are encoded."""
    from polardecoding_tpu_torch.utils.gf2 import dense_generator, encode_dense
    from polardecoding_tpu_torch.utils.pn import PN_PERIOD

    rows = min(len(u), PN_PERIOD)
    row = np.arange(len(u)) % rows
    check(np.array_equal(u, u[row]), "the payload does not repeat every 63 frames")
    x = encode_dense(u[:rows], dense_generator(u.shape[1]))[row]
    return (1.0 - 2.0 * x.astype(np.float64)) + noise


def golden_llr(y, sigma, device):
    """2 * y / sigma / sigma in float64, the C engine's order
    (native/golden_ref.c:410, 490), then float32 on `device`."""
    return torch.as_tensor((2.0 * y / sigma / sigma).astype(np.float32),
                           device=device)


def golden_decode(decoder, llr, frozen, info, exps):
    """Decode through the port's entry points, engine "auto": the kernels
    for a CUDA tensor, the plain versions for a CPU one.  Returns (u_hat
    [B, N] int8 on the host, the kernel the decoder launches)."""
    from polardecoding_tpu_torch.models.bp import bp_decode_auto
    from polardecoding_tpu_torch.models.scl import (cascl_decode,
                                                    sc_decode_auto,
                                                    scl_decode_auto)
    from polardecoding_tpu_torch.ops.crc import check_matrix

    fr = torch.as_tensor(frozen, device=llr.device)
    if decoder in ("sc", "sc_fag"):
        out, kernel = sc_decode_auto(llr, fr), "scl_decode"
    elif decoder == "scl":
        out, kernel = scl_decode_auto(llr, fr, list_size=GOLDEN_LIST), "scl_decode"
    elif decoder == "cascl":
        out = cascl_decode(llr, fr, torch.as_tensor(info, device=llr.device),
                           check_matrix(exps, len(info)), list_size=GOLDEN_LIST)
        kernel = "scl_decode"
    else:
        out = bp_decode_auto(llr, fr, iters=GOLDEN_BP_ITERS)
        kernel = "bp_decode"
    return out.cpu().numpy(), kernel


def counted(device, run):
    """run() with the launch counts at 0 just before: (its result, the
    counts of the kernels it launched, its milliseconds).  On the card the
    time ends in a synchronize."""
    cuda = torch.device(device).type == "cuda"
    reset_counts()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    if cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {k: launches(k) for k in kernels() if launches(k)}, ms


def golden_fixture_results(device):
    """Each C frame dump of GOLDEN_FIXTURES: the port's payload and float64
    y against the dump's U and Y (the port's golden_noise, payload_bits_host,
    crc_encode_multiplicative and encode_dense), and the port's decoder on
    the dump's Y against its H.  {decoder: {"frames", "u_equal", "y_equal",
    "h_equal", "c_correct" (frames C decoded right), "h_equal_on_c_correct",
    "launches", "ms"}}."""
    from polardecoding_tpu_torch.utils.rng import golden_noise

    N, K, snr = GOLDEN_FIXTURE_CODE
    sigma = 10.0 ** (-snr / 20.0)
    out = {}
    for decoder, name in GOLDEN_FIXTURES:
        fx = golden_frames(name)
        runs = sorted(fx)
        frozen, info, exps = golden_code(decoder, N, K)
        _, u = golden_words(len(runs), N, K, info, exps)
        y = golden_y(u, golden_noise(GOLDEN_SEED, len(runs), N, sigma))
        want_u = np.stack([fx[r]["U"] for r in runs])
        want_y = np.stack([fx[r]["Y"] for r in runs])
        want_h = np.stack([fx[r]["H"] for r in runs])
        llr = golden_llr(want_y, sigma, device)
        (got, kernel), counts, ms = counted(
            device, lambda: golden_decode(decoder, llr, frozen, info, exps))
        right = (want_h == want_u).all(axis=1)
        equal = (got == want_h).all(axis=1)
        out[decoder] = {"frames": len(runs),
                        "u_equal": int((u == want_u).all(axis=1).sum()),
                        "y_equal": int((y == want_y).all(axis=1).sum()),
                        "h_equal": int(equal.sum()),
                        "c_correct": int(right.sum()),
                        "h_equal_on_c_correct": int(equal[right].sum()),
                        "kernel": kernel, "launches": counts, "ms": ms}
    return out


def golden_engine_results(device, cases=GOLDEN_CASES, code=GOLDEN_CODE):
    """The port's decoders against the port's native C engine at matched
    seeds, frame by frame: the port's golden_noise bit-equal to the C
    engine's on the first GOLDEN_NOISE_FRAMES frames, then per case
    (decoder, frames, ...) the frames whose decoded info bits differ from
    C's and both sides' error blocks.  Returns ({decoder: {"frames",
    "c_errblock", "errblock", "differing", "kernel", "launches", "ms",
    "c_seconds"}}, golden_noise's host seconds, frames whose noise equals
    C's)."""
    from polardecoding_tpu_torch import native
    from polardecoding_tpu_torch.utils.rng import golden_noise

    N, K, snr = code
    sigma = 10.0 ** (-snr / 20.0)
    frames = max(c[1] for c in cases)
    t0 = time.perf_counter()
    noise = golden_noise(GOLDEN_SEED, frames, N, sigma)
    noise_s = time.perf_counter() - t0
    head = min(GOLDEN_NOISE_FRAMES, frames)
    c_noise = native.golden_noise(GOLDEN_SEED, head, N, sigma)
    noise_equal = int((c_noise == noise[:head]).all(axis=1).sum())
    out = {}
    for decoder, B, *_ in cases:
        frozen, info, exps = golden_code(decoder, N, K)
        t0 = time.perf_counter()
        if decoder in ("bp", "sc"):
            _, c_ebl, c_bits = native.golden_mc(N, K, info, GOLDEN_SEED, snr, B,
                                                decoder=decoder,
                                                iters=GOLDEN_BP_ITERS)
        else:
            _, c_ebl, c_bits = native.golden_mc_list(
                N, K, info, GOLDEN_SEED, snr, B, list_size=GOLDEN_LIST,
                crc_exponents=exps)
        c_s = time.perf_counter() - t0
        w, u = golden_words(B, N, K, info, exps)
        llr = golden_llr(golden_y(u, noise[:B]), sigma, device)
        (got, kernel), counts, ms = counted(
            device, lambda: golden_decode(decoder, llr, frozen, info, exps))
        bits = got[:, info]
        out[decoder] = {"frames": B, "c_errblock": int(c_ebl),
                        "errblock": int((bits != w).any(axis=1).sum()),
                        "differing": int((bits != c_bits).any(axis=1).sum()),
                        "kernel": kernel, "launches": counts, "ms": ms,
                        "c_seconds": c_s}
    return out, noise_s, noise_equal


def phase_golden(card):
    """Golden mode on the card: the C reference's frame dumps and the port's
    native C engine (built from native/golden_ref.c with cc into _build/),
    decoded by the kernels.  Fixtures: the port's U and Y bit-equal to every
    dump's, and u_hat equal to C's H on every frame (BP: on every frame C
    decoded right).  GOLDEN_CASES: the port's golden_noise bit-equal to
    C's on its first frames, each decoder's differing frames within the
    case's allowance and both sides' error blocks the case's.  Every decode
    launches its kernel once, and no other kernel.  Then `cli analyze
    --tool bpdega` at N=128 (host numpy and scipy) against BPDEGA_128.c's
    output."""
    from polardecoding_tpu_torch import cli

    t0 = time.perf_counter()
    fixtures = golden_fixture_results(DEVICE)
    engine, noise_s, noise_equal = golden_engine_results(DEVICE)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["analyze", "--tool", "bpdega", "--N", "128", "--K", "64",
                  "--snr", str(GOLDEN_DEGA_SNR)])
    bler = json.loads(out.getvalue())[str(GOLDEN_DEGA_SNR)]["bler"]
    want = None
    with open(os.path.join(GOLDEN_DIR, "BPDEGA_128.txt")) as f:
        for line in f:
            parts = line.split()
            if line.startswith("bSNR") and float(parts[2]) == GOLDEN_DEGA_SNR:
                want = float(parts[5])
    emit({"golden": {"card": card, "fixtures": fixtures, "engine": engine,
                     "noise_frames_equal": noise_equal,
                     "noise_host_s": noise_s,
                     "c_engine_s": sum(r["c_seconds"] for r in engine.values()),
                     "decode_ms": {k: r["ms"] for k, r in engine.items()},
                     "bpdega_bler": bler, "bpdega_c_bler": want,
                     "seconds": time.perf_counter() - t0}})
    for decoder, r in fixtures.items():
        n = r["frames"]
        check(r["u_equal"] == n and r["y_equal"] == n,
              f"golden fixture {decoder}: U or Y differs from C's {r}")
        if decoder == "bp":
            check(r["h_equal_on_c_correct"] == r["c_correct"] > 0,
                  f"golden fixture bp: {r}")
        else:
            check(r["h_equal"] == n, f"golden fixture {decoder}: {r}")
        check(r["launches"] == {r["kernel"]: 1},
              f"golden fixture {decoder} launched {r['launches']}")
    check(noise_equal == GOLDEN_NOISE_FRAMES,
          f"golden noise: {noise_equal} frames equal to the C engine's")
    for decoder, B, allowed, blocks in GOLDEN_CASES:
        r = engine[decoder]
        check(r["c_errblock"] == blocks and r["errblock"] == blocks
              and r["differing"] <= allowed,
              f"golden {decoder} at N={GOLDEN_CODE[0]}: {r}")
        check(r["launches"] == {r["kernel"]: 1},
              f"golden {decoder} launched {r['launches']}")
    check(want is not None and abs(bler - want) < GOLDEN_DEGA_TOL,
          f"cli analyze bpdega {bler} against BPDEGA_128.c's {want}")
    return {k: sum(r["launches"].get(k, 0) for r in
                   list(fixtures.values()) + list(engine.values()))
            for k in ("bp_decode", "scl_decode")}


def reproduce_pin_results(device, names=None):
    """Each pinned point of the reproduction (reproduce.pinned_runs, or
    those of `names`) through its run half on `device`, into a temporary
    directory, with the launch counts at 0 just before: {preset: {"got":
    its (errbit, errblock, frames), "pin": JAX_CPU_PINS', "kernels": its
    path's, "launches", "ms"}}.  On the card run_presets also checks a
    frame-step preset's decoder and frame channel once a step."""
    from polardecoding_tpu_torch import reproduce
    from polardecoding_tpu_torch.configs import preset

    points = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in reproduce.pinned_runs():
            if names is not None and run.preset not in names:
                continue
            done, counts, ms = counted(device, lambda: reproduce.run_presets(
                [run], tmp, device=device, log=None, commit="chip_smoke"))
            rec = done[run.file]["records"][0]
            points[run.preset] = {
                "got": [rec["errbit"], rec["errblock"], rec["frames"]],
                "pin": list(reproduce.JAX_CPU_PINS[run.preset]),
                "kernels": list(reproduce.path_kernels(preset(run.preset))),
                "launches": counts, "ms": ms}
    return points


def phase_reproduce_pins(card):
    """The reproduction's pins on the card: every pinned point equal to
    JAX_CPU_PINS, and its path's kernels launched, no other.  Then the
    profiles of the heaviest presets' steps at the reproduction's batch
    (REPRODUCE_PROFILES): the host's share of a reproduction step."""
    from polardecoding_tpu_torch.parallel.harness import make_wave_step
    from polardecoding_tpu_torch.reproduce import BATCH

    t0 = time.perf_counter()
    points = reproduce_pin_results(DEVICE)
    emit({"reproduce_pins": {"card": card, "points": points,
                             "seconds": time.perf_counter() - t0}})
    for name, r in points.items():
        check(r["got"] == r["pin"],
              f"reproduce pin {name}: {r['got']} against the JAX package's "
              f"{r['pin']}")
        check(set(r["launches"]) == set(r["kernels"]),
              f"reproduce pin {name} launched {r['launches']}, expected "
              f"{r['kernels']}")
    for name in REPRODUCE_PROFILES:
        run = (wave_runner(name, make_wave_step, batch=BATCH)
               if name == "BP_1024_GA" else frame_step_runner(name, BATCH))
        phase_profile(card, f"{name} reproduction step", BATCH, run)


def studies_quick_results(device, names=None):
    """Each run of STUDIES_QUICK (or those of `names`) through its study's
    run entry (studies.run_study) on `device`, into a temporary directory,
    with the launch counts at 0 just before: {study: {"lines", "launches",
    "ms", "failed": its checks that failed}}."""
    from polardecoding_tpu_torch import studies

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in STUDIES_QUICK.items():
            if names is not None and name not in names:
                continue
            lines, counts, ms = counted(device, lambda: studies.run_study(
                name, tmp, device=device, log=None, commit="chip_smoke", **kw))
            out[name] = {"lines": lines, "launches": counts, "ms": ms,
                         "failed": studies.STUDIES[name].checks(lines)}
    return out


def study_pin_checks(results) -> list:
    """Each STUDY_PINS entry against the quick runs' lines: (pin, got,
    want) of every pin."""
    from polardecoding_tpu_torch.studies import STUDY_PINS

    def arm(study, **want):
        return next(x for x in results[study]["lines"]
                    if all(x.get(k) == v for k, v in want.items()))

    held = []
    for pin in ("bler_r1_exact", "bler_r1_fastr1"):
        x = arm("bler_r1", preset=STUDY_PINS[pin]["preset"])
        held.append((pin, [x["errbit"], x["errblock"], x["pm_ties"], x["frames"]],
                     [*STUDY_PINS[pin]["counts"], STUDY_PINS[pin]["batch"]]))
    for pin, dtype in (("bf16_f32", "f32"), ("bf16_bfloat16", "bfloat16")):
        x = arm("bf16_study", part=2, dtype=dtype)
        held.append((pin, [x["errbit"], x["errblock"], x["pm_ties"], x["frames"]],
                     [*STUDY_PINS[pin]["counts"], STUDY_PINS[pin]["batch"]]))
    x = next(x for x in results["tie_impact_study"]["lines"]
             if "block_outcome_differs" in x)
    want = STUDY_PINS["tie_impact_128"]
    held.append(("tie_impact_128", {k: x[k] for k in want}, dict(want)))
    return held


def phase_studies_quick(card):
    """The studies on the card at short settings (STUDIES_QUICK): every
    STUDY_PINS entry exact, every study's checks held (parity lines
    bit-equal, z within 4, the verdict OK), each run's kernels launched
    (STUDIES_QUICK_LAUNCHES), no other; returns the launches of each
    kernel summed over the runs."""
    t0 = time.perf_counter()
    results = studies_quick_results(DEVICE)
    pins = study_pin_checks(results)
    emit({"studies_quick": {
        "card": card, "seconds": time.perf_counter() - t0,
        "pins": [{"pin": p, "got": got, "want": want} for p, got, want in pins],
        "runs": {name: {"launches": r["launches"], "ms": r["ms"],
                        "failed": r["failed"]} for name, r in results.items()}}})
    for p, got, want in pins:
        check(got == want, f"study pin {p}: {got} against {want}")
    for name, r in results.items():
        check(not r["failed"], f"study {name}: {r['failed']}")
        want = STUDIES_QUICK_LAUNCHES[name]
        check(set(r["launches"]) == set(want) and all(
            n is None or r["launches"][k] == n for k, n in want.items()),
            f"study {name} launched {r['launches']}, expected {want}")
    for x in results["bler_wavemc"]["lines"]:
        if "engine" in x:
            check(set(x["launches"]) == STUDIES_WAVE_KERNELS[x["engine"]],
                  f"bler_wavemc {x['engine']} launched {x['launches']}")
    total = {}
    for r in results.values():
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def queue_a_quick_results(device):
    """QUEUE_A_CHKFAST through the ab_chkfast study's run entry, then each
    QUEUE_A_QUICK driver run in this process with --device, --out (a
    temporary directory) and --commit added, each with the launch counts at
    0 just before: {run: {"exit", "launches", "seconds", "lines": the
    records it wrote, "failed": the study's checks that failed}}."""
    from polardecoding_tpu_torch import studies
    from polardecoding_tpu_torch.studies import queue_a
    from polardecoding_tpu_torch.studies._common import read_lines

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        lines, counts, ms = counted(device, lambda: studies.run_study(
            "ab_chkfast", tmp, device=device, log=None, commit="chip_smoke",
            **QUEUE_A_CHKFAST))
        out["ab_chkfast"] = {"exit": 0, "launches": counts, "seconds": ms / 1e3,
                             "lines": lines,
                             "failed": studies.ab_chkfast.checks(lines)}
        for script, argv, _ in QUEUE_A_QUICK:
            name = script[len("torch_"):-len(".py")]
            code, _, seconds = run_script(script, [
                *argv, "--device", str(device), "--out", tmp,
                "--commit", "chip_smoke"])
            out[name] = {"exit": code, "seconds": seconds,
                         "launches": {k: launches(k) for k in kernels()
                                      if launches(k)},
                         "lines": read_lines(tmp, queue_a.FILES[name])}
    return out


def phase_queue_a_quick(card):
    """Queue A's drivers at short settings (queue_a_quick_results): each
    exits 0 and launches its path's kernels, no other; ab_chkfast's checks
    hold; verify_drive --fast passes with every check's counts the JAX
    package's (torch_verify_drive.JAX_CPU); ab_r1's parity lines bit-equal.
    Returns the launches of each kernel summed over the runs."""
    t0 = time.perf_counter()
    results = queue_a_quick_results(DEVICE)
    verify = [x for x in results["verify_drive"]["lines"] if "check" in x]
    parity = [x for x in results["ab_r1"]["lines"] if "parity" in x]
    emit({"queue_a_quick": {
        "card": card, "seconds": time.perf_counter() - t0,
        "runs": {name: {k: r[k] for k in ("exit", "launches", "seconds")}
                 for name, r in results.items()},
        "chkfast_failed": results["ab_chkfast"]["failed"],
        "verify": [{k: x[k] for k in ("check", "errbit", "errblock", "frames",
                                      "pm_ties", "jax_cpu", "same_as_tpu")}
                   for x in verify],
        "r1_parity": [{k: x[k] for k in ("variant", "bits_equal", "pm_equal",
                                         "ties_equal")} for x in parity]}})
    want = {script[len("torch_"):-len(".py")]: kernels
            for script, _, kernels in QUEUE_A_QUICK}
    want["ab_chkfast"] = QUEUE_A_CHKFAST_KERNELS
    for name, r in results.items():
        check(r["exit"] == 0, f"queue A {name} exited {r['exit']}")
        check(set(r["launches"]) == want[name],
              f"queue A {name} launched {r['launches']}, expected {want[name]}")
    check(not results["ab_chkfast"]["failed"],
          f"ab_chkfast: {results['ab_chkfast']['failed']}")
    check(len(verify) == 4 and all(x["same_as_jax_cpu"] for x in verify),
          "verify_drive --fast: counts differ from the JAX package's")
    check(len(parity) == 2 and all(x["bits_equal"] and x["pm_equal"]
                                   and x["ties_equal"] for x in parity),
          "ab_r1: a parity line differs")
    total = {}
    for r in results.values():
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def multi_rank_paths(mesh):
    """MR_CASES on `mesh` (None: one process on DEVICE), each run twice: a
    warmup (a rank's first launches load its kernels' libraries), then
    with the launch counts at 0 just before: {label: {"counters": per step
    (and, for the wave engine, per drain step until none remains) of the
    second run, "launches": each of the case's kernels in it, "wall_ms":
    its host time, synchronised}}."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import (fold_in, prng_key,
                                                     sigma_from_ebn0_db)
    from polardecoding_tpu_torch.parallel.harness import (make_frame_step,
                                                          make_wave_step)

    device = DEVICE if mesh is None else mesh.device
    sigma = sigma_from_ebn0_db(MAIN_SNR)
    out = {}
    for label, name, batch, steps, kw in MR_CASES:
        p = preset(name)
        key = fold_in(prng_key(p.sweep.seed, device), int(round(MAIN_SNR * 100)))
        if label.endswith("wave engine"):
            init, step, drain = make_wave_step(p, batch, device=device,
                                               mesh=mesh, **kw)

            def run():
                carry = init(key, 0, sigma)
                rows = []
                for _ in range(steps):
                    carry, c = step(key, sigma, carry)
                    rows.append([int(v) for v in c])
                remaining = batch
                while remaining > 0:
                    carry, c = drain(sigma, carry)
                    rows.append([int(v) for v in c])
                    remaining = rows[-1][3]
                    check(len(rows) < steps + 40,
                          f"{label}: the drain did not end")
                return rows
        else:
            frame_step = make_frame_step(p, batch, device, mesh=mesh, **kw)

            def run():
                return [[int(v) for v in frame_step(key, s * batch, sigma)]
                        for s in range(steps)]
        run()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rows = run()
        torch.cuda.synchronize()
        out[label] = {"counters": rows, "launches": {
            k: launches(k) for k, _ in MR_KERNELS[label]},
            "wall_ms": (time.perf_counter() - t0) * 1e3}
    return out


def collective_ms(mesh):
    """Host milliseconds of the mesh's all-gather of one rank's three
    counters and of its sum of three counters, each read back to the host
    as a step's counters are (mean of MR_COLLECTIVE_REPS after warmup)."""
    vec = torch.arange(3, dtype=torch.int64, device=mesh.device)
    times = {}
    for name, run in (("gather", lambda: mesh.gather(vec).tolist()),
                      ("sum", lambda: mesh.sum(vec)[0].tolist())):
        run()
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(MR_COLLECTIVE_REPS):
            run()
        times[name] = (time.perf_counter() - t0) * 1e3 / MR_COLLECTIVE_REPS
    return times


def rank_worker(rank, world, backend, store, path):
    """One rank of the multi-rank phase (run as `chip_smoke.py --rank RANK
    WORLD BACKEND STORE OUT`): join the group through a FileStore, and
    write as JSON what it counted.  gloo ranks run MR_CASES on the default
    group's mesh; the nccl rank (a group of one) runs run_point on BP_1024
    and `cli scale --preset BP_1024`."""
    import datetime

    import torch.distributed as dist

    from polardecoding_tpu_torch import cli
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import run_point
    from polardecoding_tpu_torch.parallel.mesh import data_mesh

    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=MR_TIMEOUT_S))
    mesh = data_mesh()
    check(mesh.group is not None and mesh.size == world
          and mesh.device.type == "cuda", f"mesh {mesh}")
    out = {"rank": rank, "backend": backend, "device": str(mesh.device),
           "collective_ms": collective_ms(mesh)}
    t0 = time.perf_counter()
    if backend == "gloo":
        out["paths"] = multi_rank_paths(mesh)
    else:
        reset_counts()
        res = run_point(preset(MAIN_PRESET), MAIN_SNR, batch=MAIN_BATCH,
                        error_blocks=MAIN_ERROR_BLOCKS)
        torch.cuda.synchronize()
        out["run_point"] = dict(res.to_json(preset(MAIN_PRESET).code.num_info),
                                launches={"bp_decode": launches("bp_decode")})
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli.main(["scale", "--preset", MAIN_PRESET])
        out["scale"] = json.loads(text.getvalue())
    out["wall_s"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_multi_rank(card, row5_ms):
    """Two gloo ranks on the one card (an NCCL group of two cannot share a
    card) hold MR_CASES' global counters equal to one process at the same
    global batch, each rank launching the cases' kernels on its half; a
    one-rank nccl group runs run_point on BP_1024 (BLER in BLER_RANGE) and
    `cli scale` at world size 1.  The three ranks run at once as
    subprocesses, each with MR_TIMEOUT_S, killed on the way out.  Prints
    the multi_rank line (compares, per-rank launches, collective times,
    the phase's wall time) and the row5 line (the MC channel kernel's time
    beside its time before the first-row argument)."""
    import tempfile

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p]))
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(r, MR_WORLD, "gloo", "gloo") for r in range(MR_WORLD)]
        jobs.append((0, 1, "nccl", "nccl"))
        procs = []
        try:
            for rank, world, backend, store in jobs:
                path = os.path.join(tmp, f"{backend}{rank}.json")
                procs.append((subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank",
                     str(rank), str(world), backend,
                     os.path.join(tmp, store), path],
                    cwd=root, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True), path))
            single = multi_rank_paths(None)
            ranks = []
            for proc, path in procs:
                out, err = proc.communicate(timeout=MR_TIMEOUT_S)
                check(proc.returncode == 0,
                      f"a rank exited {proc.returncode}:\n{out}\n{err[-4000:]}")
                with open(path) as f:
                    ranks.append(json.load(f))
        finally:
            for proc, _ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    gloo, nccl = ranks[:MR_WORLD], ranks[MR_WORLD]
    compares = {}
    for label, _, batch, steps, _ in MR_CASES:
        want = single[label]["counters"]
        got = [r["paths"][label]["counters"] for r in gloo]
        compares[label] = {"batch": batch, "per_rank": batch // MR_WORLD,
                           "steps": steps, "one_process": want,
                           "equal": all(g == want for g in got),
                           "wall_ms": {"one_process": single[label]["wall_ms"],
                                       "ranks": [r["paths"][label]["wall_ms"]
                                                 for r in gloo]}}
    res = nccl["run_point"]
    emit({"multi_rank": {
        "card": card, "backend": "gloo", "ranks": MR_WORLD,
        "devices": [r["device"] for r in gloo], "compares": compares,
        "launches": {label: [r["paths"][label]["launches"] for r in gloo]
                     for label in compares},
        "collective_ms": {"gloo": [r["collective_ms"] for r in gloo],
                          "nccl": nccl["collective_ms"]},
        "rank_wall_s": [r["wall_s"] for r in ranks],
        "nccl": {"run_point": res, "scale": nccl["scale"]},
        "wall_s": time.perf_counter() - t0}})
    for label, c in compares.items():
        check(c["equal"], f"{label}: two ranks differ from one process")
        for r in gloo:
            n = r["paths"][label]["launches"]
            for kernel, per_step in MR_KERNELS[label]:
                want = c["steps"] if per_step else None
                check(n[kernel] > 0 and want in (None, n[kernel]),
                      f"{label}: rank {r['rank']} launched {kernel} "
                      f"{n[kernel]} times")
    check(BLER_RANGE[0] <= res["bler"] <= BLER_RANGE[1]
          and res["errblock"] >= MAIN_ERROR_BLOCKS
          and res["launches"]["bp_decode"] > 0, f"nccl run_point {res}")
    scale = nccl["scale"]
    check([r["devices"] for r in scale] == [1] and scale[0]["cards"] == 1
          and scale[0]["frames_per_sec"] > 0 and scale[0]["engine"] == "frame",
          f"cli scale {scale}")
    emit({"row5": {"card": card, "kernel": "mc_channel",
                   "batch": MC_CHANNEL_BATCH, "ms": row5_ms,
                   "before_ms": ROW5_BEFORE_MS}})


def bound(nbytes, ops, int_ops=0):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move nbytes through HBM and do ops operations, int_ops of them on
    integers: the larger of the three times at HBM_BYTES_PER_S, OPS_PER_S
    and INT_OPS_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / OPS_PER_S, int_ops / INT_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def counted_chks(flavor):
    """Counts, within the block, the CHKs of the plain BP of `flavor`
    (models/bp.CHK_FNS) that the function needs: every call but the
    L-sweep's chk(R[n-1], L[n]) at stage n-1, which repeats the R-sweep's
    on the same operands; and of those, the ones whose table difference is
    +0 (ops/chk.table_zero).  Yields {"flavor", "chks", "zero"}, the counts
    filled on exit."""
    from polardecoding_tpu_torch.models import bp
    from polardecoding_tpu_torch.ops.chk import table_zero

    fn = bp.CHK_FNS[flavor]
    counts = {"flavor": flavor, "chks": 0, "zero": 0}
    zero, last = [], [0]

    def counted(a, b):
        if a.shape[-2] == 1:  # [.., N / 2^(i+1), 2^i]: stage n-1
            last[0] += 1
            if last[0] % 4 == 0:  # R: chk(ru, ld + rd), chk(ru, lu); L: ..
                return fn(a, b)
        z = table_zero(a, b)
        counts["chks"] += z.numel()
        zero.append(z.sum())
        return fn(a, b)

    bp.CHK_FNS[flavor] = counted
    try:
        yield counts
    finally:
        bp.CHK_FNS[flavor] = fn
    counts["zero"] = int(sum(zero)) if zero else 0


def bp_sweep_ops(chks):
    """Operations of the BP sweep's CHKs as counted_chks counted them, each
    with the add beside it (the sweep equations of models/bp.bp_iteration;
    at stage n-1 the R- and L-sweep share ld + rd)."""
    full, zero = CHK_BP_OPS[chks["flavor"]]
    return ((chks["chks"] - chks["zero"]) * full + chks["zero"] * zero
            + chks["chks"])


def bp_work(B, N, chks):
    """Bytes and operations of one fixed-iteration BP decode: LLRs and
    frozen row in, decisions out; the sweep's CHKs and adds that the run's
    inputs need (bp_sweep_ops)."""
    nbytes = B * N * 4 + N * 4 + B * N
    return nbytes, bp_sweep_ops(chks)


def wave_work(B, N, fused, chks, retire=None):
    """Bytes and operations of one wave of at least one iteration over B
    slots: per kept slot the planes an iteration reads, L[1..n] and R[0],
    in and those it writes, L[0..n-1] and R[1..n], out; per slot that the
    fused wave's `retire` mask ([B] bool, the one the kernel is given)
    merges, R[0] and its LLR row in and L[n] out besides the 2n; the mask
    in and u_hat and done out; the iterations' CHKs and adds as bp_work
    counts them (the decide's xors and compares are left out)."""
    mask = (isinstance(retire, torch.Tensor) and retire.dtype == torch.bool
            and tuple(retire.shape) == (B,))
    if (mask if fused else retire is not None) != fused:
        raise ValueError(f"wave_work: fused={fused} wants a [{B}] bool retire"
                         f" mask exactly when fused, got {retire!r:.60}")
    n = N.bit_length() - 1
    row = N * 4
    retired = int(retire.sum()) if fused else 0
    nbytes = (B - retired) * (n + 1 + 2 * n) * row
    if fused:
        nbytes += retired * (2 + 2 * n + 1) * row + B + B * N + B
    return nbytes, bp_sweep_ops(chks)


def noise_work(elements):
    """(operations, integer operations) of a threefry word and an LLR for
    each of `elements`."""
    int_ops = elements * (THREEFRY_INT_OPS + LLR_INT_OPS)
    return int_ops + elements * LLR_OPS, int_ops


def channel_branches(words):
    """(elements whose log1p takes the rational branch, elements whose
    erf_inv takes the sqrt branch) of the frame channel on the noise words
    [B, N], counted by a plain run of ops/noise's uniform and log1p on
    them."""
    from polardecoding_tpu_torch.ops.noise import (_LOG1P_SMALL, log1p_f32,
                                                   uniform_jax)

    u = uniform_jax(words)
    t = u * -u
    ge5 = ~(log1p_f32(t) > -5.0)
    return int((t.abs() < _LOG1P_SMALL).sum()), int(ge5.sum())


def frame_channel_work(B, N, small, ge5):
    """Bytes, operations and integer operations of the frame channel on B
    frames of N: x in, the LLRs out, the frame indices and the key in; a
    fold-in per frame; per element a two-word threefry block, the uniform,
    the LLR and the branch of log1p and of erf_inv it takes (`small`
    elements the rational log1p, `ge5` the sqrt branch; channel_branches
    counts them on the timed inputs)."""
    elements = B * N
    logs = elements - small
    int_ops = (B * THREEFRY2_INT_OPS
               + elements * (THREEFRY2_INT_OPS + FRAME_INT_OPS)
               + logs * LOG1P_LOG_INT_OPS)
    ops = (int_ops + elements * FRAME_OPS + small * LOG1P_SMALL_OPS
           + logs * LOG1P_LOG_OPS + ge5)
    return elements * 8 + B * 8 + 16, ops, int_ops


def mc_wave_work(B, N, refills, chks):
    """Bytes, operations and integer operations of one MC wave: state and
    meta [4, B, N] read and written once, the two tables read, stats
    written; the iterations' CHKs and adds as bp_work counts them, and a
    row of noise and LLR for each of this wave's `refills` (head merges and
    in-wave retirements)."""
    n = N.bit_length() - 1
    nbytes = 2 * (2 * (n + 1) + 4) * B * N * 4 + 2 * 128 * N * 4 + B * 3 * 4
    ops, int_ops = noise_work(refills * N)
    return nbytes, bp_sweep_ops(chks) + ops, int_ops


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
    phase_shapes()
    channel_worst = phase_frame_channel_compare()
    bp_worst = phase_compare()
    scl_worst = phase_scl_compare()
    r1_worst = phase_scl_r1_compare()
    # each frame-step path's decoder and frame channel launches; the
    # kernels line takes the frame channel's from the SCL_1024_L8 path
    counts = {}
    counts["bp_decode"], _ = phase_main(MAIN_PRESET, MAIN_BATCH,
                                        MAIN_ERROR_BLOCKS, BLER_RANGE,
                                        "bp_decode")
    counts["scl_decode"], counts["frame_channel"] = phase_main(
        SCL_PRESET, SCL_BATCH, SCL_ERROR_BLOCKS, SCL_BLER_RANGE, "scl_decode")
    r1_counts = {name: phase_main(name, SCL_BATCH, blocks, bler, "scl_decode_r1")[0]
                 for name, blocks, bler in R1_MAIN_PATHS}
    counts["scl_decode_r1"] = r1_counts[R1_PRESET]
    wave_worst = phase_wave_compare()
    counts["bp_wave_fused"], _ = phase_wave_main(
        f"{WAVE_PRESET} run_point (fused wave engine, K={WAVE_ITERS})",
        lambda: run_point(preset(WAVE_PRESET), MAIN_SNR, batch=WAVE_BATCH,
                          device=DEVICE, error_blocks=WAVE_ERROR_BLOCKS),
        "bp_wave_fused")
    counts["bp_wave_mc"], _ = phase_wave_main(
        f"{MC_PRESET} run_point_waves engine=mc K={MC_ITERS} cadence={MC_CADENCE}",
        lambda: run_point_waves(preset(MC_PRESET), MAIN_SNR, batch=WAVE_BATCH,
                                wave_iters=MC_ITERS, device=DEVICE,
                                error_blocks=WAVE_ERROR_BLOCKS, engine="mc",
                                cadence=MC_CADENCE), "bp_wave_mc")
    counts["bp_wave"], _ = phase_wave_main(
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
    phase_l32_step(card)
    # the CHKs that the timed decode's inputs need, from a plain run on them
    llr, fr, _ = llr_frames(MAIN_PRESET, MAIN_BATCH, MAIN_SNR, DEVICE)
    with counted_chks(preset(MAIN_PRESET).decoder.bp_flavor) as c:
        bp_decode(llr, fr, iters=100)
    chks = {"bp_decode": c}
    del llr, fr
    wave_times, k8_work = phase_wave_timing(card)
    for name, (ms, plain_ms, worst, c) in wave_times.items():
        times[name] = (ms, plain_ms, max(wave_worst[name], worst))
        chks[name] = c
    times["mc_channel"] = times["mc_channel"][:2] + (
        max(times["mc_channel"][2], channel_worst["mc_channel"]),)
    ms, plain_ms, worst, channel_work = phase_frame_channel_timing(card)
    times["frame_channel"] = (ms, plain_ms,
                              max(worst, channel_worst["frame_channel"]))
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
    probe_worst = phase_probe_compare()
    probe_counts, printed = phase_probe_paths()
    counts.update(probe_counts)
    probe_bounds = {}
    for name, (ms, plain_ms, work) in phase_probe_timing(
            card, printed, times["scl_decode"][0],
            times["scl_decode_r1"][0]).items():
        times[name] = (ms, plain_ms, probe_worst[name])
        probe_bounds[name] = work
    phase_bench()
    phase_bpr(card)
    ms, plain_ms, worst = times["frame_channel"]
    times["frame_channel"] = (ms, plain_ms,
                              max(worst, phase_sigma_table_compare()))
    phase_fused_sweep(card)
    phase_sweeps(card)
    golden_counts = phase_golden(card)
    phase_reproduce_pins(card)
    studies_counts = phase_studies_quick(card)
    queue_a_counts = phase_queue_a_quick(card)
    phase_multi_rank(card, times["mc_channel"][0])
    check("jax" not in sys.modules, "the port imported jax")

    p = preset(SCL_PRESET)
    frozen = code_tables(p.code, "cpu").frozen.tolist()
    N = p.code.N
    # this run's refills of an MC wave: its retirements at the steady state
    # of the profiled waves (at most one head merge or in-wave retirement
    # per retired frame)
    refills = int(mc(read=False)[2])
    bounds = {
        "bp_decode": bp_work(MAIN_BATCH, N, chks["bp_decode"]),
        "scl_decode": scl_work(SCL_BATCH, N, p.decoder.list_size, frozen),
        "scl_decode_r1": scl_work(SCL_BATCH, N, L, frozen, r1=r1),
        **k8_work,
        "bp_wave_mc": mc_wave_work(WAVE_BATCH, N, refills, chks["bp_wave_mc"]),
        "mc_channel": mc_channel_work(MC_CHANNEL_BATCH, N),
        "frame_channel": channel_work, **probe_bounds}
    emit({"chk_counts": {k: dict(c, zero_share=c["zero"] / c["chks"])
                         for k, c in chks.items() if c}})
    lines = []
    for name, (mod, _, key) in kernels().items():
        ms, plain_ms, worst = times[name]
        b_ms, b_by = bound(*bounds[name])
        lines.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": (mod.REPLACES[name] if isinstance(mod.REPLACES, dict)
                         else mod.REPLACES),
            "launches": counts[name],
            **({"golden_launches": golden_counts[name]}
               if name in golden_counts else {}),
            **({"studies_launches": studies_counts[name]}
               if name in studies_counts else {}),
            **({"queue_a_launches": queue_a_counts[name]}
               if name in queue_a_counts else {}),
            "max_abs_err": worst,
            "matches_plain": worst == 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
        sys.exit(0)
    sys.exit(main())
