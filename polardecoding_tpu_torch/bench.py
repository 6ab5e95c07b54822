"""Headline benchmark of the port: decoded frames/s on the two north-star
configurations (the JAX package's bench.py).

  python -m polardecoding_tpu_torch.bench                # on the card
  python -m polardecoding_tpu_torch.bench --device cpu   # plain versions

Prints ONE JSON line with bench.py's keys: `value` is the worse of the BP
early-stop wave leg and the SCL leg (the headline cannot hide the slower
decoder), `bp_1024_fixed100_fps` the 100-iteration BP frame step,
`scl_fps` the SCL preset's frame step (default SCL_1024_L8_FASTR1, the
rate-1 flavor) and `scl_1024_l8_fps` the exact decoder's, each against the
1e7 frames/s north star.  Rates are rounded to 0.1 and the ratios to
1e-4, as bench.py rounds them.  The metric names the device it ran on.

Each leg runs the full Monte-Carlo pipeline (payload, encode, channel,
decode, count) through the port's entry points: make_frame_step, and
make_wave_step_mc (the default in-kernel-MC engine, K=32, cadence 2) or
make_wave_step for the wave leg.  A leg's rate is frames over the wall
clock between two synchronisations, after warmup, with one host read of
the summed counters; wave steps run in chunks of `steps_per_call` with their
retired-frame counts summed on the device.

Options of bench.py that name the TPU's hardware generators exit non-zero:
`--prng rbg` and `--wave-noise hw`.  bench_step's and bench_waves' `mesh`
(parallel/mesh.DataMesh; default data_mesh(), the default process group's
mesh under torch.distributed) splits each global batch over the ranks, as
bench.py's mesh shards it; the MC wave engine has no mesh path and raises
on more than one rank.  Without a card the run exits non-zero unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from polardecoding_tpu_torch.configs import preset
from polardecoding_tpu_torch.ops.channel import prng_key
from polardecoding_tpu_torch.parallel.harness import (
    make_frame_step,
    make_wave_step,
    make_wave_step_mc,
)
from polardecoding_tpu_torch.parallel.mesh import data_mesh

BASELINE_FRAMES_PER_SEC = 1e7
# bench.py's TPU-only choices: the TPU's RngBitGenerator and hardware PRNG
TPU_ONLY = {"prng": "rbg", "wave_noise": "hw"}


def _device(device) -> torch.device:
    """The run's device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the card; "
                           "device='cpu' runs the plain versions")
    return device


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sigma(snr_db: float) -> float:
    return 10.0 ** (-snr_db / 20.0)


@contextlib.contextmanager
def _profile(profile_dir, label):
    """A torch.profiler trace of the block, written to
    profile_dir/<label>.json (a Chrome trace), when profile_dir is set."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"{label}.json"))


def bench_step(preset_name, batch, snr_db=2.0, iters=5, warmup=2,
               profile_dir=None, encoder="mxu", channel="threefry",
               device="cuda", mesh=None):
    """frames/s of the full MC pipeline (gen + encode + channel + decode +
    count) for one preset at one SNR, through make_frame_step.
    channel="mc" uses the MC channel kernel (ops/channel_kernel.py).  Over
    a mesh, `batch` is global and the rate counts every rank's frames."""
    mesh = data_mesh(device=_device(device)) if mesh is None else mesh
    device = mesh.device
    p = preset(preset_name)
    step = make_frame_step(p, batch, device, encoder=encoder, channel=channel,
                           mesh=mesh)
    key = prng_key(p.sweep.seed, device)
    sigma = _sigma(snr_db)
    for i in range(warmup):
        int(step(key, i * batch, sigma)[0])
    with _profile(profile_dir, preset_name):
        _sync(device)
        t0 = time.perf_counter()
        outs = [step(key, (warmup + i) * batch, sigma) for i in range(iters)]
        # the steps run in order: one host read of the summed counters
        # proves that all of them finished
        int(sum(o[0] for o in outs))
        dt = time.perf_counter() - t0
    return iters * batch / dt


def bench_waves(preset_name="BP_1024", batch=16384, snr_db=2.0, wave_iters=8,
                steps=12, warmup=3, fused=True, encoder="mxu", check_every=0,
                steps_per_call=8, engine="fused", noise="kernel", cadence=1,
                itermax=0, device="cuda", mesh=None):
    """Steady-state retired frames/s of the continuous-batching BP engine:
    engine="fused" (make_wave_step, with `fused`, `encoder` and
    `check_every`) or "mc" (make_wave_step_mc, with `noise` and `cadence`;
    ValueError on a mesh of more than one rank).  Over a mesh, `batch` is
    global and the rate counts every rank's retirements.

    Steps run in chunks of `steps_per_call`, each chunk's retired frames
    summed on the device; `warmup` chunks first, then `steps` chunks timed
    between two synchronisations with one host read.  itermax overrides the
    preset's BP iterMax."""
    mesh = data_mesh(device=_device(device)) if mesh is None else mesh
    device = mesh.device
    if noise == TPU_ONLY["wave_noise"]:
        raise ValueError("noise='hw' is the TPU's hardware PRNG; the card "
                         "draws 'kernel' (counter threefry) or 'threefry'")
    p = preset(preset_name)
    if itermax:
        p = dataclasses.replace(
            p, name=f"{p.name}_I{itermax}",
            decoder=dataclasses.replace(p.decoder, bp_iters=itermax))
    if engine == "mc":
        init, step, _ = make_wave_step_mc(p, batch, wave_iters, device,
                                          noise=noise, cadence=cadence,
                                          mesh=mesh)
    elif engine == "fused":
        init, step, _ = make_wave_step(p, batch, wave_iters, device,
                                       fused=fused, encoder=encoder,
                                       check_every=check_every, mesh=mesh)
    else:
        raise ValueError(f"unknown wave engine {engine!r}")
    key = prng_key(p.sweep.seed, device)
    sigma = _sigma(snr_db)

    def chunk(carry):
        total = 0
        for _ in range(steps_per_call):
            carry, (_, _, fr) = step(key, sigma, carry)
            total = total + fr
        return carry, total

    carry = init(key, 0, sigma)
    last = None
    for _ in range(warmup):
        carry, last = chunk(carry)
    if last is not None:
        int(last)
    _sync(device)
    t0 = time.perf_counter()
    frs = []
    for _ in range(steps):
        carry, fr = chunk(carry)
        frs.append(fr)
    # one device-side sum, one host read
    frames = int(sum(frs))
    return frames / (time.perf_counter() - t0)


def _parser():
    ap = argparse.ArgumentParser(prog="polardecoding_tpu_torch.bench")
    ap.add_argument("--bp-batch", type=int, default=8192)
    ap.add_argument("--scl-batch", type=int, default=16384)
    ap.add_argument("--wave-batch", type=int, default=16384)
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--profile", nargs="?", const="chiprun_out/pd_trace",
                    default=None,
                    help="write a torch.profiler trace of the BP leg there")
    ap.add_argument("--skip-wave", action="store_true")
    ap.add_argument("--unfused-wave", action="store_true",
                    help="the unfused wave kernel (with --wave-engine fused)")
    ap.add_argument("--prng", choices=("threefry", "rbg"), default="threefry",
                    help="channel PRNG; rbg is the TPU's RngBitGenerator and "
                         "exits non-zero here")
    ap.add_argument("--encoder", choices=("mxu", "butterfly"), default="mxu")
    ap.add_argument("--wave-k", type=int, default=0,
                    help="wave_iters K (0 = per-engine default: 8 fused, "
                         "32 mc)")
    ap.add_argument("--wave-cadence", type=int, default=2,
                    help="mc-engine retire-check cadence")
    ap.add_argument("--wave-itermax", type=int, default=0,
                    help="override the preset's BP iterMax for the wave leg "
                         "(0 = preset value)")
    ap.add_argument("--channel", choices=("threefry", "mc"),
                    default="threefry",
                    help="frame-step channel of the SCL leg")
    ap.add_argument("--wave-engine", choices=("fused", "mc"), default="mc")
    ap.add_argument("--wave-noise", choices=("kernel", "hw", "threefry"),
                    default="kernel",
                    help="mc engine bit source; hw is the TPU's hardware "
                         "PRNG and exits non-zero here")
    ap.add_argument("--wave-check-every", type=int, default=0)
    ap.add_argument("--wave-preset", default="BP_1024_FASTCHK")
    ap.add_argument("--scl-preset", default="SCL_1024_L8_FASTR1")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    for opt, value in TPU_ONLY.items():
        if getattr(args, opt) == value:
            ap.error(f"--{opt.replace('_', '-')} {value} is the TPU's "
                     "hardware generator; the port has no counterpart")
    try:
        device = _device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    bp_fixed_fps = bench_step("BP_1024", args.bp_batch, args.snr, args.iters,
                              args.warmup, profile_dir=args.profile,
                              encoder=args.encoder, device=device)
    scl_fps = bench_step(args.scl_preset, args.scl_batch, args.snr,
                         args.iters, args.warmup, encoder=args.encoder,
                         channel=args.channel, device=device)
    # the exact decoder's rate always under its own key
    scl_exact_fps = (scl_fps if args.scl_preset == "SCL_1024_L8" else
                     bench_step("SCL_1024_L8", args.scl_batch, args.snr,
                                args.iters, args.warmup, encoder=args.encoder,
                                device=device))
    bp_wave_fps = None
    if not args.skip_wave:
        wave_k = args.wave_k or (32 if args.wave_engine == "mc" else 8)
        bp_wave_fps = bench_waves(args.wave_preset, args.wave_batch, args.snr,
                                  wave_iters=wave_k,
                                  fused=not args.unfused_wave,
                                  encoder=args.encoder,
                                  check_every=args.wave_check_every,
                                  engine=args.wave_engine,
                                  noise=args.wave_noise,
                                  cadence=args.wave_cadence,
                                  itermax=args.wave_itermax, device=device)

    bp_fps = bp_fixed_fps if bp_wave_fps is None else bp_wave_fps
    worst = min(bp_fps, scl_fps)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu, plain versions")
    rec = {
        "metric": "decoded frames/s at N=1024, 1 device "
                  f"({where}) — min(BP early-stop wave engine, SCL L=8), "
                  f"full MC pipeline at {args.snr:g} dB",
        "value": round(worst, 1),
        "unit": "frames/s",
        "vs_baseline": round(worst / BASELINE_FRAMES_PER_SEC, 4),
        "bp_1024_wave_fps": None if bp_wave_fps is None
        else round(bp_wave_fps, 1),
        "wave_preset": None if bp_wave_fps is None else args.wave_preset,
        "wave_engine": None if bp_wave_fps is None else args.wave_engine,
        "wave_itermax": None if bp_wave_fps is None
        else (args.wave_itermax or preset(args.wave_preset).decoder.bp_iters),
        "bp_1024_fixed100_fps": round(bp_fixed_fps, 1),
        "scl_preset": args.scl_preset,
        "scl_fps": round(scl_fps, 1),
        "scl_1024_l8_fps": round(scl_exact_fps, 1),
        "vs_baseline_fixed_iters": round(
            min(bp_fixed_fps, scl_fps) / BASELINE_FRAMES_PER_SEC, 4),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
