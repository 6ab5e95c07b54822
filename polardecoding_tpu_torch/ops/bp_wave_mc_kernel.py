"""Wrapper of the hand-written CUDA in-kernel MC wave kernel
(csrc/bp_wave_mc.cu), the port of the TPU kernel
polardecoding_tpu/ops/pallas/bp_kernel.py `bp_wave_mc_pallas`.  Its plain
version is models/bp.bp_wave_mc_plain.

The kernel updates state and meta in place, as the TPU kernel does through
input_output_aliases.  `LAUNCHES` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from polardecoding_tpu_torch.ops import _build
from polardecoding_tpu_torch.ops.bp_kernel import FLAVORS, launch_shape
from polardecoding_tpu_torch.ops.bp_wave_kernel import check_state
from polardecoding_tpu_torch.ops.channel_kernel import words32
from polardecoding_tpu_torch.ops.noise import MASK32

LAUNCHES = 0
SOURCE = "polardecoding_tpu_torch/csrc/bp_wave_mc.cu"
REPLACES = "polardecoding_tpu/ops/pallas/bp_kernel.py:640"


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_uint32] * 3
             + [ctypes.c_int] * 9)


def bp_wave_mc_shape(N: int, flavor: str = "minsum_lut") -> dict:
    """The kernel's launch shape at (N, flavor) on the current card
    (ops/bp_kernel.launch_shape)."""
    return launch_shape("bp_wave_mc", "bp_wave_mc_shape", N, FLAVORS[flavor])


def bp_wave_mc_cuda(state, meta, u_table, x_table, sigma, seeds, bits=None,
                    iters: int = 8, flavor: str = "minsum_lut",
                    tile: int = 0, interpret: bool = False, rolls: int = 3,
                    iter_max: int = 100, delta: int = 0, drain: bool = False,
                    spares: int = 2, cadence: int = 1, out=None):
    """One MC wave on the card -> (state, meta, both updated in place;
    stats [B, 3] float32, written into `out` when given).

    state [2(n+1), B, N] and meta [4, B, N] float32; u_table and x_table
    [128, N] float32; sigma a float; seeds 4 words (k0, k1, k0 ^ k1, step);
    bits None for the counter noise, else [spares, B, N] 32-bit words.
    tile, interpret and rolls are the TPU kernel's knobs, accepted and
    unused.  Launches on the current stream without synchronising; raises
    on any input the kernel does not take and when the launch is
    refused."""
    global LAUNCHES
    B, N = check_state(state, "bp_wave_mc_cuda")
    dev = state.device
    if (meta.dtype != torch.float32 or tuple(meta.shape) != (4, B, N)
            or meta.device != dev or not meta.is_contiguous()):
        raise ValueError(f"meta must be a contiguous [4, {B}, {N}] float32 "
                         "tensor on the state's device")
    for name, tab in (("u_table", u_table), ("x_table", x_table)):
        if (tab.dtype != torch.float32 or tuple(tab.shape) != (128, N)
                or tab.device != dev):
            raise ValueError(f"{name} must be a [128, {N}] float32 tensor on "
                             "the state's device")
    if bits is not None:
        if tuple(bits.shape) != (spares, B, N) or bits.device != dev:
            raise ValueError(f"bits must be [{spares}, {B}, {N}] on the "
                             "state's device")
        bits = words32(bits)
    if flavor not in FLAVORS:
        raise ValueError(f"unknown BP flavor {flavor!r}")
    if iters < 0 or spares < 1 or cadence < 1 or delta < 0:
        raise ValueError("need iters >= 0, spares >= 1, cadence >= 1, delta >= 0")
    if out is None:
        stats = torch.empty((B, 3), dtype=torch.float32, device=dev)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (B, 3)
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{B}, 3] float32 tensor "
                         "on the state's device")
    else:
        stats = out
    if B == 0:
        return state, meta, stats
    utab, xtab = u_table.contiguous(), x_table.contiguous()
    k0, k1, _, step = (int(s) & MASK32 for s in seeds)
    _build.launch(
        "bp_wave_mc", _ARGTYPES, dev, state.data_ptr(), meta.data_ptr(),
        utab.data_ptr(), xtab.data_ptr(),
        None if bits is None else bits.data_ptr(), stats.data_ptr(),
        float(sigma), k0, k1, step, B, N, iters, FLAVORS[flavor], iter_max,
        delta, int(drain), spares, cadence)
    LAUNCHES += 1
    return state, meta, stats
