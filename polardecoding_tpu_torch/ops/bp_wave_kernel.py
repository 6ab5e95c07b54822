"""Wrappers of the hand-written CUDA wave kernel (csrc/bp_wave.cu), the port
of two TPU kernels of polardecoding_tpu/ops/pallas/bp_kernel.py:
`bp_wave_cuda` of `bp_wave_pallas` and `bp_wave_fused_cuda` of
`bp_wave_fused_pallas`.  Their plain versions are models/bp.bp_wave_plain
and bp_wave_fused_plain.

Both update the state in place, as the TPU kernels do through
input_output_aliases, and return it.  `LAUNCHES` counts each kernel's
launches, so a run can show that its main path went through them.
"""
from __future__ import annotations

import ctypes

import torch

from polardecoding_tpu_torch.ops import _build
from polardecoding_tpu_torch.ops.bp_kernel import FLAVORS

LAUNCHES = {"bp_wave_fused": 0, "bp_wave": 0}
SOURCE = "polardecoding_tpu_torch/csrc/bp_wave.cu"
REPLACES = {"bp_wave_fused": "polardecoding_tpu/ops/pallas/bp_kernel.py:306",
            "bp_wave": "polardecoding_tpu/ops/pallas/bp_kernel.py:726"}


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6


def check_state(state: torch.Tensor, who: str):
    """Raise unless state is a contiguous [2(n+1), B, N] float32 CUDA tensor
    with N a power of two in [8, 1024]; returns (B, N)."""
    if state.device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA tensor, got {state.device}")
    if state.dtype != torch.float32 or state.ndim != 3 or not state.is_contiguous():
        raise ValueError(f"{who} takes a contiguous [2(n+1), B, N] float32 "
                         f"state, got {state.dtype} {tuple(state.shape)}")
    S2, B, N = state.shape
    if N < 8 or N > 1024 or N & (N - 1) or S2 != 2 * N.bit_length():
        raise ValueError(f"{who}: state {tuple(state.shape)} is not "
                         "[2(n+1), B, 2^n] with 2^n in [8, 1024]")
    return B, N


def _launch(name, state, llr, retire, u, done, iters, flavor, fused,
            check_every):
    B, N = state.shape[1:]
    if flavor not in FLAVORS:
        raise ValueError(f"unknown BP flavor {flavor!r}")
    if iters < 0 or check_every < 0:
        raise ValueError("iters and check_every must be >= 0")
    if B == 0:
        return
    ptr = (lambda t: None if t is None else t.data_ptr())
    _build.launch("bp_wave", _ARGTYPES, state.device, state.data_ptr(),
                  ptr(llr), ptr(retire), ptr(u), ptr(done), B, N, iters,
                  FLAVORS[flavor], fused, check_every)
    LAUNCHES[name] += 1


def bp_wave_cuda(state: torch.Tensor, iters: int = 8,
                 flavor: str = "minsum_lut", tile: int = 0,
                 interpret: bool = False) -> torch.Tensor:
    """Advance state [2(n+1), B, N] float32 by `iters` iterations on the
    card, in place; returns state.  tile and interpret are the TPU kernel's
    knobs, accepted and unused.  Launches on the current stream without
    synchronising; raises on any input the kernel does not take and when
    the launch is refused."""
    check_state(state, "bp_wave_cuda")
    _launch("bp_wave", state, None, None, None, None, iters, flavor, 0, 0)
    return state


def bp_wave_fused_cuda(state: torch.Tensor, llr: torch.Tensor,
                       retire: torch.Tensor, iters: int = 8,
                       flavor: str = "minsum_lut", tile: int = 0,
                       interpret: bool = False, rolls: int = 3,
                       check_every: int = 0):
    """The fused wave on the card: the slots where retire [B] is True
    restart from llr [B, N], then `iters` iterations and the G-matrix
    decide.  Returns (state, updated in place; u_hat [B, N] int8; done [B]
    bool).  tile, interpret and rolls are the TPU kernel's knobs, accepted
    and unused."""
    B, N = check_state(state, "bp_wave_fused_cuda")
    if (llr.dtype != torch.float32 or tuple(llr.shape) != (B, N)
            or llr.device != state.device):
        raise ValueError(f"llr must be a [{B}, {N}] float32 tensor on the "
                         "state's device")
    if (retire.dtype != torch.bool or tuple(retire.shape) != (B,)
            or retire.device != state.device):
        raise ValueError(f"retire must be a [{B}] bool tensor on the state's "
                         "device")
    u_hat = torch.empty((B, N), dtype=torch.int8, device=state.device)
    done = torch.empty(B, dtype=torch.bool, device=state.device)
    _launch("bp_wave_fused", state, llr.contiguous(), retire.contiguous(),
            u_hat, done, iters, flavor, 1, check_every)
    return state, u_hat, done
