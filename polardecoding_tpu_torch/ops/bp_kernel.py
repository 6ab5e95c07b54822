"""Wrapper of the hand-written CUDA BP decode kernel (csrc/bp_decode.cu), the
port of the TPU kernel polardecoding_tpu/ops/pallas/bp_kernel.py
`bp_decode_pallas`.  Its plain version is models/bp.bp_decode.

`LAUNCHES` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from polardecoding_tpu_torch.ops import _build

LAUNCHES = 0
FLAVORS = {"minsum_lut": 0, "minsum_lut_fast": 1, "spa": 2}
SOURCE = "polardecoding_tpu_torch/csrc/bp_decode.cu"
REPLACES = "polardecoding_tpu/ops/pallas/bp_kernel.py:771"


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5


def bp_decode_cuda(ch_llr: torch.Tensor, frozen: torch.Tensor, iters: int = 100,
                   flavor: str = "minsum_lut",
                   early_stop_every: int = 0) -> torch.Tensor:
    """Decode [B, N] float32 channel LLRs on the card with the CUDA kernel.

    frozen: [N] bool on the same device.  Returns u_hat [B, N] int8, as
    models/bp.bp_decode.  Launches on the current stream without
    synchronising; raises on any input the kernel does not take and when the
    launch is refused."""
    global LAUNCHES
    if ch_llr.device.type != "cuda":
        raise ValueError(f"bp_decode_cuda needs a CUDA tensor, got {ch_llr.device}")
    if ch_llr.dtype != torch.float32:
        raise ValueError(f"bp_decode_cuda takes float32 LLRs, got {ch_llr.dtype}")
    if ch_llr.ndim != 2 or not ch_llr.is_contiguous():
        raise ValueError("bp_decode_cuda takes a contiguous [B, N] tensor, "
                         f"got shape {tuple(ch_llr.shape)}")
    B, N = ch_llr.shape
    if N < 8 or N > 1024 or N & (N - 1):
        raise ValueError(f"N={N} must be a power of two in [8, 1024]")
    if (frozen.dtype != torch.bool or tuple(frozen.shape) != (N,)
            or frozen.device != ch_llr.device):
        raise ValueError("frozen must be a [N] bool tensor on the LLRs' device")
    if flavor not in FLAVORS:
        raise ValueError(f"unknown BP flavor {flavor!r}")
    if iters < 0 or early_stop_every < 0:
        raise ValueError("iters and early_stop_every must be >= 0")
    out = torch.empty((B, N), dtype=torch.int8, device=ch_llr.device)
    if B == 0:
        return out
    fr = torch.where(frozen, 999.0, 0.0).to(torch.float32).contiguous()
    _build.launch("bp_decode", _ARGTYPES, ch_llr.device, ch_llr.data_ptr(),
                  fr.data_ptr(), out.data_ptr(), B, N, iters, FLAVORS[flavor],
                  early_stop_every)
    LAUNCHES += 1
    return out
