"""Wrapper of the hand-written CUDA list-decode kernel (csrc/scl_decode.cu), the
port of the TPU kernel polardecoding_tpu/ops/pallas/scl_fast_kernel.py
`scl_decode_fast` in its exact mode (and of the traced-mask kernels
`scl_decode_subtree` and `scl_decode_tree`, which compute the same
contract).  Its plain version is models/scl.scl_decode.

`LAUNCHES` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from polardecoding_tpu_torch.ops import _build

LAUNCHES = 0
MAX_LIST = 32
SOURCE = "polardecoding_tpu_torch/csrc/scl_decode.cu"
REPLACES = "polardecoding_tpu/ops/pallas/scl_fast_kernel.py:866"


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3


def scl_decode_cuda(ch_llr: torch.Tensor, frozen: torch.Tensor,
                    list_size: int = 8):
    """Decode [B, N] float32 channel LLRs with SCL on the card.

    frozen: [N] bool on the same device.  Returns (u_all [B, L, N] int8,
    PM [B, L] float32, ties [B] int32), as models/scl.scl_decode with
    return_all=True, return_ties=True.  Launches on the current stream
    without synchronising; raises on any input the kernel does not take and
    when the launch is refused."""
    global LAUNCHES
    if ch_llr.device.type != "cuda":
        raise ValueError(f"scl_decode_cuda needs a CUDA tensor, got {ch_llr.device}")
    if ch_llr.dtype != torch.float32:
        raise ValueError(f"scl_decode_cuda takes float32 LLRs, got {ch_llr.dtype}")
    if ch_llr.ndim != 2 or not ch_llr.is_contiguous():
        raise ValueError("scl_decode_cuda takes a contiguous [B, N] tensor, "
                         f"got shape {tuple(ch_llr.shape)}")
    B, N = ch_llr.shape
    if N < 2 or N > 1024 or N & (N - 1):
        raise ValueError(f"N={N} must be a power of two in [2, 1024]")
    if not 1 <= list_size <= MAX_LIST:
        raise ValueError(f"list_size={list_size} must lie in [1, {MAX_LIST}]")
    if (frozen.dtype != torch.bool or tuple(frozen.shape) != (N,)
            or frozen.device != ch_llr.device):
        raise ValueError("frozen must be a [N] bool tensor on the LLRs' device")
    L = list_size
    dev = ch_llr.device
    u_all = torch.empty((B, L, N), dtype=torch.int8, device=dev)
    PM = torch.empty((B, L), dtype=torch.float32, device=dev)
    ties = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return u_all, PM, ties
    fz = frozen.to(torch.uint8).contiguous()
    try:
        _build.launch("scl_decode", _ARGTYPES, dev, ch_llr.data_ptr(),
                      fz.data_ptr(), u_all.data_ptr(), PM.data_ptr(),
                      ties.data_ptr(), B, N, L)
    except _build.LaunchError as e:
        smem_bytes = _build.load("scl_decode").scl_decode_smem_bytes
        smem_bytes.restype = ctypes.c_size_t
        raise _build.LaunchError(
            f"{e} at N={N}, L={L} "
            f"({smem_bytes(ctypes.c_int(N), ctypes.c_int(L))} bytes of shared "
            "memory)") from None
    LAUNCHES += 1
    return u_all, PM, ties
