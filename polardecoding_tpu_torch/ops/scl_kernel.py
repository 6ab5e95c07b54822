"""Wrapper of the hand-written CUDA list-decode kernel (csrc/scl_decode.cu), the
port of the TPU kernel polardecoding_tpu/ops/pallas/scl_fast_kernel.py
`scl_decode_fast` in both its modes: exact (r1=0) and the approximate
bounded-fork rate-1 flavor (r1 > 0), whose R1 nodes the kernel reads from a
per-leaf table built here from models/scl_fast.  It also stands for the
traced-mask kernels `scl_decode_subtree` and `scl_decode_tree`, which compute
the exact contract.  Its plain version is models/scl.scl_decode.

`LAUNCHES` counts the exact mode's launches and `LAUNCHES_R1` the flavor's,
so a run can show which of the two its main path went through.
"""
from __future__ import annotations

import ctypes

import torch

from polardecoding_tpu_torch.models.scl_fast import r1_stages
from polardecoding_tpu_torch.ops import _build

LAUNCHES = 0
LAUNCHES_R1 = 0
MAX_LIST = 32
SOURCE = "polardecoding_tpu_torch/csrc/scl_decode.cu"
REPLACES = "polardecoding_tpu/ops/pallas/scl_fast_kernel.py:866"


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
# (id(frozen), r1, wloop) -> (frozen, its version, leaf table, widest R1 node)
_TABLES: dict = {}


def _leaf_table(frozen: torch.Tensor, r1: int, wloop: int):
    """The kernel's per-leaf table (bit 0 frozen, bits 1.. the stage of an R1
    node starting there) on frozen's device and the widest R1 node's width,
    cached per mask tensor, r1 and wloop: the mask is read back to the host
    once, not at every call."""
    key = (id(frozen), r1, wloop)
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not frozen or hit[1] != frozen._version:
        mask = frozen.tolist()
        stages = r1_stages(mask, r1, wloop)
        table = torch.tensor([int(f) | (s << 1) for f, s in zip(mask, stages)],
                             dtype=torch.uint8, device=frozen.device)
        hit = _TABLES[key] = (frozen, frozen._version, table,
                              max(1 << s if s else 0 for s in stages))
    return hit[2], hit[3]


def scl_decode_cuda(ch_llr: torch.Tensor, frozen: torch.Tensor,
                    list_size: int = 8, r1: int = 0, wloop: int = 2):
    """Decode [B, N] float32 channel LLRs with SCL on the card, exact (r1=0)
    or with the rate-1 flavor on the R1 nodes of
    models/scl_fast.decompose(frozen, n, 0, wloop, r1).

    frozen: [N] bool on the same device.  Returns (u_all [B, L, N] int8,
    PM [B, L] float32, ties [B] int32), as models/scl.scl_decode with
    return_all=True, return_ties=True and the same r1 and wloop.  Launches on
    the current stream without synchronising; raises on any input the kernel
    does not take and when the launch is refused."""
    global LAUNCHES, LAUNCHES_R1
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
    if r1 < 0 or wloop < 2 or wloop & (wloop - 1):
        raise ValueError(f"r1={r1} must be >= 0 and wloop={wloop} a power of "
                         "two >= 2")
    L = list_size
    dev = ch_llr.device
    u_all = torch.empty((B, L, N), dtype=torch.int8, device=dev)
    PM = torch.empty((B, L), dtype=torch.float32, device=dev)
    ties = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return u_all, PM, ties
    if r1:
        table, widest = _leaf_table(frozen, r1, wloop)
    else:
        table, widest = frozen.to(torch.uint8).contiguous(), 0
    tmax = min(L - 1, widest)
    try:
        _build.launch("scl_decode", _ARGTYPES, dev, ch_llr.data_ptr(),
                      table.data_ptr(), u_all.data_ptr(), PM.data_ptr(),
                      ties.data_ptr(), B, N, L, tmax, int(widest > 0))
    except _build.LaunchError as e:
        smem_bytes = _build.load("scl_decode").scl_decode_smem_bytes
        smem_bytes.restype = ctypes.c_size_t
        raise _build.LaunchError(
            f"{e} at N={N}, L={L}, tmax={tmax} "
            f"({smem_bytes(ctypes.c_int(N), ctypes.c_int(L), ctypes.c_int(tmax))}"
            " bytes of shared memory)") from None
    if r1:
        LAUNCHES_R1 += 1
    else:
        LAUNCHES += 1
    return u_all, PM, ties
