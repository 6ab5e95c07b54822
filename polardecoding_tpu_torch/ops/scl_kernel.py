"""Wrapper of the hand-written CUDA list-decode kernel (csrc/scl_decode.cu), the
port of the TPU kernel polardecoding_tpu/ops/pallas/scl_fast_kernel.py
`scl_decode_fast` in both its modes: exact (r1=0) and the approximate
bounded-fork rate-1 flavor (r1 > 0).  It also stands for the traced-mask
kernels `scl_decode_subtree` and `scl_decode_tree`, which compute the exact
contract.  Its plain version is models/scl.scl_decode.

The kernel decodes one frame per warp on a schedule read at run time: the
node table of `leaf_codes`, built here from models/scl_fast.decompose, marks
the first leaf of each all-frozen (R0), repetition (REP) and rate-1 (R1)
node with its kind and stage; every other leaf runs bit by bit.  Exact mode
uses the R0 and REP nodes of decompose(frozen, n, 0, 2, 0), which decode
exactly as bit-by-bit SCL does; the flavor those of decompose(frozen, n, 0,
wloop, r1) and its R1 nodes.

`LAUNCHES` counts the exact mode's launches and `LAUNCHES_R1` the flavor's,
so a run can show which of the two its main path went through;
`LAUNCHES_TOP_REGS` counts the exact launches whose instantiation keeps the
stage n-1 LLR row in the warp's registers (N=1024 at L=8, 16 and 32, as
the library's `kernel_info` reports), a part of `LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from polardecoding_tpu_torch.models.scl_fast import nodes
from polardecoding_tpu_torch.ops import _build

LAUNCHES = 0
LAUNCHES_R1 = 0
LAUNCHES_TOP_REGS = 0
MAX_LIST = 32
SOURCE = "polardecoding_tpu_torch/csrc/scl_decode.cu"
REPLACES = "polardecoding_tpu/ops/pallas/scl_fast_kernel.py:866"
# the table's node kinds (bits 5-6; bits 1-4 the stage, bit 0 frozen)
KINDS = {"r0": 1, "rep": 2, "r1": 3}
EXACT_WLOOP = 2

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
# (id(frozen), r1, wloop) -> (frozen, its version, table, widest R1 node)
_TABLES: dict = {}
# (N, L, flavor) -> kernel_info
_INFO: dict = {}


def kernel_info(N: int, list_size: int, r1: int = 0) -> dict:
    """The instantiation that decodes (N, list_size) in exact mode (r1=0) or
    the rate-1 flavor, from the library's scl_decode_kernel_info: its
    registers and local memory (spills) per thread, and whether it keeps
    the stage n-1 row in registers (`top_regs`).  Cached per shape."""
    key = (N, list_size, r1 > 0)
    info = _INFO.get(key)
    if info is None:
        fn = _build.load("scl_decode").scl_decode_kernel_info
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_size_t),
                                            ctypes.POINTER(ctypes.c_int)]
        regs, top, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_size_t()
        rc = fn(N, list_size, int(r1 > 0), ctypes.byref(regs),
                ctypes.byref(local), ctypes.byref(top))
        if rc != 0:
            raise _build.LaunchError(f"scl_decode_kernel_info failed ({rc}) "
                                     f"at N={N}, L={list_size}, r1={r1}")
        info = _INFO[key] = {"registers": regs.value,
                             "local_bytes": local.value,
                             "top_regs": bool(top.value)}
    return info


def leaf_codes(frozen, r1: int = 0, wloop: int = EXACT_WLOOP) -> list[int]:
    """The kernel's node table for a frozen mask: per leaf, bit 0 frozen and,
    at the first leaf of an R0, REP or R1 node of stage s >= 1, s << 1 and
    its kind << 5.  An R0 or REP node of width N/2 starting at leaf N/2 is
    entered as its two halves (R0 and the node's kind): its input, the
    stage n-1 LLRs after bit N/2, is one of two values per element in the
    kernel, not a row per path in which to descend."""
    mask = tuple(bool(b) for b in frozen)
    N = len(mask)
    n = N.bit_length() - 1
    codes = [int(f) for f in mask]
    for nd in nodes(mask, r1, wloop):
        if nd.kind not in KINDS:
            continue
        parts = [(nd.kind, nd.stage, nd.off)]
        if nd.kind != "r1" and nd.stage == n - 1 and nd.off == N // 2:
            q = N // 4
            parts = [("r0", nd.stage - 1, nd.off), (nd.kind, nd.stage - 1, nd.off + q)]
        for kind, s, off in parts:
            if s >= 1:
                codes[off] = int(mask[off]) | s << 1 | KINDS[kind] << 5
    return codes


def _leaf_table(frozen: torch.Tensor, r1: int, wloop: int):
    """The node table on frozen's device and the widest R1 node's width,
    cached per mask tensor, r1 and wloop: the mask is read back to the host
    once, not at every call."""
    key = (id(frozen), r1, wloop)
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not frozen or hit[1] != frozen._version:
        codes = leaf_codes(frozen.tolist(), r1, wloop)
        table = torch.tensor(codes, dtype=torch.uint8, device=frozen.device)
        widest = max((1 << ((c >> 1) & 15) for c in codes
                      if c >> 5 == KINDS["r1"]), default=0)
        hit = _TABLES[key] = (frozen, frozen._version, table, widest)
    return hit[2], hit[3]


def _outputs(out, B: int, L: int, N: int, dev):
    specs = (((B, L, N), torch.int8), ((B, L), torch.float32),
             ((B,), torch.int32))
    if out is None:
        return tuple(torch.empty(s, dtype=d, device=dev) for s, d in specs)
    if len(out) != 3 or any(
            tuple(t.shape) != s or t.dtype != d or t.device != dev
            or not t.is_contiguous() for t, (s, d) in zip(out, specs)):
        raise ValueError("out must be contiguous (u_all, PM, ties) of shapes "
                         f"{[s for s, _ in specs]}, types int8, float32, "
                         "int32 on the LLRs' device")
    if out[0].data_ptr() % 16:
        raise ValueError("out's u_all must be 16-byte aligned")
    return tuple(out)


def scl_decode_cuda(ch_llr: torch.Tensor, frozen: torch.Tensor,
                    list_size: int = 8, r1: int = 0, wloop: int = 2, *,
                    out=None):
    """Decode [B, N] float32 channel LLRs with SCL on the card, exact (r1=0)
    or with the rate-1 flavor on the R1 nodes of
    models/scl_fast.decompose(frozen, n, 0, wloop, r1).

    frozen: [N] bool on the same device.  Returns (u_all [B, L, N] int8,
    PM [B, L] float32, ties [B] int32), as models/scl.scl_decode with
    return_all=True, return_ties=True and the same r1 and wloop, written
    into `out` (such a tuple on the LLRs' device, u_all 16-byte aligned)
    when it is given.  Launches on the current stream without
    synchronising; raises on any input the kernel does not take and when
    the launch is refused."""
    global LAUNCHES, LAUNCHES_R1, LAUNCHES_TOP_REGS
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
    u_all, PM, ties = _outputs(out, B, L, N, dev)
    if B == 0:
        return u_all, PM, ties
    table, widest = _leaf_table(frozen, r1, wloop if r1 else EXACT_WLOOP)
    tmax = min(L - 1, widest)
    xwords = max(1, widest // 32) if widest else 0
    try:
        _build.launch("scl_decode", _ARGTYPES, dev, ch_llr.data_ptr(),
                      table.data_ptr(), u_all.data_ptr(), PM.data_ptr(),
                      ties.data_ptr(), B, N, L, tmax, xwords, int(widest > 0))
    except _build.LaunchError as e:
        frame_bytes = _build.load("scl_decode").scl_decode_frame_bytes
        frame_bytes.restype = ctypes.c_size_t
        nbytes = frame_bytes(*(ctypes.c_int(v) for v in (N, L, tmax, xwords)))
        raise _build.LaunchError(
            f"{e} at N={N}, L={L}, tmax={tmax} ({nbytes} bytes of shared "
            "memory per frame)") from None
    if r1:
        LAUNCHES_R1 += 1
    else:
        LAUNCHES += 1
        LAUNCHES_TOP_REGS += kernel_info(N, L)["top_regs"]
    return u_all, PM, ties
