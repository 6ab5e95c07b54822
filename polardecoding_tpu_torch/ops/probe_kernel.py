"""The floor under the SCL list-decode kernel: a kernel with its launch shape
and outputs that decodes nothing (csrc/probe_floor.cu), the port of the TPU
floor probes scripts/probe_floor.py, probe_floor2.py and probe_floor3.py.

`floor_cuda` (the kernel) and `floor_plain` (its plain version, constant
outputs) take the switches of those probes' variants: `init` zero-fills a
frame's shared memory (probe_floor's "init"), `scratch=False` gives a frame
no shared memory beyond its LLR row ("noscratch"), `dma_in=False` never reads
the LLRs ("no_in"), `u_dtype=torch.int32` ("u_i32"), `u_rows=1` ("no_u"),
and `ties=False` leaves out the tie counter (the two-output probes).
`floor_burst` and `floor_graph` are probe_floor3's back-to-back
calls and its lax.scan, here k launches on one stream and one CUDA graph
of k launches.  `LAUNCHES` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from polardecoding_tpu_torch.ops import _build, scl_kernel

LAUNCHES = 0
SOURCE = "polardecoding_tpu_torch/csrc/probe_floor.cu"
REPLACES = {"probe_floor": "scripts/probe_floor.py:77",
            "probe_floor2": "scripts/probe_floor2.py:63",
            "probe_floor3": "scripts/probe_floor3.py:40"}

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10


def scl_shape(B: int, N: int, list_size: int, tmax: int = 0,
              xwords: int = 0) -> dict:
    """csrc/scl_decode.cu's launch shape for B frames at (N, L) in exact mode,
    or in the rate-1 flavor with R1 scratch for tmax forks and xwords packed
    words (xwords > 0), from the library's own scl_decode_shape and
    scl_decode_kernel_info: threads and blocks of the grid, frames per block
    (a warp each), resident blocks per SM and frames per SM, the block's
    dynamic shared memory and one frame's part of it, and the
    instantiation's registers and local memory per thread (spills) and
    whether it keeps the stage n-1 row in registers."""
    lib = _build.load("scl_decode")
    threads, blocks, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_size_t()
    r1 = int(xwords > 0)
    rc = lib.scl_decode_shape(B, N, list_size, tmax, xwords, r1,
                              ctypes.byref(threads), ctypes.byref(blocks),
                              ctypes.byref(smem), ctypes.byref(per_sm))
    if rc != 0:
        raise _build.LaunchError(f"scl_decode_shape failed ({rc}) at B={B}, "
                                 f"N={N}, L={list_size}, tmax={tmax}, "
                                 f"xwords={xwords}")
    frame = lib.scl_decode_frame_bytes
    frame.restype = ctypes.c_size_t
    return {"threads": threads.value, "blocks": blocks.value,
            "frames_per_block": threads.value // 32,
            "blocks_per_sm": per_sm.value,
            "frames_per_sm": threads.value // 32 * per_sm.value,
            "smem_bytes": smem.value,
            "frame_bytes": int(frame(N, list_size, tmax, xwords)),
            **scl_kernel.kernel_info(N, list_size, r1)}


def _check(ch, leaf, list_size, u_dtype, u_rows):
    if ch.dtype != torch.float32 or ch.ndim != 2:
        raise ValueError(f"ch must be a [B, N] float32 tensor, got {ch.dtype} "
                         f"{tuple(ch.shape)}")
    B, N = ch.shape
    if leaf is not None and (leaf.dtype != torch.uint8
                             or tuple(leaf.shape) != (N,)
                             or leaf.device != ch.device):
        raise ValueError("leaf must be a [N] uint8 tensor on ch's device")
    if list_size < 1:
        raise ValueError(f"list_size={list_size} must be >= 1")
    if u_dtype not in (torch.int8, torch.int32):
        raise ValueError(f"u_dtype must be int8 or int32, got {u_dtype}")
    u_rows = N if u_rows is None else u_rows
    if u_rows < 1:
        raise ValueError(f"u_rows={u_rows} must be >= 1")
    return B, N, u_rows


def floor_plain(ch, leaf=None, list_size: int = 8, *, init: bool = False,
                scratch: bool = True, dma_in: bool = True,
                u_dtype=torch.int8, u_rows=None, ties: bool = True):
    """What the floor kernel returns for ch [B, N] float32: (u [B, L,
    u_rows] of u_dtype, pm [B, L] float32, ties [B] int32 or None), all
    zeros; u_rows defaults to N.  The switches change only the kernel's
    work."""
    B, _, u_rows = _check(ch, leaf, list_size, u_dtype, u_rows)
    dev = ch.device
    u = torch.zeros((B, list_size, u_rows), dtype=u_dtype, device=dev)
    pm = torch.zeros((B, list_size), dtype=torch.float32, device=dev)
    return u, pm, (torch.zeros(B, dtype=torch.int32, device=dev) if ties
                   else None)


def floor_cuda(ch, leaf=None, list_size: int = 8, *, init: bool = False,
               scratch: bool = True, dma_in: bool = True, u_dtype=torch.int8,
               u_rows=None, ties: bool = True, out=None):
    """The floor kernel on the card over the frames of ch [B, N] with
    csrc/scl_decode.cu's launch shape at (B, N, list_size): its grid, a warp
    per frame and (scratch=True) a frame's shared memory; returns floor_plain's outputs, written into `out` (a
    (u, pm, ties) of floor_plain's shapes and types on ch's device) when it
    is given.  Launches on the current stream without synchronising; raises
    on any input the kernel does not take and when the launch is refused."""
    global LAUNCHES
    if ch.device.type != "cuda":
        raise ValueError(f"floor_cuda needs a CUDA tensor, got {ch.device}")
    B, N, u_rows = _check(ch, leaf, list_size, u_dtype, u_rows)
    if not ch.is_contiguous():
        raise ValueError("floor_cuda takes a contiguous [B, N] tensor")
    dev = ch.device
    specs = (((B, list_size, u_rows), u_dtype), ((B, list_size), torch.float32),
             ((B,), torch.int32) if ties else None)
    if out is None:
        out = tuple(None if s is None else torch.empty(s[0], dtype=s[1], device=dev)
                    for s in specs)
    elif len(out) != 3 or any(
            (t is None) != (s is None) or t is not None and (
                tuple(t.shape) != s[0] or t.dtype != s[1] or t.device != dev
                or not t.is_contiguous())
            for t, s in zip(out, specs)):
        raise ValueError("out must be contiguous (u, pm, ties) of floor_plain's "
                         "shapes and types on ch's device")
    u, pm, tie = out
    if B == 0:
        return u, pm, tie
    shape = scl_shape(B, N, list_size)
    frame = shape["frame_bytes"] if scratch else 0
    if dma_in:
        frame = max(frame, (4 * N + 15) // 16 * 16)
    _build.launch("probe_floor", _ARGTYPES, dev, ch.data_ptr(),
                  None if leaf is None else leaf.data_ptr(), u.data_ptr(),
                  pm.data_ptr(), None if tie is None else tie.data_ptr(), B, N,
                  list_size, u_rows, int(u_dtype == torch.int32),
                  shape["threads"], shape["blocks"], frame, int(init),
                  int(dma_in))
    LAUNCHES += 1
    return u, pm, tie


def floor_burst(k: int, ch, leaf=None, list_size: int = 8, **kw):
    """k launches of the floor kernel back to back on the current stream,
    without synchronising (probe_floor3's k calls inside one jit); returns
    the last launch's outputs."""
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    for _ in range(k):
        out = floor_cuda(ch, leaf, list_size, **kw)
    return out


def floor_graph(k: int, ch, leaf=None, list_size: int = 8, **kw):
    """k launches of the floor kernel captured once in a CUDA graph
    (probe_floor3's lax.scan of k calls).  Returns replay(): one replay of
    the graph on the current stream, without synchronising, which counts its
    k launches; the capture itself launches nothing and counts nothing."""
    global LAUNCHES
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    floor_cuda(ch, leaf, list_size, **kw)  # builds and loads before capture
    torch.cuda.synchronize(ch.device)
    graph = torch.cuda.CUDAGraph()
    before = LAUNCHES
    with torch.cuda.graph(graph):
        outs = [floor_cuda(ch, leaf, list_size, **kw) for _ in range(k)]
    LAUNCHES = before

    def replay():
        global LAUNCHES
        graph.replay()
        LAUNCHES += k
        return outs[-1]

    return replay
