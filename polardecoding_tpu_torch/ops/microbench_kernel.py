"""The SCL kernel's operation patterns iterated on tiles (csrc/microbench_rolls.cu),
the port of the TPU microbenchmark scripts/microbench_rolls.py, and their
plain versions.

A tile is [rows, 8, 128] float32, path p on lanes [p W, (p + 1) W), W =
128 / L; x holds `copies` independent tiles, [copies, rows, 8, 128].  The
plain versions compute the JAX bodies' recurrences in their order, with an
fma (ops/noise.fma, exact) where the JAX package's CPU build contracts a
product into the following add: that build is the reference
(tests/test_torch_probes.py holds them bit-equal to the JAX bodies run
through pallas_call(interpret=True)).  `microbench_cuda` runs one tile per
block of the card; `LAUNCHES` counts its launches.  OPS_PER_ITER are the
TPU script's operation counts per iteration and tile, kept so that the two
rates read alike.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from polardecoding_tpu_torch.ops import _build
from polardecoding_tpu_torch.ops.chk import chk, lut_correction
from polardecoding_tpu_torch.ops.noise import fma

LAUNCHES = 0
SOURCE = "polardecoding_tpu_torch/csrc/microbench_rolls.cu"
REPLACES = "scripts/microbench_rolls.py:164"
LANES = 128
KINDS = ("gather", "gather_rows", "lut", "rank", "chk")
_PATTERN = {"gather": 0, "gather_rows": 0, "lut": 1, "rank": 2, "chk": 3}
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5


def ops_per_iter(kind: str, L: int = 8, rows: int = 8) -> int:
    """Operations per iteration and tile as scripts/microbench_rolls.py
    counts them (:141-162): gather L x (roll, mask, mul, add) per lane, lut
    14 + 4, rank L x 12 + 5 on one row, chk 47 + 3 on rows / 2 rows."""
    vreg = 8 * LANES
    if kind in ("gather", "gather_rows"):
        return L * 4 * rows * vreg
    if kind == "lut":
        return (14 + 4) * rows * vreg
    if kind == "rank":
        return (L * 12 + 5) * rows * vreg
    if kind == "chk":
        return (47 + 3) * (rows // 2) * vreg
    raise ValueError(f"unknown pattern {kind!r}")


def _f32(v: float) -> float:
    return float(np.float32(v))


@functools.lru_cache(maxsize=None)
def _consts(device):
    """The f32 constants of the bodies as 0-dim tensors on one device."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return {"one": c(1.0), "zero": c(0.0), "half": c(0.5), "k1e6": c(1e-6),
            "k10001": c(1.0001), "k0001": c(0.001)}


def _paths(L: int, device):
    """Path index of each of the 128 lanes."""
    if L < 1 or LANES % L:
        raise ValueError(f"L={L} must divide {LANES}")
    return torch.arange(LANES, device=device) // (LANES // L)


def _roll(a, d, L):
    return torch.roll(a, d * (LANES // L), dims=-1)


def gather_plain(x, iters: int, L: int = 8):
    """_gather_kernel: out = sum_d mask_d * roll(a, d W), a = out * 0.5, with
    mask_d = 1.0 where (p - d) mod L == p."""
    c = _consts(x.device)
    p = _paths(L, x.device)
    masks = [torch.where((p - d) % L == p, c["one"], c["zero"])
             for d in range(L)]
    a = x
    for _ in range(iters):
        out = torch.zeros_like(a)
        for d in range(L):
            out = out + masks[d] * _roll(a, d, L)
        a = out * c["half"]
    return a


def gather_rows_plain(x, iters: int, L: int = 8):
    """_gather_rows_kernel: _gather_kernel's recurrence on every row of the
    tile."""
    return gather_plain(x, iters, L)


def lut_plain(x, iters: int):
    """_lut_kernel: a = fma(a, 0.9999, lut(|a|) * 0.001)."""
    c = _consts(x.device)
    a = x
    for _ in range(iters):
        a = fma(a, _f32(0.9999), lut_correction(torch.abs(a)) * c["k0001"])
    return a


def rank_plain(x, iters: int, L: int = 8):
    """_rank_kernel: the 2L-candidate rank counts of c0 = a and c1 = a *
    1.0001 against their rolls, then a = fma(rank1, 1e-6, fma(a, 0.9999,
    rank0 * 1e-6))."""
    c = _consts(x.device)
    p = _paths(L, x.device)
    pf = (p % L).to(torch.float32)
    pmd = [((p - d) % L).to(torch.float32) for d in range(L)]
    a = x
    for _ in range(iters):
        c0 = a
        c1 = c0 * c["k10001"]
        rank0 = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
        rank1 = torch.zeros_like(rank0)
        for d in range(L):
            silt = pmd[d] < pf
            r0, r1 = _roll(c0, d, L), _roll(c1, d, L)
            rank0 = rank0 + ((r0 < c0) | ((r0 == c0) & silt)) + (r1 < c0)
            rank1 = (rank1 + ((r0 < c1) | (r0 == c1))
                     + ((r1 < c1) | ((r1 == c1) & silt)))
        a = fma(rank1.to(torch.float32), _f32(1e-6),
                fma(c0, _f32(0.9999), rank0.to(torch.float32) * c["k1e6"]))
    return a


def chk_plain(x, iters: int):
    """_chk_kernel: (up, dn) -> (chk(up, dn), fma(up, 0.999, dn)), up the
    first rows / 2 rows of each tile."""
    rows = x.shape[-3]
    if rows % 2:
        raise ValueError(f"chk needs an even row count, got {rows}")
    a = x
    for _ in range(iters):
        up, dn = a[..., : rows // 2, :, :], a[..., rows // 2:, :, :]
        a = torch.cat([chk(up, dn), fma(up, _f32(0.999), dn)], dim=-3)
    return a


def microbench_plain(kind: str, x, iters: int, L: int = 8):
    """The plain version of one pattern."""
    if kind in ("gather", "gather_rows"):
        return gather_plain(x, iters, L)
    if kind == "rank":
        return rank_plain(x, iters, L)
    if kind == "lut":
        return lut_plain(x, iters)
    if kind == "chk":
        return chk_plain(x, iters)
    raise ValueError(f"unknown pattern {kind!r}")


def microbench_cuda(kind: str, x, iters: int, L: int = 8):
    """One pattern on the card, one tile of x [copies, rows, 8, 128] float32
    per block; returns the tiles after `iters` iterations.  L in {8, 32} for
    gather and rank.  Launches on the current stream without synchronising;
    raises on any input the kernel does not take and when the launch is
    refused."""
    global LAUNCHES
    if kind not in KINDS:
        raise ValueError(f"unknown pattern {kind!r}")
    if x.device.type != "cuda":
        raise ValueError(f"microbench_cuda needs a CUDA tensor, got {x.device}")
    if (x.dtype != torch.float32 or x.ndim != 4 or tuple(x.shape[2:]) != (8, LANES)
            or not x.is_contiguous()):
        raise ValueError("x must be a contiguous [copies, rows, 8, 128] float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    copies, rows = x.shape[:2]
    if kind in ("gather", "gather_rows", "rank") and L not in (8, 32):
        raise ValueError(f"L={L}: the kernel is built for L in (8, 32)")
    if kind == "chk" and rows % 2:
        raise ValueError(f"chk needs an even row count, got {rows}")
    if iters < 0:
        raise ValueError(f"iters={iters} must be >= 0")
    out = torch.empty_like(x)
    if copies == 0 or rows == 0:
        return out
    _build.launch("microbench_rolls", _ARGTYPES, x.device, x.data_ptr(),
                  out.data_ptr(), _PATTERN[kind], L, rows, copies, iters)
    LAUNCHES += 1
    return out
