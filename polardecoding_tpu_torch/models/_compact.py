"""Compact O(N)-state successive-cancellation substrate shared by SC and SCL
(torch port of polardecoding_tpu.models._compact).

While decoding bit j only ONE group per stage is live: stage i's live LLR
group is the block [(j >> i) << i, +2^i) and its live partial-sum group is
the upper half awaiting a partner.  So all per-path state packs into two
length-(N-1) arrays whose stage-i slot (size 2^i, offset 2^i - 1) holds the
current group:

  - llr slot i: stage-i LLRs of the current group (written by f/g updates);
  - bit slot i: the saved upper-half stage-i decided node values.

The stage-n LLRs are the (path-independent) channel LLRs, passed separately.
The per-bit schedule is:

  t  = ntz(j)   (n for j = 0): one g-update at stage t, then f-updates (CHK)
                at stages t-1 .. 0  -- `llr_phase`;
  t1 = ntz(j+1): after deciding bit j, combine partial sums upward through t1
                stages -- `bit_phase` (the reference's updateBit chain).

PyTorch runs eagerly, so t and t1 are Python ints (`ntz`) and each phase is
a plain loop over stages.  The functions take any leading shape: [B] for SC,
[B, L] for SCL.  Both phases write their slots in place and return the
array they were given.
"""
from __future__ import annotations

import torch

from polardecoding_tpu_torch.ops.chk import chk


def slot(i: int):
    """Slice bounds of the stage-i slot in a compact array."""
    return (1 << i) - 1, (2 << i) - 1


def _read(arr, i: int):
    lo, hi = slot(i)
    return arr[..., lo:hi]


def _write(arr, i: int, val):
    lo, hi = slot(i)
    arr[..., lo:hi] = val
    return arr


def _stage_src(llr_c, ch, i: int, n: int):
    """Stage-(i+1) LLR source for an update at stage i: slot i+1, or the
    channel when i+1 == n.  `ch` must already broadcast to the leading shape
    of llr_c."""
    if i + 1 == n:
        return ch
    return _read(llr_c, i + 1)


def llr_phase(llr_c, bits_c, ch, t: int, n: int, stop: int = 0):
    """All LLR recomputation for one bit given t = ntz(j) (t = n for j = 0):
    g-node at stage t (lower half: partner bits saved in bit slot t), then
    f-nodes (CHK) at stages t-1 .. stop (ref: SC_128.c:344-365).  stop > 0
    ends the descent at the input of a node of that stage starting at bit
    j."""
    if t < n:
        src = _stage_src(llr_c, ch, t, n)
        w = 1 << t
        up, lo = src[..., :w], src[..., w:]
        sgn = (1 - 2 * _read(bits_c, t)).to(src.dtype)
        _write(llr_c, t, lo + sgn * up)
    for i in range(t - 1, stop - 1, -1):
        src = _stage_src(llr_c, ch, i, n)
        w = 1 << i
        _write(llr_c, i, chk(src[..., :w], src[..., w:]))
    return llr_c


def bit_phase(bits_c, u, t1: int, n: int):
    """Partial-sum propagation after deciding bit j, t1 = ntz(j+1): combine
    [saved_upper ^ v, v] upward through t1 stages, then save the result as the
    next pending upper half (ref: SC_128.c:367-392).  `u` has the leading
    shape of bits_c (int8)."""
    return block_phase(bits_c, u[..., None], t1, n)


def block_phase(bits_c, x, t1: int, n: int):
    """bit_phase after a node of stage s whose decided code block x [..., 2^s]
    (int8) ends at bit j, t1 = ntz(j+1) >= s: combine upward from stage s
    (s = 0: one bit)."""
    v = x
    for i in range(x.shape[-1].bit_length() - 1, t1):
        v = torch.cat([_read(bits_c, i) ^ v, v], dim=-1)
    if t1 < n:
        _write(bits_c, t1, v)
    return bits_c


def ntz(x: int) -> int:
    """Number of trailing zeros of a positive int."""
    return (x & -x).bit_length() - 1
