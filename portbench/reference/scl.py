"""Successive-cancellation list decoding with the CRC-aided selection
(SCL_1024.c:546-680, CASCL_128.c:538-699), exact, batched over frames with
the list as a tensor axis, in any float dtype.

  - L paths; the path metric grows by PHI(l, u) (chk.phi_both) at every bit;
  - at a frozen bit every path takes u = 0; at an info bit the 2L
    candidates [PM + PHI(l, 0), PM + PHI(l, 1)] are sorted stably and the L
    smallest survive (inactive paths carry PM = BIG, so the doubling phase
    is the same rule); slot k of the new list is the candidate of rank k;
  - a tie between the L-th and (L+1)-th candidates below BIG / 2 is the
    reference's "Oops!" and is counted per frame;
  - CA-SCL answers the least-PM path among those whose CRC passes, else
    the least-PM path (the first on equal metrics).

Per path only the live LLR group and the pending partial sums of each
stage are kept: two arrays of N - 1 whose stage-i slot is
[2^i - 1, 2^(i+1) - 1).  Bit j recomputes the g node at stage ntz(j) and
the f nodes below it, and after its decision combines the partial sums
up through ntz(j + 1) stages (SC_128.c:344-392)."""
from __future__ import annotations

import torch

from portbench.reference.chk import chk, phi_both
from portbench.reference.code import crc_ok

BIG = 1e30


def _slot(i: int):
    return (1 << i) - 1, (2 << i) - 1


def _ntz(x: int) -> int:
    return (x & -x).bit_length() - 1


def _src(llr_c, ch, i: int, n: int):
    if i + 1 == n:
        return ch
    lo, hi = _slot(i + 1)
    return llr_c[..., lo:hi]


def _llr_phase(llr_c, bits_c, ch, t: int, n: int):
    if t < n:
        src = _src(llr_c, ch, t, n)
        w = 1 << t
        lo, hi = _slot(t)
        sgn = (1 - 2 * bits_c[..., lo:hi]).to(src.dtype)
        llr_c[..., lo:hi] = src[..., w:] + sgn * src[..., :w]
    for i in range(t - 1, -1, -1):
        src = _src(llr_c, ch, i, n)
        w = 1 << i
        lo, hi = _slot(i)
        llr_c[..., lo:hi] = chk(src[..., :w], src[..., w:])


def _bit_phase(bits_c, u, t1: int, n: int):
    v = u[..., None]
    for i in range(t1):
        lo, hi = _slot(i)
        v = torch.cat([bits_c[..., lo:hi] ^ v, v], dim=-1)
    if t1 < n:
        lo, hi = _slot(t1)
        bits_c[..., lo:hi] = v


def scl_decode(llr: torch.Tensor, frozen: torch.Tensor, L: int):
    """(u_all [B, L, N] int8, PM [B, L], ties [B] int32) of the LLRs
    [B, N] in their dtype."""
    B, N = llr.shape
    n = N.bit_length() - 1
    dt, dev = llr.dtype, llr.device
    llr_c = torch.zeros((B, L, N - 1), dtype=dt, device=dev)
    bits_c = torch.zeros((B, L, N - 1), dtype=torch.int8, device=dev)
    u_all = torch.zeros((B, L, N), dtype=torch.int8, device=dev)
    PM = torch.full((B, L), BIG, dtype=dt, device=dev)
    PM[:, 0] = 0.0
    ties = torch.zeros((B,), dtype=torch.int32, device=dev)
    ch = llr[:, None, :].expand(B, L, N)
    zero = torch.zeros((B, L), dtype=torch.int8, device=dev)
    for j, is_frozen in enumerate(frozen.tolist()):
        _llr_phase(llr_c, bits_c, ch, _ntz(j | N), n)
        pen0, pen1 = phi_both(llr_c[..., 0])
        if is_frozen:
            PM = PM + pen0
            u = zero
        else:
            vals, idx = torch.sort(torch.cat([PM + pen0, PM + pen1], dim=-1),
                                   dim=-1, stable=True)
            idx = idx[:, :L]
            parent = (idx % L)[..., None]
            u = (idx >= L).to(torch.int8)
            tie = (vals[:, L - 1] == vals[:, L]) & (vals[:, L] < BIG / 2)
            ties = ties + tie.to(torch.int32)
            PM = vals[:, :L]
            llr_c = torch.take_along_dim(llr_c, parent, dim=1)
            bits_c = torch.take_along_dim(bits_c, parent, dim=1)
            u_all = torch.take_along_dim(u_all, parent, dim=1)
        u_all[:, :, j] = u
        _bit_phase(bits_c, u, min(_ntz(j + 1), n), n)
    return u_all, PM, ties


def cascl_select(u_all, PM, info: torch.Tensor, rem) -> torch.Tensor:
    """u_hat [B, N]: the least-PM path whose bits at the info set pass the
    CRC (rem: its remainders, code.crc_remainders on the device), else the
    least-PM path; without a CRC (rem None) the least-PM path."""
    best = torch.argmin(PM, dim=-1)
    if rem is not None:
        ok = crc_ok(u_all[..., info], rem)
        passed = torch.argmin(torch.where(ok, PM, torch.inf), dim=-1)
        best = torch.where(ok.any(dim=-1), passed, best)
    return torch.take_along_dim(u_all, best[:, None, None], dim=1)[:, 0]
