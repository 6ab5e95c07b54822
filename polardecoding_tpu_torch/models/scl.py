"""SC list decoding (SCL) and CRC-aided SCL, batched over frames with the list
as a tensor axis (torch port of polardecoding_tpu.models.scl).

Reference semantics (SCL_1024.c:546-680, CASCL_128.c:538-699):
  - L parallel graph copies; LLR-based path metric with the table-approximated
    PHI update (SCL_1024.c:481-502);
  - phase A doubles active paths until L; phase B builds 2L PM candidates per
    info bit, takes med = PMcand[L] as the survival threshold and repacks
    survivors (SCL_1024.c:581-661);
  - the answer is the min-PM path; CA-SCL picks the min-PM path among those
    that pass the CRC, else the global min-PM path (CASCL_128.c:663-698).

As in the JAX engine, both growth phases are one rule: inactive paths carry
PM = BIG, and selection keeps the L smallest of the 2L candidates
cand = [PM + PHI(l, 0), PM + PHI(l, 1)], ties going to the lower candidate
index.  JAX takes them with `lax.top_k(-cand, L+1)`; here a stable ascending
sort gives the same order (torch.topk promises none on ties).  Slot k of
the new list is the candidate of rank k: parent = idx % L, bit = idx >= L.

`scl_decode` is the plain version, bit-equal to the JAX engine: u_all, PM
and tie counter.  `scl_decode_auto`, `sc_decode_auto` and `cascl_decode`
send a CUDA tensor to the hand-written list-decode kernel
(ops/scl_kernel.py) and a CPU tensor to the plain version; engine="plain"
forces the plain version on any device.  The approximate rate-1 flavor of
the TPU kernel is not ported (parallel/harness.py refuses its presets).
"""
from __future__ import annotations

import torch

from polardecoding_tpu_torch.models._compact import bit_phase, llr_phase, ntz
from polardecoding_tpu_torch.models.sc import sc_decode
from polardecoding_tpu_torch.ops.chk import phi_penalties_both
from polardecoding_tpu_torch.ops.crc import gf2_matmul

BIG = 1e30  # PM of inactive list slots
ENGINES = ("auto", "plain")


def scl_decode(ch_llr: torch.Tensor, frozen: torch.Tensor, list_size: int = 8,
               return_all: bool = False, return_ties: bool = False,
               strict_median: bool = False):
    """Decode a batch of frames with SCL (the plain version).

    ch_llr: [B, N]; frozen: [N] bool; list_size: L.
    Returns u_hat [B, N] int8 (min-PM path), or with return_all=True the tuple
    (u_all [B, L, N] int8, PM [B, L]).  return_ties=True appends the PM-tie
    counter [B] int32: the info bits at which the L-th and (L+1)-th smallest
    candidates were exactly equal, the reference's "Oops!" condition
    (SCL_1024.c:620-633).  strict_median=True is the reference's policy
    (keep only candidates strictly below the median); the surviving set and
    its PMs are the reference's, the slot numbering is JAX's.
    """
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    L = list_size
    dt, dev = ch_llr.dtype, ch_llr.device

    llr_c = torch.zeros((B, L, N - 1), dtype=dt, device=dev)
    bits_c = torch.zeros((B, L, N - 1), dtype=torch.int8, device=dev)
    u_all = torch.zeros((B, L, N), dtype=torch.int8, device=dev)
    PM = torch.full((B, L), BIG, dtype=dt, device=dev)
    PM[:, 0] = 0.0
    ties = torch.zeros((B,), dtype=torch.int32, device=dev)
    ch = ch_llr[:, None, :].expand(B, L, N)
    zero = torch.zeros((B, L), dtype=torch.int8, device=dev)

    for j, is_frozen in enumerate(frozen.tolist()):
        llr_phase(llr_c, bits_c, ch, ntz(j | N), n)
        pen0, pen1 = phi_penalties_both(llr_c[..., 0])
        if is_frozen:
            # every path takes u = 0 and pays PHI(l, 0) (SCL_1024.c:663-666)
            PM = PM + pen0
            u = zero
        else:
            cand = torch.cat([PM + pen0, PM + pen1], dim=-1)  # [B, 2L]
            vals, idx = torch.sort(cand, dim=-1, stable=True)
            idx = idx[:, :L]
            parent = (idx % L)[..., None]
            u = (idx >= L).to(torch.int8)
            # the reference's "Oops!": the L-th and (L+1)-th candidates tie,
            # outside the BIG sentinels of the doubling phase
            tie = (vals[:, L - 1] == vals[:, L]) & (vals[:, L] < BIG / 2)
            ties = ties + tie.to(torch.int32)
            PM = vals[:, :L]
            if strict_median:
                PM = torch.where(PM < vals[:, L:L + 1], PM, BIG)
            llr_c = torch.take_along_dim(llr_c, parent, dim=1)
            bits_c = torch.take_along_dim(bits_c, parent, dim=1)
            u_all = torch.take_along_dim(u_all, parent, dim=1)
        u_all[:, :, j] = u
        bit_phase(bits_c, u, min(ntz(j + 1), n), n)

    if return_all:
        return (u_all, PM, ties) if return_ties else (u_all, PM)
    u_hat = _best(u_all, PM)
    return (u_hat, ties) if return_ties else u_hat


def _best(u_all, PM):
    """The min-PM path of each frame (the first one on a tie)."""
    best = torch.argmin(PM, dim=-1)
    return torch.take_along_dim(u_all, best[:, None, None], dim=1)[:, 0]


def _check(engine: str):
    if engine not in ENGINES:
        raise ValueError(f"unknown SCL engine {engine!r}")


def _use_kernel(ch_llr, engine: str) -> bool:
    return engine == "auto" and ch_llr.device.type != "cpu"


def scl_decode_auto(ch_llr: torch.Tensor, frozen: torch.Tensor,
                    list_size: int = 8, return_all: bool = False,
                    return_ties: bool = False, engine: str = "auto"):
    """SCL with the CUDA list-decode kernel for a CUDA tensor and the plain
    version for a CPU tensor; same returns as `scl_decode`."""
    _check(engine)
    if not _use_kernel(ch_llr, engine):
        return scl_decode(ch_llr, frozen, list_size=list_size,
                          return_all=return_all, return_ties=return_ties)
    from polardecoding_tpu_torch.ops.scl_kernel import scl_decode_cuda

    u_all, PM, ties = scl_decode_cuda(ch_llr, frozen, list_size)
    if return_all:
        return (u_all, PM, ties) if return_ties else (u_all, PM)
    u_hat = _best(u_all, PM)
    return (u_hat, ties) if return_ties else u_hat


def sc_decode_auto(ch_llr: torch.Tensor, frozen: torch.Tensor,
                   engine: str = "auto") -> torch.Tensor:
    """SC: the list-decode kernel at L=1 for a CUDA tensor (the L=1 path
    metric decides by the LLR's sign), models/sc.sc_decode otherwise."""
    _check(engine)
    if not _use_kernel(ch_llr, engine):
        return sc_decode(ch_llr, frozen)
    from polardecoding_tpu_torch.ops.scl_kernel import scl_decode_cuda

    return scl_decode_cuda(ch_llr, frozen, 1)[0][:, 0]


def cascl_select(u_all: torch.Tensor, PM: torch.Tensor,
                 info_positions: torch.Tensor, crc_R):
    """CA-SCL final selection (ref: CASCL_128.c:663-698): among CRC-passing
    paths pick min PM; if none pass, global min PM.

    u_all: [B, L, N]; info_positions: [K + r] int64 tensor of the bit
    channels carrying [message || CRC] in encode order; crc_R: [K + r, r]
    numpy check matrix (ops/crc.check_matrix).  The syndrome is a float32
    product of 0/1 values, exact for sums below 2^24.  Returns
    (u_hat [B, N], passed [B] bool)."""
    cw = u_all[..., info_positions]  # [B, L, K+r]
    ok = (gf2_matmul(cw, crc_R) == 0).all(dim=-1)  # [B, L]
    PMm = torch.where(ok, PM, torch.inf)
    any_ok = ok.any(dim=-1)
    best = torch.where(any_ok, torch.argmin(PMm, dim=-1),
                       torch.argmin(PM, dim=-1))
    u_hat = torch.take_along_dim(u_all, best[:, None, None], dim=1)[:, 0]
    return u_hat, any_ok


def cascl_decode(ch_llr: torch.Tensor, frozen: torch.Tensor,
                 info_positions: torch.Tensor, crc_R, list_size: int = 8,
                 return_ties: bool = False, engine: str = "auto"):
    """CRC-aided SCL: SCL pass + CRC-filtered min-PM selection."""
    u_all, PM, ties = scl_decode_auto(ch_llr, frozen, list_size=list_size,
                                      return_all=True, return_ties=True,
                                      engine=engine)
    u_hat, _ = cascl_select(u_all, PM, info_positions, crc_R)
    return (u_hat, ties) if return_ties else u_hat
