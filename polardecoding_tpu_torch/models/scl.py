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
forces the plain version on any device.  `scl_decode_auto` opens the span
`decode.list` around the list decode on both paths, with the counts of
ops/scl_kernel.list_counts: r1, the R1 nodes of the node table and the
bits they decide, and on the kernel path `frames_per_sm`.

r1 > 0 selects the approximate bounded-fork rate-1 flavor of the TPU kernel
(scl_decode_fast(r1=...)): each all-info block of width >= max(r1, 2) that
models/scl_fast.decompose makes an R1 node is decided at once by
`_r1_node`, on every device; r1 = 0 is exact SCL.  The flavor is not exact
SCL: its fork costs are |alpha| at the node's input, without the lut(|l|)
terms of PHI.  Its reference is tests/scl_fast_ref.py.
"""
from __future__ import annotations

import torch

from polardecoding_tpu_torch.models._compact import (
    bit_phase,
    block_phase,
    llr_phase,
    ntz,
    slot,
)
from polardecoding_tpu_torch.models.sc import sc_decode
from polardecoding_tpu_torch.models.scl_fast import r1_stages
from polardecoding_tpu_torch.ops._build import use_kernel
from polardecoding_tpu_torch.ops.chk import phi_penalties_both
from polardecoding_tpu_torch.ops.crc import gf2_matmul
from polardecoding_tpu_torch.ops.encode import polar_encode
from polardecoding_tpu_torch.utils import trace

BIG = 1e30  # PM of inactive list slots


def default_wloop(n: int, L: int) -> int:
    """Loop-node width of the frozen-specialized schedule, as the JAX
    package's default_wloop (its measured table is empty: 2 everywhere).
    It decides which blocks become R1 nodes only when wloop >= r1."""
    return 2


def scl_decode(ch_llr: torch.Tensor, frozen: torch.Tensor, list_size: int = 8,
               return_all: bool = False, return_ties: bool = False,
               strict_median: bool = False, r1: int = 0, wloop: int = 2):
    """Decode a batch of frames with SCL (the plain version).

    ch_llr: [B, N]; frozen: [N] bool; list_size: L.
    Returns u_hat [B, N] int8 (min-PM path), or with return_all=True the tuple
    (u_all [B, L, N] int8, PM [B, L]).  return_ties=True appends the PM-tie
    counter [B] int32: the info bits at which the L-th and (L+1)-th smallest
    candidates were exactly equal, the reference's "Oops!" condition
    (SCL_1024.c:620-633).  strict_median=True is the reference's policy
    (keep only candidates strictly below the median); the surviving set and
    its PMs are the reference's, the slot numbering is JAX's.  r1 > 0 decodes
    the R1 nodes of decompose(frozen, n, 0, wloop, r1) with the rate-1 flavor
    (`_r1_node`) and every other bit as exact SCL does.
    """
    if strict_median and r1:
        raise ValueError("strict_median is a mode of exact SCL (r1=0)")
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

    fz = frozen.tolist()
    stages = r1_stages(fz, r1, wloop)
    j = 0
    while j < N:
        s, is_frozen = stages[j], fz[j]
        llr_phase(llr_c, bits_c, ch, ntz(j | N), n, stop=s)
        if s:
            alpha = ch if s == n else llr_c[..., slice(*slot(s))]
            x, PM, node_ties, parent = _r1_node(alpha, PM)
            ties = ties + node_ties
            parent = parent[..., None]
            llr_c = torch.take_along_dim(llr_c, parent, dim=1)
            bits_c = torch.take_along_dim(bits_c, parent, dim=1)
            u_all = torch.take_along_dim(u_all, parent, dim=1)
            w = 1 << s
            u_all[:, :, j:j + w] = polar_encode(x)  # the transform is its own inverse
            j += w
            block_phase(bits_c, x, min(ntz(j), n), n)
            continue
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
        j += 1

    if return_all:
        return (u_all, PM, ties) if return_ties else (u_all, PM)
    u_hat = _best(u_all, PM)
    return (u_hat, ties) if return_ties else u_hat


def _r1_node(alpha: torch.Tensor, PM: torch.Tensor):
    """An R1 node of width w by the bounded-fork rate-1 rule (the TPU
    kernel's run_r1, tests/scl_fast_ref.r1_node), batched over frames.

    alpha: [B, L, w] node-input LLRs per path; PM: [B, L].  Each path's hard
    decision is beta = (alpha < 0); flipping position e costs |alpha_e|.  Its
    t = min(L-1, w) least reliable positions (successive minima of |alpha|,
    first occurrence, each chosen one pushed up by BIG) are forked in that
    order, round k by the 2L -> L selection of every fork with penalties 0
    and mins[k], its candidate order, stable ties and tie counter.  Returns
    (x [B, L, w] int8 decided code block, PM, ties [B] int32, parent [B, L]:
    the path before the node that each path descends from)."""
    B, L, w = alpha.shape
    t = min(L - 1, w)
    dev = alpha.device
    ties = torch.zeros((B,), dtype=torch.int32, device=dev)
    parent = torch.arange(L, device=dev).expand(B, L)
    beta = (alpha < 0).to(torch.int8)
    if t == 0:
        return beta, PM, ties, parent
    xm = alpha.abs()
    mins, pos = [], []
    for _ in range(t):
        m = xm.amin(dim=-1, keepdim=True)
        e = (xm == m).to(torch.uint8).argmax(dim=-1, keepdim=True)  # the first
        mins.append(m[..., 0])
        pos.append(e[..., 0])
        xm = xm.scatter(-1, e, xm.gather(-1, e) + BIG)
    mins = torch.stack(mins, dim=-1)  # [B, L, t], per path before the node
    pos = torch.stack(pos, dim=-1)
    flips = torch.zeros((B, L, t), dtype=torch.int8, device=dev)
    for k in range(t):
        pen1 = torch.take_along_dim(mins[..., k], parent, dim=1)
        cand = torch.cat([PM + 0.0, PM + pen1], dim=-1)
        vals, idx = torch.sort(cand, dim=-1, stable=True)
        idx = idx[:, :L]
        tie = (vals[:, L - 1] == vals[:, L]) & (vals[:, L] < BIG / 2)
        ties = ties + tie.to(torch.int32)
        PM = vals[:, :L]
        parent_k = idx % L
        parent = torch.take_along_dim(parent, parent_k, dim=1)
        flips = torch.take_along_dim(flips, parent_k[..., None], dim=1)
        flips[..., k] = (idx >= L).to(torch.int8)
    x = torch.take_along_dim(beta, parent[..., None], dim=1)
    pos = torch.take_along_dim(pos, parent[..., None], dim=1)
    # a path's t positions are distinct
    x = x.scatter(-1, pos, x.gather(-1, pos) ^ flips)
    return x, PM, ties, parent


def _best(u_all, PM):
    """The min-PM path of each frame (the first one on a tie)."""
    best = torch.argmin(PM, dim=-1)
    return torch.take_along_dim(u_all, best[:, None, None], dim=1)[:, 0]


def scl_decode_auto(ch_llr: torch.Tensor, frozen: torch.Tensor,
                    list_size: int = 8, return_all: bool = False,
                    return_ties: bool = False, engine: str = "auto",
                    r1: int = 0, wloop: int = 2):
    """SCL with the CUDA list-decode kernel for a CUDA tensor and the plain
    version for a CPU tensor, exact (r1=0) or the rate-1 flavor on either,
    inside the span decode.list; same returns as `scl_decode`."""
    from polardecoding_tpu_torch.ops import scl_kernel

    kernel = use_kernel(ch_llr, engine, "scl_decode_auto")
    with trace.span("decode.list", lazy=lambda: scl_kernel.list_counts(
            frozen, list_size, r1, wloop, kernel)):
        if kernel:
            u_all, PM, ties = scl_kernel.scl_decode_cuda(
                ch_llr, frozen, list_size, r1=r1, wloop=wloop)
        else:
            u_all, PM, ties = scl_decode(ch_llr, frozen, list_size=list_size,
                                         return_all=True, return_ties=True,
                                         r1=r1, wloop=wloop)
    if return_all:
        return (u_all, PM, ties) if return_ties else (u_all, PM)
    u_hat = _best(u_all, PM)
    return (u_hat, ties) if return_ties else u_hat


def sc_decode_auto(ch_llr: torch.Tensor, frozen: torch.Tensor,
                   engine: str = "auto") -> torch.Tensor:
    """SC: the list-decode kernel at L=1 for a CUDA tensor (the L=1 path
    metric decides by the LLR's sign), models/sc.sc_decode otherwise."""
    if not use_kernel(ch_llr, engine, "sc_decode_auto"):
        return sc_decode(ch_llr, frozen)
    from polardecoding_tpu_torch.ops.scl_kernel import scl_decode_cuda

    return scl_decode_cuda(ch_llr, frozen, 1)[0][:, 0]


def cascl_select(u_all: torch.Tensor, PM: torch.Tensor,
                 info_positions: torch.Tensor, crc_R):
    """CA-SCL final selection (ref: CASCL_128.c:663-698): among CRC-passing
    paths pick min PM; if none pass, global min PM.

    u_all: [B, L, N]; info_positions: [K + r] int64 tensor of the bit
    channels carrying [message || CRC] in encode order; crc_R: the [K + r, r]
    check matrix (ops/crc.check_matrix) as numpy, or as float32 on u_all's
    device (ops/crc.device_matrix), used as it is.  The syndrome is a float32
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
                 return_ties: bool = False, engine: str = "auto",
                 r1: int = 0, wloop: int = 2):
    """CRC-aided SCL: SCL pass (exact, or the rate-1 flavor with r1 > 0) +
    CRC-filtered min-PM selection (the span decode.crc_select)."""
    u_all, PM, ties = scl_decode_auto(ch_llr, frozen, list_size=list_size,
                                      return_all=True, return_ties=True,
                                      engine=engine, r1=r1, wloop=wloop)
    with trace.span("decode.crc_select"):
        u_hat, _ = cascl_select(u_all, PM, info_positions, crc_R)
    return (u_hat, ties) if return_ties else u_hat
