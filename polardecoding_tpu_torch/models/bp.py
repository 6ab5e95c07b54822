"""Belief-propagation decoder: flooding sweeps over the butterfly graph
(torch port of polardecoding_tpu.models.bp).

Reference semantics (BP_128.c:334-389, BP_1024.c, BP_128_fag.c:349-403):
  - messages: left-going L[i, p] and right-going R[i, p] on an (n+1) x N lattice;
    L[n] = channel LLR (fixed), R[0] = 999 on frozen / 0 on info (fixed);
  - one iteration = R-sweep over stages 0..n-1 (Gauss-Seidel: stage i+1 reads the
    stage-i R just written) then L-sweep over stages n-1..0;
  - per-butterfly updates with the table-corrected min-sum CHK:
        R'[i+1, u] = CHK(R[i, u], L[i+1, d] + R[i, d])
        R'[i+1, d] = R[i, d] + CHK(R[i, u], L[i+1, u])
        L'[i, u]   = CHK(L[i+1, u], L[i+1, d] + R[i, d])
        L'[i, d]   = L[i+1, d] + CHK(R[i, u], L[i+1, u])
  - decision after iterMax iterations: u_hat = sign(L[0] + R[0]) on info bits.

`bp_decode` is the plain version: stage i's butterflies are a reshape of the
N axis into [N/2d, 2, d] (d = 2^i) and a batched elementwise CHK over the
halves, with the operations in the JAX engine's order, so it is bit-equal to
it.  `bp_decode_auto` sends a CUDA tensor to the hand-written kernel
(ops/bp_kernel.py) and runs the plain version on a CPU tensor.

Optional early stopping (extension beyond the reference): with
`early_stop_every > 0`, every that many iterations the current hard decision
is re-encoded and compared with the posterior hard decision at the channel
stage, sign(L[n] + R[n]) (a G-matrix stopping rule).  Each frame's decision
is LATCHED at its own first check where the rule holds, so the output is a
pure function of (channel LLRs, early_stop_every).
"""
from __future__ import annotations

import torch

from polardecoding_tpu_torch.ops.chk import chk, chk_exact, chk_fast
from polardecoding_tpu_torch.ops.encode import polar_encode

FROZEN_R = 999.0  # the reference's frozen-bit "infinity" (BP_128.c:351)
CHK_FNS = {"minsum_lut": chk, "minsum_lut_fast": chk_fast, "spa": chk_exact}


def _halves(x, i):
    """Split the last axis (length N) into stage-i butterfly halves.

    Returns (upper, lower) of shape [..., N/2d, d]; `_merge` is the inverse.
    """
    N = x.shape[-1]
    d = 1 << i
    v = x.reshape(x.shape[:-1] + (N // (2 * d), 2, d))
    return v[..., 0, :], v[..., 1, :]


def _merge(up, lo, N):
    out = torch.stack((up, lo), dim=-2)
    return out.reshape(out.shape[:-3] + (N,))


def bp_iteration(Ls, Rs, chk_fn):
    """One flooding iteration over per-stage message lists.

    Ls, Rs: lists of n+1 tensors [..., N].  Ls[n] and Rs[0] are fixed by the
    caller.  Returns updated lists (Gauss-Seidel across stages, parallel within
    a stage, exactly like the reference's sweep order).
    """
    n = len(Ls) - 1
    N = Ls[0].shape[-1]
    Rs = list(Rs)
    Ls = list(Ls)
    for i in range(n):
        ru, rd = _halves(Rs[i], i)
        lu, ld = _halves(Ls[i + 1], i)
        new_u = chk_fn(ru, ld + rd)
        new_d = rd + chk_fn(ru, lu)
        Rs[i + 1] = _merge(new_u, new_d, N)
    for i in range(n - 1, -1, -1):
        ru, rd = _halves(Rs[i], i)
        lu, ld = _halves(Ls[i + 1], i)
        new_u = chk_fn(lu, ld + rd)
        new_d = ld + chk_fn(ru, lu)
        Ls[i] = _merge(new_u, new_d, N)
    return Ls, Rs


def bp_decode(ch_llr: torch.Tensor, frozen: torch.Tensor, iters: int = 100,
              flavor: str = "minsum_lut", early_stop_every: int = 0):
    """Decode a batch of frames with the plain PyTorch engine.

    ch_llr: [B, N] channel LLRs (2y/sigma^2), float32 or float64;
    frozen: [N] bool on the same device.
    Returns u_hat [B, N] int8 (frozen positions forced 0).
    """
    chk_fn = CHK_FNS[flavor]
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    r0 = torch.where(frozen, FROZEN_R, 0.0).to(ch_llr.dtype).expand(B, N)
    zero = torch.zeros_like(ch_llr)
    Ls = [zero] * n + [ch_llr]
    Rs = [r0] + [zero] * n

    def decision():
        soft = Ls[0] + Rs[0]
        return torch.where(frozen, 0, (soft < 0).to(torch.int8)).to(torch.int8)

    if not early_stop_every:
        for _ in range(iters):
            Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
        return decision()

    done = torch.zeros(B, dtype=torch.bool, device=ch_llr.device)
    u_lat = torch.zeros((B, N), dtype=torch.int8, device=ch_llr.device)
    for it in range(iters):
        Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
        if (it + 1) % early_stop_every:
            continue
        u_hat = decision()
        # posterior channel-stage hard decision sign(L[n] + R[n]), not the
        # raw channel sign, which carries the channel's own bit errors
        ch_hard = (Ls[n] + Rs[n] < 0).to(torch.int8)
        newly = (polar_encode(u_hat) == ch_hard).all(dim=-1) & ~done
        u_lat = torch.where(newly[:, None], u_hat, u_lat)
        done = done | newly
        if bool(done.all()):
            break
    return torch.where(done[:, None], u_lat, decision())


def bp_decode_auto(ch_llr: torch.Tensor, frozen: torch.Tensor, iters: int = 100,
                   flavor: str = "minsum_lut", early_stop_every: int = 0,
                   engine: str = "auto"):
    """Decode with the hand-written CUDA kernel for a CUDA tensor and with the
    plain version for a CPU tensor; engine="plain" forces the plain version
    on any device (the JAX package's engine="jnp")."""
    if engine not in ("auto", "plain"):
        raise ValueError(f"unknown BP engine {engine!r}")
    if engine == "plain" or ch_llr.device.type == "cpu":
        return bp_decode(ch_llr, frozen, iters=iters, flavor=flavor,
                         early_stop_every=early_stop_every)
    from polardecoding_tpu_torch.ops.bp_kernel import bp_decode_cuda

    return bp_decode_cuda(ch_llr, frozen, iters=iters, flavor=flavor,
                          early_stop_every=early_stop_every)
