"""Flooding BP over the butterfly graph, fixed iterations (BP_1024.c,
BP_128.c:334-389): L[n] = channel LLRs, R[0] = 999 on frozen bits and 0
on info bits; an iteration is the R sweep over stages 0..n-1 (stage i+1
reads the stage-i R just written), then the L sweep over n-1..0:

    R[i+1, u] = CHK(R[i, u], L[i+1, d] + R[i, d])
    R[i+1, d] = R[i, d] + CHK(R[i, u], L[i+1, u])
    L[i, u]   = CHK(L[i+1, u], L[i+1, d] + R[i, d])
    L[i, d]   = L[i+1, d] + CHK(R[i, u], L[i+1, u])

then u_hat = [L[0] + R[0] < 0] at the info bits.  Stage i's butterflies
are the N axis reshaped to [N / 2d, 2, d], d = 2^i."""
from __future__ import annotations

import torch

from portbench.reference.chk import chk

FROZEN_R = 999.0


def _halves(x, i):
    N = x.shape[-1]
    d = 1 << i
    v = x.reshape(x.shape[:-1] + (N // (2 * d), 2, d))
    return v[..., 0, :], v[..., 1, :]


def _merge(up, lo, N):
    out = torch.stack((up, lo), dim=-2)
    return out.reshape(out.shape[:-3] + (N,))


def messages(llr: torch.Tensor, frozen: torch.Tensor) -> tuple:
    """The fresh message lists (Ls, Rs) of LLRs [B, N] in their dtype."""
    B, N = llr.shape
    n = N.bit_length() - 1
    zero = torch.zeros_like(llr)
    return ([zero] * n + [llr],
            [torch.where(frozen, FROZEN_R, 0.0).to(llr.dtype).expand(B, N)] + [zero] * n)


def iterate(Ls: list, Rs: list, iters: int, chk_fn=chk) -> None:
    """`iters` flooding iterations, the lists updated in place."""
    n = len(Ls) - 1
    N = Ls[0].shape[-1]
    for _ in range(iters):
        for i in range(n):
            ru, rd = _halves(Rs[i], i)
            lu, ld = _halves(Ls[i + 1], i)
            Rs[i + 1] = _merge(chk_fn(ru, ld + rd), rd + chk_fn(ru, lu), N)
        for i in range(n - 1, -1, -1):
            ru, rd = _halves(Rs[i], i)
            lu, ld = _halves(Ls[i + 1], i)
            Ls[i] = _merge(chk_fn(lu, ld + rd), ld + chk_fn(ru, lu), N)


def decision(Ls: list, Rs: list, frozen: torch.Tensor) -> torch.Tensor:
    """u_hat [B, N] int8: [L[0] + R[0] < 0] at the info bits, 0 frozen."""
    soft = Ls[0] + Rs[0]
    return torch.where(frozen, 0, (soft < 0).to(torch.int8)).to(torch.int8)


def bp_decode(llr: torch.Tensor, frozen: torch.Tensor, iters: int,
              chk_fn=chk) -> torch.Tensor:
    """u_hat [B, N] int8 (frozen bits 0) of the LLRs [B, N] in their dtype;
    chk_fn(a, b) is the check node (a counting wrapper may stand in)."""
    Ls, Rs = messages(llr, frozen)
    iterate(Ls, Rs, iters, chk_fn)
    return decision(Ls, Rs, frozen)
