"""Polar transform, batched over frames (torch port of
polardecoding_tpu.ops.encode).

`polar_encode` is the O(N log N) butterfly (log2(N) stages of reshape + XOR,
the Lee-graph butterflies applied left to right); `encode_info_mxu` computes
the same codeword as one GF(2) matrix product against the info rows of
F^{tensor n}.  The Kao ("_fag") graph is the Lee graph under per-stage
bit-reversal relabeling, so one encoder serves both.
"""
from __future__ import annotations

import numpy as np
import torch


def polar_encode(u: torch.Tensor) -> torch.Tensor:
    """x = u . F^{tensor n} over GF(2), Lee convention (stage-i pairs at
    distance 2^i; upper-right = upper xor lower, lower-right = lower).

    u: integer tensor [..., N] with values in {0, 1}.  Returns same shape/dtype.
    """
    N = u.shape[-1]
    n = N.bit_length() - 1
    lead = u.shape[:-1]
    x = u
    for i in range(n):
        d = 1 << i
        v = x.reshape(lead + (N // (2 * d), 2, d))
        x = torch.stack((v[..., 0, :] ^ v[..., 1, :], v[..., 1, :]),
                        dim=-2).reshape(lead + (N,))
    return x


def scatter_info(payload: torch.Tensor, info_positions: torch.Tensor, N: int):
    """Place payload bits [..., K'] into a length-N u-vector at the info
    positions (frozen positions stay 0).  Ref: SC_128.c:179-181."""
    u = payload.new_zeros(payload.shape[:-1] + (N,))
    u[..., info_positions] = payload
    return u


def info_sub_generator(info_positions, N: int) -> np.ndarray:
    """G_I: the info-position rows of F^{tensor n} as numpy uint8 [K', N],
    so  polar_encode(scatter_info(w, I, N)) == (w . G_I) mod 2."""
    from polardecoding_tpu_torch.utils.gf2 import dense_generator

    return dense_generator(N)[np.asarray(info_positions)]


def encode_info_mxu(w: torch.Tensor, g_rows: torch.Tensor) -> torch.Tensor:
    """Codeword x = (w . G_I) mod 2 as one matrix product; named after the
    JAX package's MXU encoder, whose results it reproduces bit for bit.

    The operands are 0/1 in float32 and every product is 0 or 1, so the
    accumulated sum is an integer no larger than K' <= 1024 and exact in
    float32; it stays exact if the card's matmul runs in TF32, whose 10-bit
    mantissa holds 0 and 1 exactly and whose accumulation is float32.

    w: [..., K'] 0/1 bits; g_rows: float32 [K', N] 0/1 on w's device.
    Returns float32 0.0/1.0 [..., N].
    """
    acc = w.to(torch.float32) @ g_rows
    return acc - 2.0 * torch.floor(acc * 0.5)
