"""BPSK modulation + AWGN channel + channel LLR, batched (torch port of
polardecoding_tpu.ops.channel), with the port's random generator.

Reference semantics (SC_128.c:164-167, 192-202, 416-420):
  - sigma = 10^(-EbN0_dB / 20)
  - BPSK maps bit 0 -> +1, bit 1 -> -1
  - y = s + n,  n ~ N(0, sigma^2)
  - channel LLR  L_ch = 2 y / sigma^2

The generator reproduces jax.random for the threefry2x32 implementation in
partitionable mode: `prng_key` is jax.random.PRNGKey, `fold_in` is
jax.random.fold_in, `random_bits` is jax.random.bits for uint32 and
`normal` is jax.random.normal for float32.  Keys and bits are bit-equal to
JAX's, and so are the normals and the LLRs of the frame step
(ops/noise.py).  A key is an int64 tensor [..., 2] of two 32-bit words, so
per-frame keys are a pure function of (seed, frame index) and a batch of
them is one tensor.

`frame_llr` is the frame step's channel: on the card one launch of the
kernel csrc/frame_channel.cu (ops/frame_channel_kernel), whose plain
version is awgn_llr of frame_keys here.
"""
from __future__ import annotations

import torch

from polardecoding_tpu_torch.ops._build import use_kernel
from polardecoding_tpu_torch.ops.frame_channel_kernel import frame_llr_cuda
from polardecoding_tpu_torch.ops.noise import (
    MASK32,
    SQRT2,
    erfinv_f32,
    fma,
    normal_from_bits,
    threefry2x32,
    uniform_jax,
)


def sigma_from_ebn0_db(ebn0_db) -> float:
    return 10.0 ** (ebn0_db / -20.0)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed): the words (seed >> 32, seed & 0xFFFFFFFF)."""
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: the threefry hash of the counter (0, data) under
    `key`.  key [2] with data an int or int64 tensor [B] gives [B, 2] (or
    [2] for an int)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack((y0, y1), dim=-1)


def frame_keys(seed_key: torch.Tensor, frame_index: torch.Tensor) -> torch.Tensor:
    """Per-frame keys: fold the global frame index into the sweep-point key."""
    return fold_in(seed_key, frame_index)


def llr_from_y(y: torch.Tensor, sigma) -> torch.Tensor:
    """Channel LLR for externally supplied received samples (golden mode),
    in y's dtype and on its device."""
    return 2.0 * y / (sigma * sigma)


def random_bits(keys: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """jax.random.bits(key, (n,), uint32) for each key of keys [..., 2]:
    threefry of the counters (0, j) for j < n, the two output words xored.
    start > 0 gives words start .. start + n - 1 of the longer stream (a
    rank's slice of a global draw).  Returns int64 [..., n] holding 32-bit
    words."""
    j = torch.arange(start, start + n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(j), j)
    return y0 ^ y1


def normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.normal(key, (n,), float32) for each key of keys [..., 2]."""
    return normal_from_bits(random_bits(keys, n))


def bpsk(x: torch.Tensor) -> torch.Tensor:
    """0 -> +1, 1 -> -1."""
    return 1.0 - 2.0 * x.to(torch.float32)


def awgn_llr(x: torch.Tensor, keys: torch.Tensor, sigma) -> torch.Tensor:
    """Modulate, add noise, return channel LLRs 2y/sigma^2 (float32).

    x: [B, N] bits; keys: [B, 2] per-frame keys; sigma: a float, or a
    per-frame float32 tensor [B] (an SNR sweep folded into the batch).

    The arithmetic is the JAX package's frame step as XLA compiles it: the
    noise term is erfinv(u) * (sigma * sqrt(2)), with the scalar product
    formed first in float32, added to the BPSK symbol in one FMA, then
    (y + y) / sigma^2.  The LLRs are bit-equal to that step's
    (ops/noise.py)."""
    return awgn_llr_from_words(x, random_bits(keys, x.shape[-1]), sigma)


def awgn_llr_from_words(x: torch.Tensor, words: torch.Tensor, sigma) -> torch.Tensor:
    """awgn_llr with the noise words given: x [B, N] bits, words [B, N]
    32-bit words (any integer type) in place of random_bits(keys, N).  The
    plain version of csrc/frame_channel.cu's `bits` mode."""
    u = uniform_jax(words.to(torch.int64) & MASK32)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
    if sigma.ndim == 1:
        sigma = sigma[:, None]
    y = fma(erfinv_f32(u), sigma * SQRT2, bpsk(x))
    return (y + y) / (sigma * sigma)


def awgn_llr_const_sigma(x: torch.Tensor, keys: torch.Tensor, sigma: float) -> torch.Tensor:
    """awgn_llr as XLA compiles it on the CPU when sigma is a constant of
    the jitted function (the JAX scripts' frame generators close over
    jnp.float32(sigma)): the constants fold, so y is the same FMA and the
    LLR is y * (2 * (1 / sigma^2)), one product, where the frame step
    computes (y + y) / sigma^2.  The two differ in the last ulp of about a
    tenth of the elements.  Plain PyTorch on any device."""
    u = uniform_jax(random_bits(keys, x.shape[-1]) & MASK32)
    sigma = torch.tensor(sigma, dtype=torch.float32, device=x.device)
    y = fma(erfinv_f32(u), sigma * SQRT2, bpsk(x))
    return y * (2.0 * (1.0 / (sigma * sigma)))


def frame_llr(x: torch.Tensor, key: torch.Tensor, fidx: torch.Tensor, sigma,
              engine: str = "auto") -> torch.Tensor:
    """The frame step's channel: LLRs [B, N] float32 of the codewords x
    [B, N] (0/1) for frames fidx [B] under the point key [2], that is
    awgn_llr(x, frame_keys(key, fidx), sigma).  sigma is a float, or a
    float32 table [S] on x's device from which frame b takes
    sigma[fidx[b] % S] (the fused SNR sweep).  On a CUDA tensor with
    engine="auto" the kernel csrc/frame_channel.cu computes it in one
    launch (ops/frame_channel_kernel.frame_llr_cuda; a failed build or
    launch raises); on the CPU, or with engine="plain", the plain
    functions above."""
    key = key.to(x.device)
    if not use_kernel(x, engine, "frame_llr"):
        if isinstance(sigma, torch.Tensor):
            sigma = sigma[fidx % len(sigma)]
        return awgn_llr(x, frame_keys(key, fidx), sigma)
    return frame_llr_cuda(x.to(torch.float32), key, fidx, sigma)
