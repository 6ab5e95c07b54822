"""The MC channel: (PN offsets, sigma) -> channel LLRs from a table of
pre-encoded codewords and counter-based Gaussian noise (torch port of
polardecoding_tpu/ops/pallas/channel_kernel.py).

Payloads depend only on the PN offset m in {0..62} (SC_128.c:179-181), so
x_table [128, N] holds every codeword and the channel is a row read, noise
words, the Gaussian and the LLR, per element.  `mc_channel_plain` is the
plain version (the JAX package's mc_channel_jnp as it runs under jit);
`mc_channel_cuda` wraps the hand-written kernel csrc/mc_channel.cu, the port
of `mc_channel_pallas`; `mc_channel` dispatches between them.  `LAUNCHES`
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from polardecoding_tpu_torch.ops import _build
from polardecoding_tpu_torch.ops.noise import MASK32, counter_bits, mc_llr

LAUNCHES = 0
SOURCE = "polardecoding_tpu_torch/csrc/mc_channel.cu"
REPLACES = "polardecoding_tpu/ops/pallas/channel_kernel.py:75"


def mc_channel_plain(m: torch.Tensor, x_table: torch.Tensor, sigma,
                     bits: torch.Tensor) -> torch.Tensor:
    """LLRs [B, N] float32 of the codewords x_table[m] with the Gaussian of
    `bits` [B, N] (32-bit words)."""
    return mc_llr(bits, x_table[m.to(torch.int64)], sigma)


def mc_channel(m, x_table, sigma, seeds, bits=None, tile: int = 0,
               gen_bits: bool = True, interpret: bool = False,
               bit_gen: str = "tf32", engine: str = "auto",
               row0: int = 0) -> torch.Tensor:
    """m [B] PN offsets (0..62), x_table [128, N] float32, sigma a float,
    seeds 4 words (k0, k1, k0 ^ k1, step) -> llr [B, N] float32.

    gen_bits=True draws the noise from the counter generator at counter
    (seeds[3], (row0 + b) * N + lane) for row b under the key (seeds[0],
    seeds[1]), the TPU kernel's semantics, on either device; row0 is the
    first row's index in a global batch (a rank's slice), 0 for a whole
    batch.  gen_bits=False takes `bits` [B, N].  bit_gen="hw" (the TPU's own PRNG) raises; tile and
    interpret are TPU knobs, accepted and unused.  The kernel runs on a CUDA
    tensor, the plain version on a CPU tensor or with engine="plain"."""
    if engine not in ("auto", "plain"):
        raise ValueError(f"unknown channel engine {engine!r}")
    if bit_gen != "tf32":
        raise ValueError(f"bit_gen={bit_gen!r}: only the counter-based "
                         "threefry generator 'tf32' is supported")
    if not gen_bits and bits is None:
        raise ValueError("gen_bits=False needs bits [B, N]")
    if engine == "plain" or m.device.type == "cpu":
        if gen_bits:
            k0, k1, _, step = (int(s) for s in seeds)
            bits = counter_bits(k0, k1, step, m.shape[0], x_table.shape[1],
                                m.device, row0=row0)
        return mc_channel_plain(m, x_table, sigma, bits)
    return mc_channel_cuda(m, x_table, sigma, seeds, None if gen_bits else bits,
                           row0=row0)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_uint32] * 4
             + [ctypes.c_int] * 2)


def words32(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (held in any integer type) as a contiguous int32 tensor
    of the same bit patterns, which a kernel reads as uint32."""
    if bits.dtype == torch.int32:
        return bits.contiguous()
    # the int64 -> int32 conversion keeps the low 32 bits
    return (bits.to(torch.int64) & MASK32).to(torch.int32).contiguous()


def mc_channel_cuda(m: torch.Tensor, x_table: torch.Tensor, sigma, seeds,
                    bits=None, row0: int = 0) -> torch.Tensor:
    """The channel on the card with the CUDA kernel: counter noise of rows
    row0 .. row0 + B - 1 when bits is None, else the words `bits` [B, N].
    Launches on the current stream without synchronising; raises on any
    input the kernel does not take and when the launch is refused."""
    global LAUNCHES
    if m.device.type != "cuda":
        raise ValueError(f"mc_channel_cuda needs a CUDA tensor, got {m.device}")
    if m.ndim != 1:
        raise ValueError(f"m must be [B], got shape {tuple(m.shape)}")
    if (x_table.dtype != torch.float32 or x_table.ndim != 2
            or x_table.shape[0] != 128 or x_table.device != m.device):
        raise ValueError("x_table must be a [128, N] float32 tensor on m's device")
    B, N = m.shape[0], x_table.shape[1]
    if N < 1 or N & (N - 1):
        raise ValueError(f"N must be a power of two, got {N}")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    if bits is not None:
        if tuple(bits.shape) != (B, N) or bits.device != m.device:
            raise ValueError(f"bits must be [{B}, {N}] on m's device")
        bits = words32(bits)
    out = torch.empty((B, N), dtype=torch.float32, device=m.device)
    if B == 0:
        return out
    m32 = m.to(torch.int32).contiguous()
    xt = x_table.contiguous()
    k0, k1, _, step = (int(s) & MASK32 for s in seeds)
    _build.launch("mc_channel", _ARGTYPES, m.device, m32.data_ptr(),
                  xt.data_ptr(), None if bits is None else bits.data_ptr(),
                  out.data_ptr(), float(sigma), k0, k1, step,
                  row0 & MASK32, B, N.bit_length() - 1)
    LAUNCHES += 1
    return out
