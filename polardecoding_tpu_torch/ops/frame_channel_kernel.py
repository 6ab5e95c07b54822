"""The frame step's threefry channel on the card: per-frame keys, noise
words, jax.random.normal's Gaussian and the channel LLRs in one launch of
the hand-written kernel csrc/frame_channel.cu.

It is the port's own kernel, not a port of a TPU kernel: the JAX package
computes this function in XLA (its ops/channel.awgn_llr of frame_keys).
The plain version is ops/channel.awgn_llr(x, frame_keys(key, fidx), sigma),
and of the `bits` mode ops/channel.awgn_llr_from_words; ops/channel.frame_llr
dispatches between kernel and plain version.  A launch takes one sigma
for every frame (the frame steps) or a sigma table from which each frame
takes its own (the fused SNR sweep).  `LAUNCHES` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes

import torch

from polardecoding_tpu_torch.ops import _build
from polardecoding_tpu_torch.ops.channel_kernel import words32

LAUNCHES = 0
SOURCE = "polardecoding_tpu_torch/csrc/frame_channel.cu"
REPLACES = ("polardecoding_tpu/ops/channel.py:27 (awgn_llr with frame_keys, "
            "computed by XLA in the JAX package: no TPU kernel)")

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 3)


def frame_llr_cuda(x: torch.Tensor, key, fidx, sigma,
                   bits=None) -> torch.Tensor:
    """LLRs [B, N] float32 of the codewords x [B, N] (float32 0/1, N a power
    of two) on the card: frame b's noise under fold_in(key, fidx[b]), key an
    int64 [2] tensor and fidx an int64 [B] tensor on x's device (the low 32
    bits of an index are folded in); with bits [B, N] (32-bit words), those
    words instead, and key and fidx may be None.  sigma: a float, or a
    float32 table [S] on x's device, from which frame b takes
    sigma[fidx[b] % S] (not with bits).  Launches on the current stream
    without synchronising; raises on any input the kernel does not take and
    when the launch is refused."""
    global LAUNCHES
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"x must be [B, N] float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    B, N = x.shape
    if N < 1 or N & (N - 1):
        raise ValueError(f"N must be a power of two, got {N}")
    if x.device.type != "cuda":
        raise ValueError(f"frame_llr_cuda needs a CUDA tensor, got {x.device}")
    if bits is None:
        if (not isinstance(key, torch.Tensor) or key.dtype != torch.int64
                or tuple(key.shape) != (2,) or key.device != x.device):
            raise ValueError("key must be an int64 [2] tensor on x's device")
        if (not isinstance(fidx, torch.Tensor) or fidx.dtype != torch.int64
                or tuple(fidx.shape) != (B,) or fidx.device != x.device):
            raise ValueError(f"fidx must be an int64 [{B}] tensor on x's device")
        # held until the launch: a temporary's memory could go to `out`
        fidx, key = fidx.contiguous(), key.contiguous()
        ptrs = (fidx.data_ptr(), key.data_ptr(), None)
    else:
        if tuple(bits.shape) != (B, N) or bits.device != x.device:
            raise ValueError(f"bits must be [{B}, {N}] on x's device")
        bits = words32(bits)
        ptrs = (None, None, bits.data_ptr())
    table, S = None, 0
    if isinstance(sigma, torch.Tensor):
        if (sigma.dtype != torch.float32 or sigma.ndim != 1
                or not len(sigma) or sigma.device != x.device):
            raise ValueError("a sigma table must be a non-empty float32 [S] "
                             "tensor on x's device")
        if bits is not None:
            raise ValueError("a sigma table takes its frames' indices: not "
                             "with bits")
        table = sigma.contiguous()  # held until the launch
        S, sigma = len(table), 0.0
    x = x.contiguous()
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    _build.launch("frame_channel", _ARGTYPES, x.device, x.data_ptr(), *ptrs,
                  None if table is None else table.data_ptr(), out.data_ptr(),
                  float(sigma), S, B, N.bit_length() - 1)
    LAUNCHES += 1
    return out
