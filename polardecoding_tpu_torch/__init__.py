"""polardecoding_tpu_torch — the PyTorch and CUDA port of polardecoding_tpu.

The same presets, PN payloads, polar encoder, BPSK/AWGN channel with a
bit-compatible threefry generator, BP, SC, SCL and CA-SCL decoders and
adaptive Monte-Carlo sweep harness (in one process or several, over
torch.distributed) as the JAX package, running on an NVIDIA
Hopper card through hand-written CUDA kernels (csrc/), each beside its
plain PyTorch version.
Importing the package needs neither JAX nor nvcc.
"""
from polardecoding_tpu_torch.configs import (
    PRESETS,
    CodeConfig,
    DecoderConfig,
    Preset,
    SweepConfig,
    preset,
)

__all__ = [
    "PRESETS",
    "preset",
    "Preset",
    "CodeConfig",
    "DecoderConfig",
    "SweepConfig",
]

__version__ = "0.1.0"
