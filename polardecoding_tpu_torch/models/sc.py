"""Successive-cancellation decoder: compact schedule, batched over frames
(torch port of polardecoding_tpu.models.sc).

Reference semantics (SC_128.c:394-460): serial loop over bits j = 0..N-1; the
LLR of bit j comes from the recursive memoized `getLLR` (f-node = CHK of the
two children, g-node = lower child +/- upper child by the decided partner bit,
SC_128.c:344-365); decided bits back-propagate rightward (`updateBit`,
SC_128.c:367-392); frozen bits are forced to 0 (SC_128.c:404-410).

`sc_decode` is the plain version on the compact O(N) state of
models/_compact.py.  On a CUDA tensor `models/scl.sc_decode_auto` runs the
list-decode kernel at L=1 instead, as the JAX package runs its SCL kernel at
L=1 on a TPU.  The Kao ("_fag") wiring is this same engine under
bit-reversal relabeling.
"""
from __future__ import annotations

import torch

from polardecoding_tpu_torch.models._compact import bit_phase, llr_phase, ntz


def sc_decode(ch_llr: torch.Tensor, frozen: torch.Tensor) -> torch.Tensor:
    """Decode a batch of frames with plain SC.

    ch_llr: [B, N] channel LLRs; frozen: [N] bool.
    Returns u_hat [B, N] int8 (frozen positions 0).
    """
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    dev = ch_llr.device
    llr_c = torch.zeros((B, N - 1), dtype=ch_llr.dtype, device=dev)
    bits_c = torch.zeros((B, N - 1), dtype=torch.int8, device=dev)
    u_out = torch.zeros((B, N), dtype=torch.int8, device=dev)
    zero = torch.zeros((B,), dtype=torch.int8, device=dev)
    for j, is_frozen in enumerate(frozen.tolist()):
        llr_phase(llr_c, bits_c, ch_llr, ntz(j | N), n)
        u = zero if is_frozen else (llr_c[:, 0] < 0).to(torch.int8)
        u_out[:, j] = u
        bit_phase(bits_c, u, min(ntz(j + 1), n), n)
    return u_out
