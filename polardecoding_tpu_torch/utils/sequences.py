"""Code construction: reliability sequences, info sets, frozen masks
(copied from polardecoding_tpu.utils.sequences, numpy only).

  - 5G reliability tables   (ref: SC_128.c:42-51, SC_1024.c:42-90)
  - info set  I[i] = Q[N-K+i], frozen mask inI   (ref: SC_128.c:139-147)
  - CA-SCL info set reserves K+r most reliable   (ref: CASCL_128.c:169-177)
  - bit-reversal permutation                     (ref: SC_128_fag.c:139-155)
"""
from __future__ import annotations

import numpy as np

from polardecoding_tpu_torch.utils._q_tables import Q1024


def reliability_sequence(N: int) -> np.ndarray:
    """The length-N reliability sequence, ascending reliability (Q[0] worst).

    Uses the 3GPP nesting property: Q_N is the subsequence of Q_1024 with
    entries < N.  Valid for any power-of-two N up to 1024.
    """
    n = N.bit_length() - 1
    if 1 << n != N or N > 1024:
        raise ValueError(f"N={N} must be a power of two <= 1024")
    return np.asarray([q for q in Q1024 if q < N], dtype=np.int32)


def info_set(N: int, num_info: int) -> np.ndarray:
    """Indices of the `num_info` most reliable bit channels, in the reference's
    order I[i] = Q[N - num_info + i] (ref: SC_128.c:143-147)."""
    q = reliability_sequence(N)
    return q[N - num_info :].copy()


def frozen_mask(N: int, num_info: int) -> np.ndarray:
    """Boolean mask, True where the bit channel is frozen."""
    mask = np.ones(N, dtype=bool)
    mask[info_set(N, num_info)] = False
    return mask


def bit_reversal(N: int) -> np.ndarray:
    """bRev[i] = i with its log2(N) bits reversed (ref: SC_128_fag.c:139-155).

    An involution: bRev[bRev[i]] == i.
    """
    n = N.bit_length() - 1
    if 1 << n != N:
        raise ValueError(f"N={N} is not a power of two")
    idx = np.arange(N, dtype=np.int64)
    out = np.zeros(N, dtype=np.int64)
    for b in range(n):
        out |= ((idx >> b) & 1) << (n - 1 - b)
    return out.astype(np.int32)
