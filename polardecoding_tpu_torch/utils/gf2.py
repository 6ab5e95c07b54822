"""GF(2) dense generator matrix (copied from polardecoding_tpu.utils.gf2,
numpy only): the N x N matrix Fn = F^{tensor n} that every reference program
reads from stdin (ref: SC_128.c:148-158), used here for the encoder's info-row
generator.  The stage-projection helpers of that module come with the
analysis tools (ROADMAP A11)."""
from __future__ import annotations

import numpy as np

F2 = np.array([[1, 0], [1, 1]], dtype=np.uint8)


def dense_generator(N: int) -> np.ndarray:
    """F^{tensor n} over GF(2), the polar transform in the Lee convention
    (G = F^{tensor n}, no bit reversal; ref comment SC_128.c:1-6)."""
    n = N.bit_length() - 1
    if 1 << n != N:
        raise ValueError(f"N={N} is not a power of two")
    G = np.array([[1]], dtype=np.uint8)
    for _ in range(n):
        G = np.kron(G, F2)
    return G
