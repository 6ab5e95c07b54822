"""Deterministic payload source: 63-period PN sequence from the LFSR
g(D)=D^6+D^5+1 (copied from polardecoding_tpu.utils.pn, numpy only).

Reference: SC_128.c:125-138 generates one period; each frame takes K consecutive
bits starting at a rotating offset m, advanced by step_m = K % 63 per frame
(SC_128.c:179-181, 214-215), so payloads are a pure function of the frame index.
"""
from __future__ import annotations

import numpy as np

PN_PERIOD = 63


def pn_sequence() -> np.ndarray:
    """One 63-bit period of the PN sequence.

    The reference seeds the 6-bit LFSR with state 100000 (first output bit 1,
    next five 0) and taps U[4] xor U[5] thereafter (SC_128.c:126-138).
    """
    state = [0, 0, 0, 0, 0, 0]  # U[0..5]
    out = np.zeros(PN_PERIOD, dtype=np.int8)
    for i in range(PN_PERIOD):
        if i == 0:
            b = 1
        elif i < 6:
            b = 0
        else:
            b = state[4] ^ state[5]
        out[i] = b
        # shift: U[5]<-U[4]<-...<-U[0]<-b
        state = [b] + state[:5]
    return out


def payload_offsets(frame_index: np.ndarray, k: int) -> np.ndarray:
    """Rotating PN offset m for each frame index (m advances by K % 63 per frame)."""
    step = k % PN_PERIOD
    return (np.asarray(frame_index) * step) % PN_PERIOD


def payload_bits_host(frame_index: int, k: int) -> np.ndarray:
    """Host-side payload for one frame: K bits PN[(m + i) % 63]."""
    pn = pn_sequence()
    m = (frame_index * (k % PN_PERIOD)) % PN_PERIOD
    idx = (m + np.arange(k)) % PN_PERIOD
    return pn[idx]
