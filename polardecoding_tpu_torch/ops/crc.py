"""CRC encode/check over GF(2) as constant bit-matrix products (torch port of
polardecoding_tpu.ops.crc).

Three reference styles (SURVEY §2.2):
  - multiplicative CRC-6:  w(D) = m(D) g(D), g = 1 + D^5 + D^6
    (encode CASCL_128.c:205-220, check by long division CASCL_128.c:517-536)
  - multiplicative CRC-24: same with the 13-tap g listed below
    (CASCL_1024_L8.c:245-270 / 569-600)
  - systematic CRC-24: codeword [parity(K x r) || message], parity rows Gc
    (CASCL_1024_sys.c:49-561 data table, 776-789 encode, 1093-1122 check)

The matrices are built as host numpy; the encoders apply them to a batch of
bit rows as one integer product and keep the parity bit.  A step that
applies a matrix many times takes it once to its device (`device_matrix`)
and passes that tensor on: `gf2_matmul` copies a numpy matrix at every call
and uses such a tensor as it is.  `COPIES` counts the matrices copied to a
device, so a run can show that its steps copy none.
"""
from __future__ import annotations

import numpy as np
import torch

from polardecoding_tpu_torch.utils import trace

# g(D) = D^6 + D^5 + 1 (ref: CASCL_128.c:205-220)
CRC6_EXPONENTS = (0, 5, 6)
# g(D) = D^24 + D^23 + D^21 + D^20 + D^17 + D^15 + D^13 + D^12 + D^8 + D^4
#        + D^2 + D + 1 (ref: CASCL_1024_L8.c:245-270)
CRC24_EXPONENTS = (0, 1, 2, 4, 8, 12, 13, 15, 17, 20, 21, 23, 24)

COPIES = 0


def crc_degree(exponents) -> int:
    return max(exponents)


def _poly_mod_table(exponents, length: int) -> np.ndarray:
    """R[i] = coefficients of D^i mod g(D), shape [length, r]."""
    r = crc_degree(exponents)
    low = [e for e in exponents if e < r]
    table = np.zeros((length, r), dtype=np.uint8)
    cur = np.zeros(r, dtype=np.uint8)
    cur[0] = 1  # D^0
    for i in range(length):
        table[i] = cur
        # multiply by D: shift up; if D^r appears, substitute D^r = sum(low)
        carry = cur[r - 1]
        cur = np.roll(cur, 1)
        cur[0] = 0
        if carry:
            for e in low:
                cur[e] ^= 1
    return table


def multiplicative_encode_matrix(exponents, k: int) -> np.ndarray:
    """[k, k+r] GF(2) matrix E with w = m . E: message bit i contributes at
    offsets i + e for each exponent e (the reference's tap accumulation)."""
    r = crc_degree(exponents)
    E = np.zeros((k, k + r), dtype=np.uint8)
    for i in range(k):
        for e in exponents:
            E[i, i + e] = 1
    return E


def systematic_parity_matrix(exponents, k: int) -> np.ndarray:
    """Gc: [k, r] with parity p = v . Gc so that [p || v] is divisible by g,
    i.e. Gc[i] = D^{r+i} mod g."""
    r = crc_degree(exponents)
    return _poly_mod_table(exponents, r + k)[r:]


def check_matrix(exponents, length: int) -> np.ndarray:
    """[length, r] matrix R with syndrome = C . R mod 2; C passes iff syndrome
    is all-zero (equivalent to the reference's in-place long division)."""
    return _poly_mod_table(exponents, length)


def device_matrix(M: np.ndarray, device) -> torch.Tensor:
    """M as float32 on `device`, the form gf2_matmul uses as it is.  The
    copy runs in the span `crc.h2d`, counted in bytes: on the card a copy
    from pageable memory, which waits for the work queued before it."""
    global COPIES
    Mf = M.astype(np.float32)
    with trace.span("crc.h2d", bytes=Mf.nbytes):
        Md = torch.as_tensor(Mf, device=device)
    COPIES += 1
    return Md


def gf2_matmul(bits: torch.Tensor, M) -> torch.Tensor:
    """(bits . M) mod 2, returned in bits' dtype.  The product runs in
    float32, since CUDA has no int64 matmul: 0/1 operands give integer sums
    of at most k + r < 2^24, exact in float32 (and in TF32).  M: a numpy
    0/1 matrix, copied to bits' device at this call (`device_matrix`), or
    a float32 tensor on bits' device, used as it is."""
    if isinstance(M, torch.Tensor):
        if M.dtype != torch.float32 or M.device != bits.device:
            raise ValueError(f"a {M.dtype} matrix on {M.device}: gf2_matmul "
                             f"takes float32 on bits' device {bits.device}")
    else:
        M = device_matrix(M, bits.device)
    acc = bits.to(torch.float32) @ M
    return (acc.to(torch.int64) & 1).to(bits.dtype)


def crc_syndrome(codeword_bits: torch.Tensor, R) -> torch.Tensor:
    """Batched GF(2) syndrome: codeword_bits [..., length] x R [length, r],
    int32 0/1 [..., r].  One gf2_matmul: exact for 0/1 bits (sums below
    2^24)."""
    return gf2_matmul(codeword_bits.to(torch.int32), R)


def crc_passes(codeword_bits: torch.Tensor, R) -> torch.Tensor:
    """True where the codeword is divisible by g."""
    return (crc_syndrome(codeword_bits, R) == 0).all(dim=-1)


def crc_encode_multiplicative(message_bits: torch.Tensor, exponents, E=None):
    """w = m(D) g(D) as a batched GF(2) product; returns [..., k + r].  E:
    the encode matrix in either of gf2_matmul's forms, by default built
    here."""
    if E is None:
        E = multiplicative_encode_matrix(exponents, message_bits.shape[-1])
    return gf2_matmul(message_bits, E)


def crc_encode_systematic(message_bits: torch.Tensor, exponents, Gc=None):
    """[parity || message], parity = v . Gc (ref: CASCL_1024_sys.c:776-789).
    Gc: the parity matrix in either of gf2_matmul's forms, by default built
    here."""
    if Gc is None:
        Gc = systematic_parity_matrix(exponents, message_bits.shape[-1])
    return torch.cat([gf2_matmul(message_bits, Gc), message_bits], dim=-1)
