"""The code's tables and the transmitter, worked out from a configuration:
the frozen set from the 5G reliability sequence, the PN payloads, the
multiplicative CRC and the polar transform.

Reference semantics (CHEBSB/PolarDecoding): the info set is the K + r most
reliable bit channels, I[i] = Q[N - (K + r) + i] (SC_128.c:139-147,
CASCL_128.c:169-177); frame f's payload is K bits of the 63-periodic PN
sequence of g(D) = D^6 + D^5 + 1 from offset (f * (K mod 63)) mod 63
(SC_128.c:125-138, 179-181); the CRC codeword is the product m(D) g(D)
(CASCL_1024_L8.c:245-270); x = u F^{tensor n} in the Lee convention.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.q_table import Q1024

PN_PERIOD = 63


def pn_sequence() -> np.ndarray:
    """One period of the LFSR g(D) = D^6 + D^5 + 1 from state 100000."""
    state = [0] * 6
    out = np.zeros(PN_PERIOD, dtype=np.int8)
    for i in range(PN_PERIOD):
        b = 1 if i == 0 else 0 if i < 6 else state[4] ^ state[5]
        out[i] = b
        state = [b] + state[:5]
    return out


def info_set(N: int, num_info: int) -> np.ndarray:
    """The num_info most reliable bit channels, in the reference's order."""
    if N > 1024 or N & (N - 1):
        raise ValueError(f"N={N} must be a power of two <= 1024")
    q = [v for v in Q1024 if v < N]
    return np.asarray(q[N - num_info:], dtype=np.int64)


def crc_degree(exponents) -> int:
    return max(exponents) if exponents else 0


def crc_remainders(exponents, length: int) -> np.ndarray:
    """[length, r] uint8: row i holds D^i mod g(D); a codeword c passes
    the CRC iff the xor of the rows at its set bits is zero."""
    r = crc_degree(exponents)
    low = [e for e in exponents if e < r]
    table = np.zeros((length, r), dtype=np.uint8)
    cur = np.zeros(r, dtype=np.uint8)
    cur[0] = 1
    for i in range(length):
        table[i] = cur
        carry = cur[r - 1]
        cur = np.roll(cur, 1)
        cur[0] = 0
        if carry:
            for e in low:
                cur[e] ^= 1
    return table


def crc_multiply(m: torch.Tensor, exponents) -> torch.Tensor:
    """w(D) = m(D) g(D) over GF(2): [B, K] bits -> [B, K + r], as xors of
    shifted copies of m, one per exponent of g."""
    B, K = m.shape
    w = torch.zeros((B, K + crc_degree(exponents)), dtype=m.dtype, device=m.device)
    for e in exponents:
        w[:, e:e + K] ^= m
    return w


def crc_ok(cw: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """True where the codeword bits cw [..., length] pass the CRC whose
    remainders (crc_remainders, float64 on cw's device) are rem: the
    syndrome's sums are integers below 2^53, exact in float64."""
    syn = cw.to(torch.float64) @ rem
    return (torch.remainder(syn, 2.0) == 0).all(dim=-1)


def polar_encode(u: torch.Tensor) -> torch.Tensor:
    """x = u F^{tensor n} over GF(2) by log2(N) butterfly stages (stage i
    pairs at distance 2^i: upper ^= lower)."""
    N = u.shape[-1]
    lead = u.shape[:-1]
    x = u
    for i in range(N.bit_length() - 1):
        d = 1 << i
        v = x.reshape(lead + (N // (2 * d), 2, d))
        x = torch.stack((v[..., 0, :] ^ v[..., 1, :], v[..., 1, :]),
                        dim=-2).reshape(lead + (N,))
    return x


class Code:
    """A configuration's code on one device: N, K, the CRC, the info set
    and frozen mask, and the PN period."""

    def __init__(self, code: dict, device):
        if code.get("construction", "5g") != "5g" or code.get("graph", "lee") != "lee":
            raise ValueError("the reference builds the 5G construction on the "
                             "Lee graph only")
        if code.get("crc") and code.get("crc_style", "multiplicative") != "multiplicative":
            raise ValueError("the reference encodes the multiplicative CRC only")
        self.N, self.K = int(code["N"]), int(code["K"])
        self.crc = tuple(code.get("crc") or ())
        self.r = crc_degree(self.crc)
        self.device = device
        info = info_set(self.N, self.K + self.r)
        self.info = torch.as_tensor(info, device=device)
        frozen = np.ones(self.N, dtype=bool)
        frozen[info] = False
        self.frozen = torch.as_tensor(frozen, device=device)
        self.pn = torch.as_tensor(pn_sequence(), device=device)
        self.rem = (torch.as_tensor(crc_remainders(self.crc, self.K + self.r),
                                    dtype=torch.float64, device=device)
                    if self.crc else None)

    def payload(self, fidx: torch.Tensor) -> torch.Tensor:
        """[B, K] int8 payloads of frames fidx [B] (int64)."""
        m = (fidx * (self.K % PN_PERIOD)) % PN_PERIOD
        k = torch.arange(self.K, device=fidx.device)
        return self.pn[(m[:, None] + k[None, :]) % PN_PERIOD]

    def codeword_bits(self, payload: torch.Tensor) -> torch.Tensor:
        """[B, K + r]: the payload times g(D), or the payload without a CRC."""
        return crc_multiply(payload, self.crc) if self.crc else payload

    def encode(self, w: torch.Tensor) -> torch.Tensor:
        """u with w at the info set (frozen bits 0), then x [B, N] int8."""
        u = torch.zeros((w.shape[0], self.N), dtype=torch.int8, device=w.device)
        u[:, self.info] = w
        return polar_encode(u)
