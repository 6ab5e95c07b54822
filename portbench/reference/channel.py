"""BPSK over AWGN with counter-based noise: each frame's noise is a pure
function of (point key, frame index).

The generator is threefry2x32 as jax.random uses it (PRNGKey, fold_in,
bits), and the Gaussian is jax.random.normal's map of a 32-bit word: a
uniform on [nextafter(-1, 0), 1), XLA's float32 erf_inv (Giles' polynomial
pair over w = -log1p(-u^2), XLA's log1p and log) and sqrt(2).  Every
operation is a correctly rounded IEEE float32 operation; an FMA is emulated
exactly in float64, so the LLRs are the same on any device.

Reference semantics (SC_128.c:164-167, 192-202, 416-420): sigma =
10^(-EbN0/20), bit 0 -> +1, y = s + n, LLR = 2y / sigma^2.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_F32 = torch.float32


def _f32(v) -> float:
    return float(np.float32(v))


SQRT2 = _f32(1.4142135623730951)
_LOG_A = tuple(map(_f32, (0.070376836, -0.1151461, 0.116769984)))
_LOG_B = tuple(map(_f32, (-0.12420141, 0.14249323, -0.16668057)))
_LOG_C = tuple(map(_f32, (0.20000714, -0.24999994, 0.3333333)))
_LN2_LO, _LN2_HI = _f32(-0.00021219444), _f32(0.6933594)
_SQRT_HALF = _f32(0.70710677)
_FLT_MIN = _f32(1.1754944e-38)
LOG1P_SMALL = _f32(0.41421357)
_LOG1P_Q = tuple(map(_f32, (15.062909, 83.04757, 221.7624, 309.09872,
                            216.42789, 60.11866)))
_LOG1P_P = tuple(map(_f32, (4.527e-05, 0.49854103, 6.5787325, 29.911919,
                            60.94967, 57.112965, 20.039553)))
_W_LT5 = tuple(map(_f32, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941)))
_W_GE5 = tuple(map(_f32, (-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682)))

_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """One threefry-2x32 block (20 rounds): keys (k0, k1), counter (x0, x1);
    int64 tensors or ints holding 32-bit words, broadcast elementwise."""
    keys = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for r in range(5):
        for rot in (_ROT0 if r % 2 == 0 else _ROT1):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + keys[(r + 1) % 3]) & MASK32
        x1 = (x1 + keys[(r + 2) % 3] + (r + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed): the words (seed >> 32, seed & 0xFFFFFFFF)."""
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in of the 32-bit word(s) `data` into key [2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack((y0, y1), dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.bits(key, (n,), uint32) for each key of keys [..., 2]."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(j), j)
    return y0 ^ y1


def fma(a, b, c) -> torch.Tensor:
    """a*b + c rounded once to float32 (exact product in float64, the sum
    rounded to odd, then to float32)."""
    a = a.to(torch.float64) if isinstance(a, torch.Tensor) else a
    b = b.to(torch.float64) if isinstance(b, torch.Tensor) else b
    c = c.to(torch.float64) if isinstance(c, torch.Tensor) else c
    p = a * b
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return odd.view(torch.float64).to(_F32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of x >= 0."""
    s = torch.sqrt(x.to(torch.float64)).to(_F32)
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    dn = torch.nextafter(s, torch.zeros_like(s))
    x64, s64 = x.to(torch.float64), s.to(torch.float64)
    s = torch.where(((s64 + up.to(torch.float64)) * 0.5) ** 2 < x64, up, s)
    return torch.where(((s64 + dn.to(torch.float64)) * 0.5) ** 2 > x64, dn, s)


def log_f32(t: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log for t > 0."""
    t = torch.clamp_min(t, _FLT_MIN)
    bits = t.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    low = m < _SQRT_HALF
    r = (m + -1.0) + torch.where(low, m, torch.zeros_like(m))
    e = torch.where(low, e - 1.0, e)
    r2 = r * r
    r3 = r2 * r
    a = fma(fma(r, _LOG_A[0], _LOG_A[1]), r, _LOG_A[2])
    b = fma(fma(r, _LOG_B[0], _LOG_B[1]), r, _LOG_B[2])
    c = fma(fma(r, _LOG_C[0], _LOG_C[1]), r, _LOG_C[2])
    poly = fma(r3, fma(r3, fma(r3, a, b), c), e * _LN2_LO)
    return fma(e, _LN2_HI, fma(r2, -0.5, r) + poly)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: a rational form for |x| < sqrt(2) - 1, else
    log(1 + x)."""
    x2 = x * x
    zero = x * 0.0
    q = zero + 1.0
    for k in _LOG1P_Q:
        q = fma(x, q, k)
    p = zero + _LOG1P_P[0]
    for k in _LOG1P_P[1:]:
        p = fma(x, p, k)
    small = x + fma(x2, -0.5, (x * x2) * (p / q))
    return torch.where(torch.abs(x) < LOG1P_SMALL, small, log_f32(x + 1.0))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (Giles' pair at w = -log1p(-x^2)), |x| < 1."""
    lg = log1p_f32(x * -x)
    lt = lg > -5.0
    ws = torch.where(lt, -2.5 - lg, sqrt_f32(-lg) + -3.0)
    p = torch.where(lt, _W_LT5[0], _W_GE5[0]).to(_F32)
    for a, b in zip(_W_LT5[1:], _W_GE5[1:]):
        p = fma(ws, p, torch.where(lt, a, b).to(_F32))
    return p * x


def uniform(words: torch.Tensor) -> torch.Tensor:
    """32-bit words -> jax.random.normal's float32 uniform on
    [nextafter(-1, 0), 1)."""
    one_bits = ((words >> 9) | 0x3F800000).to(torch.int32)
    lo = _f32(-1.0 + 2.0 ** -24)
    return torch.clamp_min((one_bits.view(_F32) - 1.0) * 2.0 + lo, lo)


def llr_from_words(x: torch.Tensor, words: torch.Tensor, sigma: float) -> torch.Tensor:
    """Channel LLRs [B, N] float32 of codeword bits x [B, N] with the noise
    of the words [B, N]: y = fma(erfinv(u), sigma * sqrt(2), 1 - 2x), then
    (y + y) / sigma^2, every step in float32."""
    u = uniform(words & MASK32)
    s = torch.tensor(sigma, dtype=_F32, device=x.device)
    y = fma(erfinv_f32(u), s * SQRT2, 1.0 - 2.0 * x.to(_F32))
    return (y + y) / (s * s)


def noise_words(key: torch.Tensor, fidx: torch.Tensor, n: int) -> torch.Tensor:
    """The channel's 32-bit words [B, n] of frames fidx [B] under the point
    key [2]: jax.random.bits of fold_in(key, frame index)."""
    return random_bits(fold_in(key, fidx), n)


def point_key(seed: int, snr_db: float, device=None) -> torch.Tensor:
    """A point's key: fold_in(PRNGKey(seed), round(100 * SNR in dB))."""
    return fold_in(prng_key(seed, device), int(round(snr_db * 100)))


def sigma_of(snr_db: float) -> float:
    return float(10.0 ** (-snr_db / 20.0))
