"""Counter-based threefry2x32 and the bits -> Gaussian maps (torch port of
polardecoding_tpu.ops.noise), in float32 arithmetic that reproduces XLA's.

torch has no full uint32 arithmetic, so 32-bit words are held in int64
tensors in [0, 2^32) and every sum or shift is masked back to 32 bits.

The JAX package's channel draws jax.random.normal, whose erf_inv XLA
lowers to the Giles (2012) single-precision polynomial pair over
w = -log1p(-x^2), with log1p a Cephes-style rational/polynomial
approximation.  Compiled for an x86 CPU with FMA, XLA fuses most of the
multiply-add pairs of those polynomials into FMAs.  The functions here run
the same float32 operations in the same order, with `fma` exactly where the
compiled code has one, so normals and channel LLRs are bit-equal to the JAX
package's frame step on such a CPU.  Every operation is a correctly rounded
IEEE operation (add, multiply, divide, `sqrt_f32`, and `fma` emulated
exactly in float64), so the results are also the same on the card and on
the CPU.  torch.erfinv is a different approximation, and torch's CPU sqrt
is not correctly rounded in the last ulp; neither is used.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
MASK32 = 0xFFFFFFFF


def _f32(v) -> float:
    """v rounded to float32, as a Python float (exact in float64)."""
    return float(np.float32(v))


SQRT2 = _f32(1.4142135623730951)
# log(t), t > 0, as XLA lowers it: t = m 2^e with m in [sqrt(1/2), sqrt(2)),
# r = m - 1, a degree-9 polynomial in r and e ln 2 split in two parts
_LOG_A = tuple(map(_f32, (0.070376836, -0.1151461, 0.116769984)))
_LOG_B = tuple(map(_f32, (-0.12420141, 0.14249323, -0.16668057)))
_LOG_C = tuple(map(_f32, (0.20000714, -0.24999994, 0.3333333)))
_LN2_LO, _LN2_HI = _f32(-0.00021219444), _f32(0.6933594)
_SQRT_HALF = _f32(0.70710677)
_FLT_MIN = _f32(1.1754944e-38)
# log1p(x) for |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x)
_LOG1P_SMALL = _f32(0.41421357)
_LOG1P_Q = tuple(map(_f32, (15.062909, 83.04757, 221.7624, 309.09872,
                            216.42789, 60.11866)))
_LOG1P_P = tuple(map(_f32, (4.527e-05, 0.49854103, 6.5787325, 29.911919,
                            60.94967, 57.112965, 20.039553)))
# Giles' erfinv pair: w < 5 in (w - 2.5), else in (sqrt(w) - 3)
_W_LT5 = tuple(map(_f32, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941)))
_W_GE5 = tuple(map(_f32, (-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682)))


def _f64(v):
    return v.to(torch.float64) if isinstance(v, torch.Tensor) else v


def fma(a, b, c) -> torch.Tensor:
    """a*b + c rounded once to float32, exactly as a hardware FMA.

    The product of two float32 values is exact in float64; the sum is
    rounded to odd in float64 (TwoSum gives its error, and an inexact even
    result moves one ulp toward the exact sum), and rounding a value rounded
    to odd with 53 bits to 24 bits is correctly rounded.  Tensors must be
    float32; a Python float must hold a float32 value (`_f32`)."""
    p = _f64(a) * _f64(b)
    s = p + _f64(c)
    v = s - p
    err = (p - (s - v)) + (_f64(c) - v)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return odd.view(torch.float64).to(_F32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of x >= 0: the float64 root
    rounded to float32, then moved to a neighbour if the midpoint test
    (exact in float64) says the rounding went the wrong way."""
    s = torch.sqrt(x.to(torch.float64)).to(_F32)
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    dn = torch.nextafter(s, torch.zeros_like(s))
    x64, s64 = x.to(torch.float64), s.to(torch.float64)
    hi = (s64 + up.to(torch.float64)) * 0.5
    lo = (s64 + dn.to(torch.float64)) * 0.5
    s = torch.where(hi * hi < x64, up, s)
    return torch.where(lo * lo > x64, dn, s)


def _select(cond, a: float, b: float) -> torch.Tensor:
    return torch.where(cond, a, b).to(_F32)


def log_f32(t: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log for finite t > 0 (smaller t is clamped to the
    smallest normal)."""
    t = torch.clamp_min(t, _FLT_MIN)
    bits = t.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)  # in [1/2, 1)
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
    """XLA's float32 log1p for x > -1: a rational approximation for
    |x| < sqrt(2) - 1, log(1 + x) otherwise."""
    x2 = x * x
    zero = x * 0.0
    q = zero + 1.0
    for k in _LOG1P_Q:
        q = fma(x, q, k)
    p = zero + _LOG1P_P[0]
    for k in _LOG1P_P[1:]:
        p = fma(x, p, k)
    small = x + fma(x2, -0.5, (x * x2) * (p / q))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, log_f32(x + 1.0))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """Single-precision inverse error function as XLA computes it (Giles'
    polynomial pair at w = -log1p(-x^2)); |x| must be < 1."""
    x = x.to(_F32)
    lg = log1p_f32(x * -x)  # -w
    lt = lg > -5.0
    ws = torch.where(lt, -2.5 - lg, sqrt_f32(-lg) + -3.0)
    p = _select(lt, _W_LT5[0], _W_GE5[0])
    for a, b in zip(_W_LT5[1:], _W_GE5[1:]):
        p = fma(ws, p, _select(lt, a, b))
    return p * x


def uniform_jax(bits: torch.Tensor) -> torch.Tensor:
    """32-bit random words -> the float32 uniform on [nextafter(-1, 0), 1)
    that jax.random.normal draws: mantissa bits | 1.0, minus 1, times 2
    (the scale 2 - 2^-24 rounds to 2.0 in float32), plus the lower bound,
    clamped below."""
    one_bits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    lo = _f32(-1.0 + 2.0 ** -24)
    return torch.clamp_min((one_bits.view(_F32) - 1.0) * 2.0 + lo, lo)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit random words -> float32 standard normal, the map of
    jax.random.normal: sqrt(2) erfinv(uniform_jax(bits))."""
    return erfinv_f32(uniform_jax(bits)) * SQRT2


def uniform_pm1_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit random words -> float32 uniform strictly inside (-1, 1), from
    bits 9..31 (the JAX package's in-kernel map, used by its MC engines)."""
    f = ((bits >> 9) & 0x7FFFFF).to(_F32)
    u = (f + 0.5) * (2.0 ** -23)  # (0, 1) strictly
    return 2.0 * u - 1.0


def _erfinv_times_x(bits: torch.Tensor) -> torch.Tensor:
    """erfinv(x) for the strictly-open uniform x of `bits`, as the JAX
    package's in-kernel Gaussian forms it inside its jitted engines:
    w = -log((1-x)(1+x)), then one of Giles' polynomials in w - 2.5 or
    sqrt(w) - 3 with one fma per step, as XLA's x86 CPU code contracts
    them, times x.  (Run eagerly, op by op, the JAX function steps with a
    multiply and an add and differs on about 4% of samples.)"""
    x = uniform_pm1_from_bits(bits)
    w = -log_f32((1.0 - x) * (1.0 + x))
    lt = w < 5.0
    ws = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)
    p = _select(lt, _W_LT5[0], _W_GE5[0])
    for a, b in zip(_W_LT5[1:], _W_GE5[1:]):
        p = fma(p, ws, _select(lt, a, b))
    return p * x


def gaussian_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Random bits -> float32 standard normal through the strictly-open
    uniform map: the JAX package's in-kernel Gaussian as its jitted engines
    compute it (see _erfinv_times_x)."""
    return SQRT2 * _erfinv_times_x(bits)


def mc_llr(bits: torch.Tensor, x: torch.Tensor, sigma) -> torch.Tensor:
    """Channel LLRs of codeword bits x (0/1 float32) with the Gaussian of
    `bits`, as the JAX package's MC engines compute them under jit
    (bp_wave_mc_jnp and mc_channel_jnp, in both of which XLA contracts the
    same way): (2/sigma) * fma(sqrt(2), erfinv(u), +-1/sigma), the BPSK sign
    taken by a select.  csrc/noise.cuh computes the same with fmaf."""
    inv_s = 1.0 / torch.as_tensor(sigma, dtype=_F32, device=x.device)
    sgn = torch.where(x > 0.5, -inv_s, inv_s)
    return (2.0 * inv_s) * fma(SQRT2, _erfinv_times_x(bits), sgn)


def counter_bits(k0: int, k1: int, c_hi: int, batch: int, N: int,
                 device=None) -> torch.Tensor:
    """The in-kernel generator of the JAX package's MC engines: words
    [batch, N] (int64), the first word of threefry2x32 under key (k0, k1)
    at counter (c_hi, row * N + lane)."""
    lanes = (torch.arange(batch, dtype=torch.int64, device=device)[:, None] * N
             + torch.arange(N, dtype=torch.int64, device=device))
    return threefry2x32(k0 & MASK32, k1 & MASK32, c_hi & MASK32,
                        lanes & MASK32)[0]


# ---------------------------------------------------------------------------
# Counter-based threefry2x32, bit-exact against jax._src.prng.threefry_2x32.

_TF_ROT0 = (13, 15, 26, 6)
_TF_ROT1 = (17, 29, 16, 24)
_TF_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """One threefry-2x32 block: keys (k0, k1), counter words (x0, x1) -> two
    output words.  All int64 tensors (or ints) holding 32-bit words;
    tensors broadcast elementwise."""
    ks2 = k0 ^ k1 ^ _TF_PARITY
    keys = (k0, k1, ks2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for r in range(5):
        rots = _TF_ROT0 if r % 2 == 0 else _TF_ROT1
        for rot in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + keys[(r + 1) % 3]) & MASK32
        x1 = (x1 + keys[(r + 2) % 3] + (r + 1)) & MASK32
    return x0, x1
