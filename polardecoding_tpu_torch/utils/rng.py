"""The reference's random-number stream, for exact-parity ("golden") mode
(copied from polardecoding_tpu.utils.rng, numpy only).

A faithful port of the reference's RNG, so decoded frames can be compared
bit for bit with the C programs at matched seeds:
  - Ranq1: 64-bit xorshift-multiply uniform PRNG, Numerical-Recipes constants
    (ref: SC_128.c:235-250);
  - normal(): Marsaglia polar method producing two N(0, sigma^2) samples per
    call, including the unit-circle rejection loop (ref: SC_128.c:252-267);
  - the channel consumes samples pairwise: one normal() call per two codeword
    positions (ref: SC_128.c:192-202).
It runs on the host in float64 numpy: one global stream with a rejection
loop, whose bits a device's arithmetic would not reproduce (the unsigned
64-bit products wrap in numpy uint64, which torch lacks, and the log is
libm's).  The port's throughput-mode generator is ops/noise.py.
"""
from __future__ import annotations

import math

import numpy as np

_RANQ1_XOR = 4101842887655102017
_RANQ1_MUL = 2685821657736338717
_RANQ1_SCALE = 5.42101086242752217e-20
_U64 = (1 << 64) - 1


class Ranq1:
    """Exact port of the reference's Ranq1 xorshift-multiply PRNG."""

    def __init__(self, seed: int):
        v = (seed ^ _RANQ1_XOR) & _U64
        v ^= v >> 21
        v = (v ^ (v << 35)) & _U64
        v ^= v >> 4
        self._v = (v * _RANQ1_MUL) & _U64

    def next_u64(self) -> int:
        v = self._v
        v ^= v >> 21
        v = (v ^ (v << 35)) & _U64
        v ^= v >> 4
        self._v = v
        return (v * _RANQ1_MUL) & _U64

    def uniform(self) -> float:
        """Uniform in [0, 1): u64 * 5.42101086242752217e-20.

        In the C code `RANV * 2685821657736338717LL * 5.42...E-20` the integer
        product wraps mod 2^64 as unsigned and is then converted (unsigned) to
        double before the final scale.
        """
        return self.next_u64() * _RANQ1_SCALE


class MarsagliaNormal:
    """Exact port of normal(): two sigma-scaled Gaussians per call via the polar
    method with rejection (ref: SC_128.c:252-267)."""

    def __init__(self, seed: int):
        self.rng = Ranq1(seed)

    def pair(self, sigma: float) -> tuple[float, float]:
        while True:
            x1 = 2.0 * self.rng.uniform() - 1.0
            x2 = 2.0 * self.rng.uniform() - 1.0
            s = x1 * x1 + x2 * x2
            if s < 1.0:
                break
        f = math.sqrt(-2.0 * math.log(s) / s)
        return sigma * x1 * f, sigma * x2 * f


def golden_noise_scalar(seed: int, num_frames: int, N: int,
                        sigma: float) -> np.ndarray:
    """Scalar-loop reference for the exact noise array the C programs add to
    `num_frames` consecutive frames: one normal() call per two positions, n1
    then n2 (SC_128.c:192-202).

    Note: the golden stream is shared across frames (one global RNG), so noise
    for frame f depends on all earlier frames — this mode exists solely for
    frame-for-frame parity tests against the C programs.
    """
    gen = MarsagliaNormal(seed)
    out = np.empty((num_frames, N), dtype=np.float64)
    for f in range(num_frames):
        for i in range(0, N, 2):
            n1, n2 = gen.pair(sigma)
            out[f, i] = n1
            if i + 1 < N:
                out[f, i + 1] = n2
    return out


# ---------------------------------------------------------------------------
# Vectorized exact-parity stream (SURVEY §7.7's "vectorized Ranq1")
#
# Two observations make the sequential global stream parallelizable after all:
#
# 1. Ranq1's state transition v → (v ^= v>>21; v ^= v<<35; v ^= v>>4) is
#    LINEAR over GF(2)^64 (the multiply by 2685821657736338717 happens only on
#    the *output*, not the state).  Any stride of the state recurrence is
#    therefore a 64×64 bit-matrix power A^k, applied to a whole vector of
#    lane states with 64 u64 XOR-select ops — lane j carries stream positions
#    j, j+W, j+2W, … and the single global stream is reproduced exactly, in
#    order, W lanes at a time.
# 2. Marsaglia rejection consumes a data-dependent number of draws per
#    sample, but the consumption pattern is still static in the *uniform*
#    stream: every loop iteration eats exactly one aligned pair
#    (u[2p], u[2p+1]), and the accepted pairs — in stream order — are exactly
#    the emitted Gaussians.  So: oversample pairs, compute the accept mask
#    s < 1 elementwise, and compact.  No serialization anywhere.
# ---------------------------------------------------------------------------

def _xorshift_cols() -> np.ndarray:
    """Columns of the GF(2) state-transition matrix A: col i = f(e_i)."""
    e = np.uint64(1) << np.arange(64, dtype=np.uint64)
    v = e.copy()
    v ^= v >> np.uint64(21)
    v ^= v << np.uint64(35)
    v ^= v >> np.uint64(4)
    return v


def _mat_apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """y = M·v over GF(2): XOR of cols[i] wherever bit i of v is set."""
    y = np.zeros_like(v)
    for i in range(64):
        bit = (v >> np.uint64(i)) & np.uint64(1)
        y ^= cols[i] * bit  # bit ∈ {0,1}: select-or-zero, stays u64
    return y


def _mat_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(A∘B) as columns: apply A to each column of B."""
    return _mat_apply(a, b)


def _mat_power(cols: np.ndarray, k: int) -> np.ndarray:
    """A^k by square-and-multiply (columns representation)."""
    acc = np.uint64(1) << np.arange(64, dtype=np.uint64)  # identity
    sq = cols
    while k:
        if k & 1:
            acc = _mat_compose(sq, acc)
        sq = _mat_compose(sq, sq)
        k >>= 1
    return acc


def ranq1_uniform_block(seed: int, count: int, lanes: int = 512) -> np.ndarray:
    """First `count` uniforms of the reference's single global Ranq1 stream,
    computed `lanes` positions at a time via GF(2) leapfrog (bit-exact to
    Ranq1.uniform: same u64 → f64 conversion, same 5.42101086242752217e-20
    scale — ref SC_128.c:235-250)."""
    if count == 0:
        return np.empty(0, dtype=np.float64)
    with np.errstate(over="ignore"):
        r = Ranq1(seed)
        lanes = min(lanes, count)
        # seed lanes 0..W-1 with the first W states (scalar warmup, W steps)
        states = np.empty(lanes, dtype=np.uint64)
        v = np.uint64(r._v)
        for j in range(lanes):
            v ^= v >> np.uint64(21)
            v ^= v << np.uint64(35)
            v ^= v >> np.uint64(4)
            states[j] = v
        aw = _mat_power(_xorshift_cols(), lanes)
        mul = np.uint64(_RANQ1_MUL)
        blocks = []
        produced = 0
        while produced < count:
            blocks.append(states * mul)  # wraps mod 2^64, as in C
            produced += lanes
            if produced < count:
                states = _mat_apply(aw, states)
        u = np.concatenate(blocks)[:count]
    return u.astype(np.float64) * _RANQ1_SCALE


def golden_noise(seed: int, num_frames: int, N: int, sigma: float,
                 _chunk_pairs: int = 1 << 16) -> np.ndarray:
    """Vectorized twin of golden_noise_scalar: identical output bits, ~100×
    faster.  Oversamples uniform pairs from the leapfrogged stream, keeps the
    accepted (s < 1) pairs in order, and scales by Marsaglia's factor — every
    float op (2u−1, x², +, −2·log/s, sqrt, σ·x·f) is the same IEEE double op
    the scalar path performs, in the same association (SC_128.c:252-267)."""
    calls = num_frames * ((N + 1) // 2)  # one normal() per two positions
    if calls == 0:
        return np.empty((num_frames, N), dtype=np.float64)
    r = Ranq1(seed)
    cols = _xorshift_cols()
    # wide lanes amortize numpy per-op overhead in _mat_apply (measured:
    # 512 lanes = 0.51 s, 8192 = 0.13 s for 500 frames at N=1024)
    lanes = min(8192, max(64, 2 * calls))
    aw = _mat_power(cols, lanes)
    mul = np.uint64(_RANQ1_MUL)

    # lane warmup (states for stream positions 0..lanes-1)
    states = np.empty(lanes, dtype=np.uint64)
    v = np.uint64(r._v)
    with np.errstate(over="ignore"):
        for j in range(lanes):
            v ^= v >> np.uint64(21)
            v ^= v << np.uint64(35)
            v ^= v >> np.uint64(4)
            states[j] = v

    n1s, n2s = [], []
    accepted = 0
    with np.errstate(over="ignore"):
        while accepted < calls:
            # oversample remaining need by 1/(π/4) plus 5σ margin, capped
            need = calls - accepted
            pairs = min(_chunk_pairs,
                        int(need * 1.28) + 5 * int(need ** 0.5) + 64)
            # one chunk of uniforms = ceil(2*pairs / lanes) lane waves
            waves = (2 * pairs + lanes - 1) // lanes
            outs = np.empty((waves, lanes), dtype=np.uint64)
            for w in range(waves):
                outs[w] = states * mul
                states = _mat_apply(aw, states)
            u = outs.reshape(-1).astype(np.float64) * _RANQ1_SCALE
            x1 = 2.0 * u[0::2] - 1.0
            x2 = 2.0 * u[1::2] - 1.0
            s = x1 * x1 + x2 * x2
            keep = s < 1.0
            x1, x2, s = x1[keep], x2[keep], s[keep]
            # log must be libm's (math.log): numpy's SIMD log differs in the
            # last ulp on ~0.3 % of inputs, which the parity tests catch.
            # One scalar call per ACCEPTED pair; all else stays vectorized.
            logs = np.array([math.log(x) for x in s], dtype=np.float64)
            f = np.sqrt(-2.0 * logs / s)
            n1s.append((sigma * x1) * f)  # same association as sigma*x1*f
            n2s.append((sigma * x2) * f)
            accepted += x1.size
    n1 = np.concatenate(n1s)[:calls]
    n2 = np.concatenate(n2s)[:calls]

    out = np.empty((num_frames, ((N + 1) // 2) * 2), dtype=np.float64)
    out[:, 0::2] = n1.reshape(num_frames, -1)
    out[:, 1::2] = n2.reshape(num_frames, -1)
    return out[:, :N]
