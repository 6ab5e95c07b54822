// Counter-based noise of the port on Hopper, shared by mc_channel.cu,
// bp_wave_mc.cu and frame_channel.cu: threefry2x32 words and the two
// Gaussians built on them.
//
//  - The MC engines' Gaussian (erfinv_of_bits, llr): the JAX package's
//    ops/noise.gaussian_from_bits as its jitted engines compute it, over the
//    strictly-open uniform of bits 9..31, w = -log((1-x)(1+x)); what
//    polardecoding_tpu_torch/ops/noise (counter_bits, mc_llr) computes.
//  - The frame step's Gaussian (uniform_jax, erfinv_jax): jax.random.normal
//    as XLA compiles it, over jax's uniform on [nextafter(-1, 0), 1),
//    w = -log1p(-x^2); what ops/noise (uniform_jax, erfinv_f32) computes.
//
// Both are bit for bit: every operation is a correctly rounded float32 add,
// multiply, __fdiv_rn, __fsqrt_rn or fmaf (the sources are built with
// -fmad=false and without fast math, so the compiler contracts nothing and
// the fmaf calls stand exactly where XLA's x86 CPU code has an FMA).  Two
// steps are written in another form whose every step is exact, so the
// value is the same: XLA's log takes its exponent to float by the 1.5 *
// 2^23 magic number, and the MC uniform is built from the word's bits under
// the exponent of 1.0, instead of conversions from integers.  Giles'
// polynomial pair is one chain of 8 fmaf in both; an element computes only
// the branch of log1p and of erf_inv that it takes.  Constants are the
// float32 values as hex literals.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mc {

// A rotate by a constant: nvcc makes the shift pair one funnel shift (SHF).
// Written with the __funnelshift_l intrinsic instead, the instance of
// bp_wave_mc.cu compiled for N = 1024 spilled 16 bytes and ran 1.6% slower
// on the H100 (scripts/torch_channel_parts.py --baseline; PERF.md §6).
__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 (20 rounds) under key (k0, k1) at counter (x0, x1), both
// output words, as jax's threefry_2x32.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[r % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + static_cast<uint32_t>(r + 1);
  }
  return make_uint2(x0, x1);
}

// The first output word only (the MC engines' counter word); the compiler
// drops the work that only the second word needs.
__device__ __forceinline__ uint32_t threefry_x0(uint32_t k0, uint32_t k1,
                                                uint32_t x0, uint32_t x1) {
  return threefry2x32(k0, k1, x0, x1).x;
}

// k as a float for -2^22 <= k < 2^22, exactly: the bits of 1.5 * 2^23 + k
// (whose ulp is 1) less 1.5 * 2^23.
__device__ __forceinline__ float small_int_to_float(int k) {
  return __int_as_float(0x4B400000 + k) - 12582912.0f;
}

// XLA's float32 log for t > 0 (ops/noise.log_f32): t = m 2^e with m in
// [sqrt(1/2), sqrt(2)), r = m - 1, a degree-9 polynomial in r and e ln 2 in
// two parts.
__device__ __forceinline__ float xla_logf(float t) {
  t = fmaxf(t, 0x1p-126f);
  const int bits = __float_as_int(t);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  float e = small_int_to_float((bits >> 23) - 127) + 1.0f;
  const bool low = m < 0x1.6a09e6p-1f;
  const float r = (m + -1.0f) + (low ? m : 0.0f);
  if (low) e = e - 1.0f;
  const float r2 = r * r;
  const float r3 = r2 * r;
  const float a = fmaf(fmaf(r, 0x1.204376p-4f, -0x1.d7a37p-4f), r, 0x1.de4a34p-4f);
  const float b = fmaf(fmaf(r, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), r, -0x1.555cap-3f);
  const float c = fmaf(fmaf(r, 0x1.999d58p-3f, -0x1.fffff8p-3f), r, 0x1.555554p-2f);
  const float poly = fmaf(r3, fmaf(r3, fmaf(r3, a, b), c), e * -0x1.bd0106p-13f);
  return fmaf(e, 0x1.63p-1f, fmaf(r2, -0.5f, r) + poly);
}

// XLA's float32 log1p for -1 < t <= 0 (ops/noise.log1p_f32): for |t| <
// sqrt(2) - 1, t - t^2/2 + t^3 P(t)/Q(t), else log(1 + t); only the branch
// taken is computed.
__device__ __forceinline__ float xla_log1pf(float t) {
  if (!(fabsf(t) < 0x1.a8279ap-2f)) return xla_logf(t + 1.0f);
  float q = 1.0f;
  q = fmaf(t, q, 0x1.e2035ap+3f);
  q = fmaf(t, q, 0x1.4c30b6p+6f);
  q = fmaf(t, q, 0x1.bb865ap+7f);
  q = fmaf(t, q, 0x1.351946p+8f);
  q = fmaf(t, q, 0x1.b0db14p+7f);
  q = fmaf(t, q, 0x1.e0f304p+5f);
  float p = 0x1.7bc096p-15f;
  p = fmaf(t, p, 0x1.fe818ap-2f);
  p = fmaf(t, p, 0x1.a509f4p+2f);
  p = fmaf(t, p, 0x1.de9738p+4f);
  p = fmaf(t, p, 0x1.e798ecp+5f);
  p = fmaf(t, p, 0x1.c8e75ap+5f);
  p = fmaf(t, p, 0x1.40a202p+4f);
  const float t2 = t * t;
  return t + fmaf(t2, -0.5f, (t * t2) * __fdiv_rn(p, q));
}

// Giles' single-precision erfinv polynomial, one fmaf a step (fma(ws, p, c)
// and fmaf(p, ws, c) round alike): in ws = w - 2.5 where w < 5, else in
// ws = sqrt(w) - 3.
__device__ __forceinline__ float giles_lt5(float ws) {
  float p = 0x1.e2cb1p-26f;
  p = fmaf(p, ws, 0x1.70966cp-22f);
  p = fmaf(p, ws, -0x1.d8e6aep-19f);
  p = fmaf(p, ws, -0x1.26b582p-18f);
  p = fmaf(p, ws, 0x1.ca65b6p-13f);
  p = fmaf(p, ws, -0x1.48a81p-10f);
  p = fmaf(p, ws, -0x1.11c9dep-8f);
  p = fmaf(p, ws, 0x1.f91ec6p-3f);
  return fmaf(p, ws, 0x1.805c5ep+0f);
}

__device__ __forceinline__ float giles_ge5(float ws) {
  float p = -0x1.a3e136p-13f;
  p = fmaf(p, ws, 0x1.a76ad6p-14f);
  p = fmaf(p, ws, 0x1.61b8e4p-10f);
  p = fmaf(p, ws, -0x1.e17bcep-9f);
  p = fmaf(p, ws, 0x1.7824f6p-8f);
  p = fmaf(p, ws, -0x1.f38baep-8f);
  p = fmaf(p, ws, 0x1.354afcp-7f);
  p = fmaf(p, ws, 0x1.006db6p+0f);
  return fmaf(p, ws, 0x1.6a9efcp+1f);
}

// ---------------------------------------------------------------------------
// The MC engines' Gaussian.

// Giles' erfinv of the strictly-open uniform x of `bits` (bits 9..31):
// x = 2 (f + 1/2) 2^-23 - 1 for the 23-bit f, w = -log((1-x)(1+x)), then the
// polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x.  x is formed from
// F = 1 + f 2^-23 (f under the exponent of 1.0) as ((F + F) - 3) + 2^-23:
// each step is exact (2F - 3 is a multiple of 2^-22 below 1 in magnitude,
// x = (2f + 1 - 2^23) 2^-23), as each of the plain version's (f + 0.5)
// 2^-23, 2u, 2u - 1 is, so x is the same value.
__device__ __forceinline__ float erfinv_of_bits(uint32_t bits) {
  const float one = __uint_as_float((bits >> 9) | 0x3F800000u);
  const float x = ((one + one) - 3.0f) + 0x1p-23f;
  const float w = -xla_logf((1.0f - x) * (1.0f + x));
  const float p = w < 5.0f ? giles_lt5(w - 2.5f)
                           : giles_ge5(__fsqrt_rn(w) - 3.0f);
  return p * x;
}

// LLR of codeword bit x (0.0 or 1.0) with the Gaussian of `bits`:
// (2/sigma) * fma(sqrt(2), erfinv(u), +-1/sigma), inv_s = 1/sigma.
__device__ __forceinline__ float llr(uint32_t bits, float x, float inv_s) {
  const float sgn = x > 0.5f ? -inv_s : inv_s;
  return (2.0f * inv_s) * fmaf(0x1.6a09e6p+0f, erfinv_of_bits(bits), sgn);
}

// ---------------------------------------------------------------------------
// The frame step's Gaussian (jax.random.normal).

// jax's uniform on [nextafter(-1, 0), 1) of a 32-bit word: the mantissa bits
// 9..31 under the exponent of 1.0, minus 1, times 2 (the scale 2 - 2^-24
// rounds to 2), plus the lower bound, clamped below.
__device__ __forceinline__ float uniform_jax(uint32_t bits) {
  const float one = __uint_as_float((bits >> 9) | 0x3F800000u);
  return fmaxf((one - 1.0f) * 2.0f + -0x1.fffffep-1f, -0x1.fffffep-1f);
}

// XLA's float32 erf_inv for |u| < 1: Giles' pair at w = -log1p(-u^2), in
// -2.5 - log1p(-u^2) where that is above -5, else in sqrt(-log1p) - 3,
// times u.
__device__ __forceinline__ float erfinv_jax(float u) {
  const float lg = xla_log1pf(u * -u);
  const float p = lg > -5.0f ? giles_lt5(-2.5f - lg)
                             : giles_ge5(__fsqrt_rn(-lg) + -3.0f);
  return p * u;
}

// ---------------------------------------------------------------------------
// The channel kernels' tiling of the flat [B, N] element array (N = 2^n): a
// block of kThreads takes a tile of kThreads * 2^kElemsLog consecutive
// elements, 2^kElemsLog a thread at a stride of kThreads, so that a warp's
// loads and stores are contiguous.  For n >= kTileLog that is a run of lanes
// of one frame, else 2^(kTileLog - n) whole frames (the last tile may hold
// fewer).  Frames and lanes come from shifts of the block and element
// index, never from a division.

constexpr int kThreads = 256;
constexpr int kThreadsLog = 8;

template <int kElemsLog>
struct Tile {
  static constexpr int kElems = 1 << kElemsLog;
  static constexpr int kTileLog = kThreadsLog + kElemsLog;
  static constexpr int kTile = 1 << kTileLog;

  int n;         // log2 N
  long long b0;  // the tile's first frame
  int frames;    // its frames: 1 for n >= kTileLog
  int c0;        // its first lane: 0 for n < kTileLog

  __device__ __forceinline__ Tile(int log_n, int B) : n(log_n) {
    const unsigned blk = blockIdx.x;
    if (n >= kTileLog) {
      b0 = blk >> (n - kTileLog);
      frames = 1;
      c0 = static_cast<int>((blk << kTileLog) & ((1u << n) - 1u));
    } else {
      b0 = static_cast<long long>(blk) << (kTileLog - n);
      frames = static_cast<int>(min(static_cast<long long>(kTile >> n), B - b0));
      c0 = 0;
    }
  }
  // element i = k * kThreads + threadIdx.x of the tile: its frame, counted
  // from b0, and its lane
  __device__ __forceinline__ int frame(int i) const {
    return n >= kTileLog ? 0 : i >> n;
  }
  __device__ __forceinline__ int lane(int i) const {
    return n >= kTileLog ? c0 + i : i & ((1 << n) - 1);
  }

  // blocks of the launch over B frames of N = 2^n lanes
  static long long blocks(int B, int n) {
    if (n >= kTileLog) return static_cast<long long>(B) << (n - kTileLog);
    const long long per = kTile >> n;
    return (B + per - 1) / per;
  }
};

}  // namespace mc
