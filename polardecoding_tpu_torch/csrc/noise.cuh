// Counter-based noise of the MC engines, shared by mc_channel.cu and
// bp_wave_mc.cu: threefry2x32 words, the Gaussian of the JAX package's
// ops/noise.gaussian_from_bits as its jitted engines compute it, and the
// channel LLR.  It computes what polardecoding_tpu_torch/ops/noise
// (counter_bits, mc_llr) computes, bit for bit: every operation is a
// correctly rounded float32 add, multiply, divide, sqrtf or fmaf (the
// sources are built with -fmad=false and without fast math, so the compiler
// contracts nothing and the fmaf calls stand exactly where XLA's x86 CPU code
// has an FMA).  Constants are the float32 values as hex literals.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mc {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// First output word of threefry2x32 (20 rounds) under key (k0, k1) at
// counter (x0, x1), as jax's threefry_2x32.
__device__ __forceinline__ uint32_t threefry_x0(uint32_t k0, uint32_t k1,
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
  return x0;
}

// XLA's float32 log for t > 0 (ops/noise.log_f32): t = m 2^e with m in
// [sqrt(1/2), sqrt(2)), r = m - 1, a degree-9 polynomial in r and e ln 2 in
// two parts.
__device__ __forceinline__ float xla_logf(float t) {
  t = fmaxf(t, 0x1p-126f);
  const int bits = __float_as_int(t);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  float e = static_cast<float>((bits >> 23) - 127) + 1.0f;
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

// Giles' erfinv of the strictly-open uniform x of `bits` (bits 9..31):
// w = -log((1-x)(1+x)), then the polynomial in w - 2.5 (w < 5) or
// sqrt(w) - 3, one fmaf per step, times x.
__device__ __forceinline__ float erfinv_of_bits(uint32_t bits) {
  constexpr float kLt5[9] = {
      0x1.e2cb1p-26f,  0x1.70966cp-22f, -0x1.d8e6aep-19f,
      -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
      -0x1.11c9dep-8f,  0x1.f91ec6p-3f,  0x1.805c5ep+0f};
  constexpr float kGe5[9] = {
      -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
      -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
      0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
  const float f = static_cast<float>((bits >> 9) & 0x7FFFFFu);
  const float u = (f + 0.5f) * 0x1p-23f;  // (0, 1) strictly
  const float x = 2.0f * u - 1.0f;
  const float w = -xla_logf((1.0f - x) * (1.0f + x));
  const bool lt = w < 5.0f;
  const float ws = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) p = fmaf(p, ws, lt ? kLt5[k] : kGe5[k]);
  return p * x;
}

// LLR of codeword bit x (0.0 or 1.0) with the Gaussian of `bits`:
// (2/sigma) * fma(sqrt(2), erfinv(u), +-1/sigma), inv_s = 1/sigma.
__device__ __forceinline__ float llr(uint32_t bits, float x, float inv_s) {
  const float sgn = x > 0.5f ? -inv_s : inv_s;
  return (2.0f * inv_s) * fmaf(0x1.6a09e6p+0f, erfinv_of_bits(bits), sgn);
}

}  // namespace mc
