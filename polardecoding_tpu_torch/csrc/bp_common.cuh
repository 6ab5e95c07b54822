// Device code shared by the BP kernels (bp_decode.cu, bp_wave.cu,
// bp_wave_mc.cu): the table-corrected CHK, one flooding iteration over a
// block's lattice in shared memory, the decision and the G-matrix rule.
//
// A block holds one frame: L and R are its (n+1) x N message lattices in
// shared memory (L[n] the channel LLRs, R[0] the frozen row, 999 or 0), and
// its N/2 threads each own the stage-i butterfly pair (u, u + 2^i) with
// u = ((t >> i) << (i + 1)) | (t & (2^i - 1)).  An iteration is an R-sweep
// over stages 0..n-1 then an L-sweep over n-1..0, with __syncthreads()
// between stages for the reference's Gauss-Seidel order.  The four butterfly
// equations keep the plain version's (models/bp.bp_iteration) operand order,
// and the sources are built with -fmad=false, so no a*b+c is contracted and
// every result is bit-equal to the plain version's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bp {

// ops/chk.py LUT_THRESHOLDS / LUT_VALUES as f32 literals.
constexpr float kT0 = 0.196f, kT1 = 0.433f, kT2 = 0.71f, kT3 = 1.05f,
                kT4 = 1.508f, kT5 = 2.252f, kT6 = 4.5f;
constexpr float kV0 = 0.65f, kV1 = 0.55f, kV2 = 0.45f, kV3 = 0.35f,
                kV4 = 0.25f, kV5 = 0.15f, kV6 = 0.05f, kV7 = 0.0f;

enum Flavor { kMinsumLut = 0, kMinsumLutFast = 1, kSpa = 2 };

// The balanced select tree of ops/chk._lut_tree: a value exactly at a
// threshold falls in the upper bin, NaN in bin 0.
__device__ __forceinline__ float lut(float x) {
  return x >= kT3 ? (x >= kT5 ? (x >= kT6 ? kV7 : kV6) : (x >= kT4 ? kV5 : kV4))
                  : (x >= kT1 ? (x >= kT2 ? kV3 : kV2) : (x >= kT0 ? kV1 : kV0));
}

template <int F>
__device__ __forceinline__ float chk(float a, float b) {
  if (F == kMinsumLutFast) {
    const float ap = fabsf(a + b), aq = fabsf(a - b);
    return 0.5f * (ap - aq) + (lut(ap) - lut(aq));
  }
  const float s = ((a >= 0.f) == (b >= 0.f)) ? 1.f : -1.f;
  const float sm = s * fminf(fabsf(a), fabsf(b));
  if (F == kSpa) {
    return sm + log1pf(expf(-fabsf(a + b))) - log1pf(expf(-fabsf(a - b)));
  }
  return sm + (lut(fabsf(a + b)) - lut(fabsf(a - b)));
}

// One flooding iteration; every thread of the block must call it.
template <int F>
__device__ __forceinline__ void iteration(float* L, float* R, int n, int N,
                                          int t) {
  for (int i = 0; i < n; ++i) {
    const int d = 1 << i;
    const int u = ((t >> i) << (i + 1)) | (t & (d - 1));
    const int l = u + d;
    const float ru = R[i * N + u], rd = R[i * N + l];
    const float lu = L[(i + 1) * N + u], ld = L[(i + 1) * N + l];
    R[(i + 1) * N + u] = chk<F>(ru, ld + rd);
    R[(i + 1) * N + l] = rd + chk<F>(ru, lu);
    __syncthreads();
  }
  for (int i = n - 1; i >= 0; --i) {
    const int d = 1 << i;
    const int u = ((t >> i) << (i + 1)) | (t & (d - 1));
    const int l = u + d;
    const float ru = R[i * N + u], rd = R[i * N + l];
    const float lu = L[(i + 1) * N + u], ld = L[(i + 1) * N + l];
    L[i * N + u] = chk<F>(lu, ld + rd);
    L[i * N + l] = ld + chk<F>(ru, lu);
    __syncthreads();
  }
}

// The hard decision of position p: 0 on a frozen bit (R[0] > 0), else
// sign(L[0] + R[0]).
__device__ __forceinline__ uint8_t decision(const float* L, const float* R,
                                            int p) {
  return (R[p] > 0.f) ? 0 : (L[p] + R[p] < 0.f ? 1 : 0);
}

// The G-matrix rule: the decision re-encoded (n xor stages in x, N bytes of
// shared scratch) equals the channel-stage hard decision sign(L[n] + R[n])
// at every position.  Every thread of the block must call it; the result
// is the same in all of them.
__device__ __forceinline__ bool gmat_ok(const float* L, const float* R,
                                        uint8_t* x, int n, int N, int t) {
  const int half = N >> 1;
  for (int p = t; p < N; p += half) x[p] = decision(L, R, p);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int d = 1 << i;
    const int u = ((t >> i) << (i + 1)) | (t & (d - 1));
    x[u] ^= x[u + d];
    __syncthreads();
  }
  int ok = 1;
  for (int p = t; p < N; p += half) {
    const uint8_t post = (L[n * N + p] + R[n * N + p] < 0.f) ? 1 : 0;
    ok &= (x[p] == post);
  }
  return __syncthreads_and(ok) != 0;
}

// Shared memory of one block: the two lattices and the encode scratch.
inline size_t lattice_bytes(int n) {
  const size_t N = size_t{1} << n;
  return 2 * static_cast<size_t>(n + 1) * N * sizeof(float) + N;
}

// log2 of a power of two N in [8, 1024], else -1.
inline int log2_of(int N) {
  int n = 0;
  while ((1 << n) < N && n < 11) ++n;
  return (N >= 8 && N <= 1024 && (1 << n) == N) ? n : -1;
}

}  // namespace bp
