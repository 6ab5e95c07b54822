// The SCL kernel's operation patterns, iterated on tiles, on Hopper
// (sm_90a): the sustained rate of the path gather, the LUT ladder, the
// 2L-candidate rank and CHK rows.
//
// Replaces the TPU microbenchmark scripts/microbench_rolls.py:164 (run(kind)
// over _gather_kernel, _gather_rows_kernel, _lut_kernel, _rank_kernel and
// _chk_kernel) and computes what
// polardecoding_tpu_torch/ops/microbench_kernel.{gather,gather_rows,lut,
// rank,chk}_plain compute, bit for bit.
//
// A tile is [rows, 8, 128] f32 as on the TPU: rows x 8 lines of 128 lanes,
// path p on lanes [p W, (p + 1) W), W = 128 / L.  Each iteration computes,
// in the JAX body's order:
//   gather  out = sum_d mask_d * roll(a, d W) along the lanes, a = out * 0.5,
//           mask_d = ((p - d) mod L == p);
//   lut     a = fma(a, 0.9999, lut(|a|) * 0.001);
//   rank    c1 = a * 1.0001, the rank0/rank1 counts of the rolled c0 and c1,
//           a = fma(rank1, 1e-6, fma(a, 0.9999, rank0 * 1e-6));
//   chk     (up, dn) -> (chk(up, dn), fma(up, 0.999, dn)), up the first
//           rows / 2 rows.
// The fmas are where the JAX package's CPU build contracts the JAX body
// (XLA fuses a product into the add that follows it): the CPU reference
// of the plain versions.  Every other product and sum is rounded on its
// own (-fmad=false).
//
// Design: one block of 8 warps per tile ("copies" tiles, one per block);
// a warp takes a line (gather, rank, lut) or a pair of lines (chk) at a
// time, 4 lanes per thread, and runs all iterations on it in registers.  A
// roll is a read of the warp's line from shared memory, as the SCL kernel
// reads rows, between two __syncwarp.
//
// What bounds it on this card: operations; it measures how many of the
// card's 33.5e12 float32 operations per second (132 SMs x 128 lanes x
// 1.98 GHz) these patterns sustain, per SM with one tile and for the card
// with many.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kLanes = 128;

enum Pattern { kGather = 0, kLut = 1, kRank = 2, kChk = 3 };

// ops/chk.py LUT_THRESHOLDS / LUT_VALUES as f32 literals, in
// csrc/scl_decode.cu's balanced select tree.
constexpr float kT0 = 0.196f, kT1 = 0.433f, kT2 = 0.71f, kT3 = 1.05f,
                kT4 = 1.508f, kT5 = 2.252f, kT6 = 4.5f;
constexpr float kV0 = 0.65f, kV1 = 0.55f, kV2 = 0.45f, kV3 = 0.35f,
                kV4 = 0.25f, kV5 = 0.15f, kV6 = 0.05f, kV7 = 0.0f;

__device__ __forceinline__ float lut(float x) {
  return x >= kT3 ? (x >= kT5 ? (x >= kT6 ? kV7 : kV6) : (x >= kT4 ? kV5 : kV4))
                  : (x >= kT1 ? (x >= kT2 ? kV3 : kV2) : (x >= kT0 ? kV1 : kV0));
}

__device__ __forceinline__ float chk(float a, float b) {
  const float s = ((a >= 0.f) == (b >= 0.f)) ? 1.f : -1.f;
  const float sm = s * fminf(fabsf(a), fabsf(b));
  return sm + (lut(fabsf(a + b)) - lut(fabsf(a - b)));
}

// chk: a warp takes the pair of lines (u, u + rows/2 * 8) at a time.
__device__ void chk_tile(const float* src, float* dst, int rows, int iters,
                         int warp, int t) {
  const int half = rows / 2 * 8;  // lines of the upper half
  for (int u = warp; u < half; u += kWarps) {
    float up[4], dn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      up[j] = src[static_cast<size_t>(u) * kLanes + t + 32 * j];
      dn[j] = src[static_cast<size_t>(u + half) * kLanes + t + 32 * j];
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = up[j], b = dn[j];
        up[j] = chk(a, b);
        dn[j] = fmaf(a, 0.999f, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[static_cast<size_t>(u) * kLanes + t + 32 * j] = up[j];
      dst[static_cast<size_t>(u + half) * kLanes + t + 32 * j] = dn[j];
    }
  }
}

// One iteration of gather, lut or rank on a line, 4 lanes per thread in
// a; b0 and b1 are the warp's two line buffers in shared memory.
template <int kPattern, int L>
__device__ __forceinline__ void line_step(float (&a)[4], float* b0, float* b1,
                                          int t) {
  constexpr int W = kLanes / L;
  if constexpr (kPattern == kLut) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = fmaf(a[j], 0.9999f, lut(fabsf(a[j])) * 0.001f);
    }
  } else if constexpr (kPattern == kGather) {
#pragma unroll
    for (int j = 0; j < 4; ++j) b0[t + 32 * j] = a[j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = t + 32 * j;
      const int p = l / W;
      float o = 0.f;
#pragma unroll
      for (int d = 0; d < L; ++d) {
        const float m = (((p - d) & (L - 1)) == p) ? 1.f : 0.f;
        o = o + m * b0[(l - d * W) & (kLanes - 1)];
      }
      a[j] = o * 0.5f;
    }
    __syncwarp();
  } else {  // kRank
    float c0[4], c1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c0[j] = a[j];
      c1[j] = a[j] * 1.0001f;
      b0[t + 32 * j] = c0[j];
      b1[t + 32 * j] = c1[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = t + 32 * j;
      const int p = l / W;
      const float pf = static_cast<float>(p);
      int rank0 = 0, rank1 = 0;
#pragma unroll
      for (int d = 0; d < L; ++d) {
        const bool silt = static_cast<float>((p - d) & (L - 1)) < pf;
        const int src_lane = (l - d * W) & (kLanes - 1);
        const float r0 = b0[src_lane], r1 = b1[src_lane];
        rank0 += int((r0 < c0[j]) | ((r0 == c0[j]) & silt)) + int(r1 < c0[j]);
        rank1 += int((r0 < c1[j]) | (r0 == c1[j])) +
                 int((r1 < c1[j]) | ((r1 == c1[j]) & silt));
      }
      a[j] = fmaf(static_cast<float>(rank1), 1e-6f,
                  fmaf(c0[j], 0.9999f, static_cast<float>(rank0) * 1e-6f));
    }
    __syncwarp();
  }
}

template <int kPattern, int L>
__global__ void __launch_bounds__(kWarps * 32)
microbench_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int rows, int iters) {
  __shared__ float buf[kWarps][2][kLanes];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const size_t tile = static_cast<size_t>(blockIdx.x) * rows * 8 * kLanes;
  if constexpr (kPattern == kChk) {
    chk_tile(x + tile, out + tile, rows, iters, warp, t);
  } else {
    for (int u = warp; u < rows * 8; u += kWarps) {
      const size_t line = tile + static_cast<size_t>(u) * kLanes;
      float a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = x[line + t + 32 * j];
      for (int it = 0; it < iters; ++it) {
        line_step<kPattern, L>(a, buf[warp][0], buf[warp][1], t);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) out[line + t + 32 * j] = a[j];
    }
  }
}

template <int kPattern, int L>
cudaError_t launch(const float* x, float* out, int rows, int copies,
                   int iters, cudaStream_t stream) {
  microbench_kernel<kPattern, L>
      <<<copies, kWarps * 32, 0, stream>>>(x, out, rows, iters);
  return cudaGetLastError();
}

}  // namespace

// x, out: [copies, rows, 8, 128] f32 device pointers; pattern 0 gather
// (also gather_rows), 1 lut, 2 rank, 3 chk; L in {8, 32} for gather and
// rank; rows >= 1, even for chk; iters >= 0.  Launches on `stream` without
// synchronising; returns the cudaError_t code.
extern "C" int microbench_rolls_launch(const float* x, float* out,
                                       int pattern, int L, int rows,
                                       int copies, int iters,
                                       cudaStream_t stream) {
  if (rows <= 0 || copies <= 0 || iters < 0 ||
      (pattern == kChk && rows % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  switch (pattern) {
    case kGather:
      if (L == 8) err = launch<kGather, 8>(x, out, rows, copies, iters, stream);
      if (L == 32) err = launch<kGather, 32>(x, out, rows, copies, iters, stream);
      break;
    case kRank:
      if (L == 8) err = launch<kRank, 8>(x, out, rows, copies, iters, stream);
      if (L == 32) err = launch<kRank, 32>(x, out, rows, copies, iters, stream);
      break;
    case kLut:
      err = launch<kLut, 8>(x, out, rows, copies, iters, stream);
      break;
    case kChk:
      err = launch<kChk, 8>(x, out, rows, copies, iters, stream);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

extern "C" const char* microbench_rolls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
