// The MC channel on Hopper (sm_90a): PN offsets -> channel LLRs.
//
// Replaces the TPU kernel mc_channel_pallas
// (polardecoding_tpu/ops/pallas/channel_kernel.py:75, body
// _mc_channel_kernel :36) and computes what
// polardecoding_tpu_torch/ops/channel_kernel.mc_channel_plain computes, bit
// for bit.
//
// Design: one thread per element (b, lane): the codeword bit is a row read
// x_table[m[b], lane] (the TPU kernel's one-hot matmul), the noise word is
// threefry2x32 under the point key at counter (step, b * N + lane), or
// bits[b, lane] when given, and the LLR is noise.cuh's.  What bounds it on
// this card: the arithmetic, about 200 integer and float operations per
// element (threefry's 20 rounds, XLA's log and Giles' polynomial), against 4
// bytes written; the table (at most 512 KB) stays in L2.

#include "noise.cuh"

namespace {

__global__ void __launch_bounds__(256)
mc_channel_kernel(const int* __restrict__ m, const float* __restrict__ x_table,
                  const uint32_t* __restrict__ bits, float* __restrict__ out,
                  float sigma, uint32_t k0, uint32_t k1, uint32_t step, int B,
                  int N) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * N) return;
  const size_t b = idx / N;
  const int lane = static_cast<int>(idx - b * N);
  const float x = x_table[static_cast<size_t>(m[b]) * N + lane];
  const uint32_t w = bits ? bits[idx]
                          : mc::threefry_x0(k0, k1, step,
                                            static_cast<uint32_t>(idx));
  out[idx] = mc::llr(w, x, 1.0f / sigma);
}

}  // namespace

// m: [B] int32 offsets in 0..127, x_table: [128, N] f32, bits: [B, N] 32-bit
// words or null (counter noise under (k0, k1) at (step, b * N + lane)),
// out: [B, N] f32.  Launches on `stream` without synchronising; returns the
// cudaError_t code.
extern "C" int mc_channel_launch(const int* m, const float* x_table,
                                 const uint32_t* bits, float* out, float sigma,
                                 uint32_t k0, uint32_t k1, uint32_t step,
                                 int B, int N, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(B) * N;
  const int threads = 256;
  const size_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFu) return static_cast<int>(cudaErrorInvalidValue);
  mc_channel_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      m, x_table, bits, out, sigma, k0, k1, step, B, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mc_channel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
