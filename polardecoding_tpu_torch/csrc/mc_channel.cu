// The MC channel on Hopper (sm_90a): PN offsets -> channel LLRs.
//
// Replaces the TPU kernel mc_channel_pallas
// (polardecoding_tpu/ops/pallas/channel_kernel.py:75, body
// _mc_channel_kernel :36) and computes what
// polardecoding_tpu_torch/ops/channel_kernel.mc_channel_plain computes, bit
// for bit.
//
// Per element (b, lane): the codeword bit is a row read x_table[m[b], lane]
// (the TPU kernel's one-hot matmul), the noise word is threefry2x32 under
// the point key at counter (step, (row0 + b) * N + lane), with row0 the
// first row's index in a global batch (a rank's slice; 0 for a whole
// batch), or bits[b, lane] when
// given, and the LLR is noise.cuh's.  What bounds it on this card: integer
// issue, threefry's 20 rounds of an add, a funnel-shift rotate and a xor
// (about 70 integer operations an element) against 4 bytes written; the
// table (at most 512 KB) stays in L2.  The design keeps every other integer
// operation out of the element: a block takes a tile of consecutive
// elements (noise.cuh's Tile), whose frames and lanes are shifts of the
// block and thread index, not a 64-bit division by a run-time N; the first
// key injection (step + k0) and the key schedule are the same for every
// element, uniform values the compiler keeps out of the per-thread work;
// N = 1024 has an instance compiled with constant n, where a tile lies in
// one frame and every address is a register plus an immediate.  One
// element a thread: 2, 4 or 8 a thread took longer on the H100
// (scripts/torch_channel_parts.py; PERF.md §6).

#include "noise.cuh"

namespace {

constexpr int kMainN = 10;  // log2 of the main path's N
constexpr int kElemsLog = 0;  // one element a thread
using Tile = mc::Tile<kElemsLog>;

// NC > 0 compiles the kernel for n = NC; NC = 0 takes n at run time.
template <int NC>
__global__ void __launch_bounds__(mc::kThreads)
mc_channel_kernel(const int* __restrict__ m, const float* __restrict__ x_table,
                  const uint32_t* __restrict__ bits, float* __restrict__ out,
                  float sigma, uint32_t k0, uint32_t k1, uint32_t step,
                  uint32_t row0, int B, int n_arg) {
  const int n = NC > 0 ? NC : n_arg;
  const Tile tile(n, B);
  const float inv_s = __fdiv_rn(1.0f, sigma);
  // the counter of this launch's first element, (row0 * N) mod 2^32: the
  // same for every thread
  const uint32_t first = row0 << n;
#pragma unroll
  for (int k = 0; k < Tile::kElems; ++k) {
    const int i = k * mc::kThreads + static_cast<int>(threadIdx.x);
    const int f = tile.frame(i);
    if (f >= tile.frames) break;
    const long long b = tile.b0 + f;
    const int lane = tile.lane(i);
    const size_t e = (static_cast<size_t>(b) << n) + lane;
    const float x = x_table[(static_cast<size_t>(m[b]) << n) + lane];
    // the counter's low word is ((row0 + b) * N + lane) mod 2^32
    const uint32_t w = bits ? bits[e]
                            : mc::threefry_x0(k0, k1, step,
                                              first + static_cast<uint32_t>(e));
    out[e] = mc::llr(w, x, inv_s);
  }
}

using Kernel = void (*)(const int*, const float*, const uint32_t*, float*,
                        float, uint32_t, uint32_t, uint32_t, uint32_t, int,
                        int);

Kernel kernel_for(int n) {
  return n == kMainN ? mc_channel_kernel<kMainN> : mc_channel_kernel<0>;
}

}  // namespace

// m: [B] int32 offsets in 0..127, x_table: [128, N] f32 with N = 2^n, bits:
// [B, N] 32-bit words or null (counter noise under (k0, k1) at (step,
// (row0 + b) * N + lane)), out: [B, N] f32.  Launches on `stream` without
// synchronising; returns the cudaError_t code.
extern "C" int mc_channel_launch(const int* m, const float* x_table,
                                 const uint32_t* bits, float* out, float sigma,
                                 uint32_t k0, uint32_t k1, uint32_t step,
                                 uint32_t row0, int B, int n,
                                 cudaStream_t stream) {
  if (B <= 0 || n < 0 || n > 30) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = Tile::blocks(B, n);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  kernel_for(n)<<<static_cast<unsigned>(blocks), mc::kThreads, 0, stream>>>(
      m, x_table, bits, out, sigma, k0, k1, step, row0, B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mc_channel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
