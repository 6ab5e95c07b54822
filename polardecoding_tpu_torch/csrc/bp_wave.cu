// Wave steps of the continuous-batching BP engine on Hopper (sm_90a):
// persistent message state advanced K iterations at a time.
//
// Replaces two TPU kernels of polardecoding_tpu/ops/pallas/bp_kernel.py:
//   - bp_wave_pallas (:726, body _bp_wave_kernel :175): K plain iterations
//     on the state (FUSED = false);
//   - bp_wave_fused_pallas (:306, body _bp_wave_fused_kernel :206): merge of
//     the slots retired last wave from fresh LLRs, K iterations, then the
//     G-matrix decide, optionally checked every check_every iterations with
//     a per-frame latch (FUSED = true).
// It computes what polardecoding_tpu_torch/models/bp.bp_wave_plain and
// bp_wave_fused_plain compute, bit for bit for the two min-sum flavors.
//
// Design: one block per slot, N/2 threads, the sweep of bp_common.cuh.  The
// state is stage-major [2(n+1), B, N] in device memory (planes 0..n are L,
// n+1..2n+1 are R); a block loads its slot's 2(n+1) rows into shared memory
// (88 KB at N = 1024), runs the wave there and writes them back in place, so
// each wave moves the state through device memory once each way.  The merge
// is a select (a kept -0.0 survives): L[n] <- llr, every plane but R[0] <- 0.
// The decide re-encodes the decision in shared memory and votes with
// __syncthreads_and; the latch keeps each thread's two decisions in
// registers.  Every branch on the vote is uniform across the block.
//
// What bounds it on this card: as bp_decode.cu, barriers (2n per iteration)
// and shared-memory traffic, two blocks per SM; at K = 8 the state's trip
// through device memory (180 KB per slot and wave at N = 1024) adds about a
// tenth of the iterations' time.

#include "bp_common.cuh"

namespace {

template <int F, bool FUSED, bool CHECK>
__global__ void __launch_bounds__(512, 2)
bp_wave_kernel(float* __restrict__ state, const float* __restrict__ llr,
               const uint8_t* __restrict__ retire, int8_t* __restrict__ u_out,
               uint8_t* __restrict__ done_out, int B, int n, int iters,
               int check_every) {
  extern __shared__ float smem[];  // L = planes 0..n, R = planes n+1..2n+1
  const int N = 1 << n;
  const int half = N >> 1;
  const int S2 = 2 * (n + 1);
  float* L = smem;
  float* R = smem + (n + 1) * N;
  uint8_t* x = reinterpret_cast<uint8_t*>(smem + S2 * N);
  const int t = threadIdx.x;
  const size_t plane = static_cast<size_t>(B) * N;
  const size_t row = static_cast<size_t>(blockIdx.x) * N;

  const bool ret = FUSED && retire[blockIdx.x];
  for (int s = 0; s < S2; ++s) {
    for (int p = t; p < N; p += half) {
      float v = state[s * plane + row + p];
      if (ret && s != n + 1) v = (s == n) ? llr[row + p] : 0.f;
      smem[s * N + p] = v;
    }
  }
  __syncthreads();

  bool done = false;
  uint8_t u_lat[2] = {0, 0};  // this thread's positions t and t + N/2
  for (int it = 0; it < iters; ++it) {
    bp::iteration<F>(L, R, n, N, t);
    if (CHECK && !done && ((it + 1) % check_every == 0 || it + 1 == iters) &&
        bp::gmat_ok(L, R, x, n, N, t)) {
      done = true;
      for (int k = 0; k < 2; ++k) u_lat[k] = bp::decision(L, R, t + k * half);
    }
  }

  for (int s = 0; s < S2; ++s) {
    for (int p = t; p < N; p += half) state[s * plane + row + p] = smem[s * N + p];
  }
  if (!FUSED) return;
  if (!CHECK) done = bp::gmat_ok(L, R, x, n, N, t);
  for (int k = 0; k < 2; ++k) {
    const int p = t + k * half;
    u_out[row + p] = (CHECK && done) ? u_lat[k] : bp::decision(L, R, p);
  }
  if (t == 0) done_out[blockIdx.x] = done ? 1 : 0;
}

template <int F, bool FUSED, bool CHECK>
cudaError_t launch(float* state, const float* llr, const uint8_t* retire,
                   int8_t* u, uint8_t* done, int B, int n, int iters,
                   int check_every, cudaStream_t stream) {
  const size_t smem = bp::lattice_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      bp_wave_kernel<F, FUSED, CHECK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bp_wave_kernel<F, FUSED, CHECK><<<B, (1 << n) / 2, smem, stream>>>(
      state, llr, retire, u, done, B, n, iters, check_every);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_mode(float* state, const float* llr, const uint8_t* retire,
                        int8_t* u, uint8_t* done, int B, int n, int iters,
                        int fused, int check_every, cudaStream_t stream) {
  if (!fused) {
    return launch<F, false, false>(state, llr, retire, u, done, B, n, iters,
                                   0, stream);
  }
  if (check_every > 0) {
    return launch<F, true, true>(state, llr, retire, u, done, B, n, iters,
                                 check_every, stream);
  }
  return launch<F, true, false>(state, llr, retire, u, done, B, n, iters, 0,
                                stream);
}

}  // namespace

// state: [2(n+1), B, N] f32, updated in place.  fused = 0: llr, retire, u
// and done are unused (may be null).  fused = 1: llr [B, N] f32 (read for
// the retired slots only), retire [B] bool, u [B, N] int8 and done [B] bool
// written.  N a power of two in [8, 1024].  Launches on `stream` without
// synchronising; returns the cudaError_t code.
extern "C" int bp_wave_launch(float* state, const float* llr,
                              const uint8_t* retire, int8_t* u, uint8_t* done,
                              int B, int N, int iters, int flavor, int fused,
                              int check_every, cudaStream_t stream) {
  const int n = bp::log2_of(N);
  if (B <= 0 || n < 0 || iters < 0 || check_every < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (flavor) {
    case bp::kMinsumLut:
      return launch_mode<bp::kMinsumLut>(state, llr, retire, u, done, B, n,
                                         iters, fused, check_every, stream);
    case bp::kMinsumLutFast:
      return launch_mode<bp::kMinsumLutFast>(state, llr, retire, u, done, B, n,
                                             iters, fused, check_every, stream);
    case bp::kSpa:
      return launch_mode<bp::kSpa>(state, llr, retire, u, done, B, n, iters,
                                   fused, check_every, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bp_wave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
