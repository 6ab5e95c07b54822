// Whole-decode flooding belief propagation for polar codes on Hopper (sm_90a).
//
// Replaces the TPU kernel bp_decode_pallas
// (polardecoding_tpu/ops/pallas/bp_kernel.py:771, body _bp_kernel :90,
// butterfly _sweep_update :44, G-matrix re-encode _gmat_encode :161) and
// computes what polardecoding_tpu_torch/models/bp.bp_decode computes, bit for
// bit for the two min-sum flavors.
//
// Design: one thread block per frame, N/2 threads, thread t owning the stage-i
// butterfly pair (u, u + 2^i) with u = ((t >> i) << (i + 1)) | (t & (2^i - 1)).
// The whole (n+1) x N lattice of left (L) and right (R) messages lives in
// dynamic shared memory (2 * 11 * 1024 * 4 B = 88 KB at N = 1024), so device
// memory sees one read of the channel LLRs and one write of the decisions per
// frame.  L[n] is the channel LLR and R[0] the frozen row (999 or 0); an
// iteration is an R-sweep over stages 0..n-1 then an L-sweep over n-1..0, with
// __syncthreads() between stages for the reference's Gauss-Seidel order.  The
// four butterfly equations keep the plain version's operand order, and the
// library is built with -fmad=false, so no a*b+c is contracted.
//
// Early stop (early_stop_every > 0): every k iterations the block re-encodes
// its decision in shared memory (n xor stages), compares it with
// sign(L[n] + R[n]) through __syncthreads_and, and on agreement leaves the
// loop with that decision latched.  One frame per block makes every output
// independent of batch size and tiling.
//
// What bounds it on this card: shared-memory traffic (4 loads and 2 stores
// per butterfly per stage) and one block-wide barrier per stage, 2n per
// iteration (2000 per decode at N = 1024 and 100 iterations); at 88 KB a
// block, two blocks (1024 threads) fit on an SM.  A later version could hold
// several frames per block, keep stage-local values in registers across
// stages whose pairs stay within a warp (shuffles instead of barriers), and
// so take most barriers off the critical path.

#include "bp_common.cuh"

namespace {

template <int F>
__global__ void __launch_bounds__(512, 2)
bp_decode_kernel(const float* __restrict__ ch, const float* __restrict__ fr,
                 int8_t* __restrict__ out, int n, int iters, int es_every) {
  extern __shared__ float smem[];
  const int N = 1 << n;
  const int half = N >> 1;
  float* L = smem;                                         // [n+1][N]
  float* R = smem + (n + 1) * N;                           // [n+1][N]
  uint8_t* x = reinterpret_cast<uint8_t*>(R + (n + 1) * N);  // [N]
  const int t = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * N;

  for (int p = t; p < N; p += half) {
    for (int s = 0; s < n; ++s) {
      L[s * N + p] = 0.f;
      R[(s + 1) * N + p] = 0.f;
    }
    L[n * N + p] = ch[row + p];
    R[p] = fr[p];
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    bp::iteration<F>(L, R, n, N, t);
    // uniform across the block
    if (es_every > 0 && (it + 1) % es_every == 0 &&
        bp::gmat_ok(L, R, x, n, N, t)) {
      break;
    }
  }

  for (int p = t; p < N; p += half) out[row + p] = bp::decision(L, R, p);
}

template <int F>
cudaError_t launch(const float* ch, const float* fr, int8_t* out, int B, int n,
                   int iters, int es_every, cudaStream_t stream) {
  const int N = 1 << n;
  const size_t smem = bp::lattice_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      bp_decode_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bp_decode_kernel<F><<<B, N / 2, smem, stream>>>(ch, fr, out, n, iters,
                                                  es_every);
  return cudaGetLastError();
}

}  // namespace

// ch: [B, N] f32, fr: [N] f32 (999 on frozen positions, 0 elsewhere),
// out: [B, N] int8, all device pointers; N a power of two in [8, 1024].
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int bp_decode_launch(const float* ch, const float* fr, int8_t* out,
                                int B, int N, int iters, int flavor,
                                int es_every, cudaStream_t stream) {
  const int n = bp::log2_of(N);
  if (B <= 0 || n < 0 || iters < 0 || es_every < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (flavor) {
    case bp::kMinsumLut:
      return launch<bp::kMinsumLut>(ch, fr, out, B, n, iters, es_every, stream);
    case bp::kMinsumLutFast:
      return launch<bp::kMinsumLutFast>(ch, fr, out, B, n, iters, es_every, stream);
    case bp::kSpa:
      return launch<bp::kSpa>(ch, fr, out, B, n, iters, es_every, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bp_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
