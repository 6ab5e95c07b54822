// Whole-decode flooding belief propagation for polar codes on Hopper (sm_90a).
//
// Replaces the TPU kernel bp_decode_pallas
// (polardecoding_tpu/ops/pallas/bp_kernel.py:771, body _bp_kernel :90,
// butterfly _sweep_update :44, G-matrix re-encode _gmat_encode :161) and
// computes what polardecoding_tpu_torch/models/bp.bp_decode computes, bit for
// bit for the two min-sum flavors.
//
// Design: one thread block per frame, the live-row sweep of bp_common.cuh.
// Rows L[1..n-1] and R[1..n-1] live in dynamic shared memory (73,728 bytes
// at N = 1024, plus N bytes of check scratch when early stop is on); the
// channel row L[n] and R[n] in registers of the thread owning (v, v + N/2)
// at stage n-1, the frozen row R[0] and L[0] in those of the thread owning
// (2v, 2v + 1) at stage 0, which also takes the decision.  Device memory
// sees one read of the channel LLRs and one write of the decisions per
// frame.  kPairs butterfly pairs per thread, so N / (2 kPairs) threads.
//
// Early stop (early_stop_every > 0): every k iterations the block
// re-encodes its decision in shared memory, compares it with
// sign(L[n] + R[n]) and on agreement leaves the loop with that decision
// latched; the result is the same in every thread, so the exit is uniform.
// One frame per block makes every output independent of batch size.
//
// What bounds it on this card: instruction issue.  A frame is 2n stages
// per iteration of about N/2 butterflies, each a few shared-memory loads,
// two CHKs and two stores; the CHK's table dominates, and its compares and
// selects run on the ALU pipe at half rate.  Neither the frames resident
// on an SM nor the block barriers moved the time (scripts/torch_bp_parts.py
// measures each part).  The design takes the table on the FP32 pipe as an
// exact FMA chain and skips it where a converged frame makes it 0 - 0
// (bp_common.cuh), keeps only the live rows in shared memory (3 frames
// per SM at N = 1024, against 2 with the whole lattice), and takes 8 block
// barriers per iteration at N = 1024 instead of 20 (stages 0..5 stay
// inside a warp), none at N <= 64.

#include "bp_common.cuh"

namespace {

using bp::kPairs;
constexpr int kMaxThreads = 512 / kPairs;

// NC > 0 compiles the kernel for n = NC (the main path's N = 1024: shifts,
// masks and loop bounds become constants); NC = 0 takes n at run time.
template <int F, int NC>
__global__ void __launch_bounds__(kMaxThreads, 3)
bp_decode_kernel(const float* __restrict__ ch, const float* __restrict__ fr,
                 int8_t* __restrict__ out, int n_arg, int iters, int es_every) {
  extern __shared__ float smem[];
  const int n = NC > 0 ? NC : n_arg;
  const int N = 1 << n;
  const int half = N >> 1;
  const int T = N / (2 * kPairs);
  float* L = smem;                     // L[1..n-1]
  float* R = smem + (n - 1) * N;       // R[1..n-1]
  uint8_t* x = reinterpret_cast<uint8_t*>(R + (n - 1) * N);  // [N]
  const int t = threadIdx.x;
  const unsigned wm = bp::lane_mask(T);
  const int hs = bp::home_step(N);
  const size_t row = static_cast<size_t>(blockIdx.x) * N;

  // R[1..n-1] are written before they are read; L[1..n-1] start at 0
  bp::Ends e;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int v = t + k * T;
    const int h = bp::home(v, N);
    for (int s = 0; s < n - 1; ++s) {
      L[s * N + h] = 0.f;
      L[s * N + h + hs] = 0.f;
    }
    for (int j = 0; j < 2; ++j) {
      e.ln[k][j] = ch[row + v + j * half];
      e.rn[k][j] = 0.f;
      e.r0[k][j] = fr[2 * v + j];
      e.l0[k][j] = 0.f;
    }
  }

  for (int it = 0; it < iters; ++it) {
    bp::live_iteration<F>(L, R, e, n, N, t, wm);
    // uniform across the block
    if (es_every > 0 && (it + 1) % es_every == 0 &&
        bp::live_gmat_ok(e, x, n, N, t, wm)) {
      break;
    }
  }

#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int v = t + k * T;
    for (int j = 0; j < 2; ++j) {
      out[row + 2 * v + j] = bp::decide(e.l0[k][j], e.r0[k][j]);
    }
  }
}

using Kernel = void (*)(const float*, const float*, int8_t*, int, int, int);

constexpr int kMainN = 10;  // log2 of the main path's N

template <int F>
Kernel kernel_of(int n) {
  return n == kMainN ? bp_decode_kernel<F, kMainN> : bp_decode_kernel<F, 0>;
}

Kernel kernel_for(int flavor, int n) {
  switch (flavor) {
    case bp::kMinsumLut:
      return kernel_of<bp::kMinsumLut>(n);
    case bp::kMinsumLutFast:
      return kernel_of<bp::kMinsumLutFast>(n);
    case bp::kSpa:
      return kernel_of<bp::kSpa>(n);
    default:
      return nullptr;
  }
}

// The kernel of `flavor` with its shared memory at (n, es_every) allowed.
cudaError_t prepare(int flavor, int n, int es_every, Kernel* kernel,
                    size_t* smem) {
  *kernel = kernel_for(flavor, n);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  *smem = bp::live_bytes(n, es_every > 0);
  return cudaFuncSetAttribute(*kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// The launch shape at (N, flavor, es_every): threads per block (one block
// per frame), shared memory per block, blocks resident per SM, and the
// kernel's registers per thread and local memory per thread (spills).
extern "C" int bp_decode_shape(int N, int flavor, int es_every, int* threads,
                               size_t* smem, int* blocks_per_sm, int* regs,
                               size_t* local_bytes) {
  const int n = bp::log2_of(N);
  if (n < 0 || es_every < 0) return static_cast<int>(cudaErrorInvalidValue);
  Kernel kernel;
  cudaError_t err = prepare(flavor, n, es_every, &kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = N / (2 * kPairs);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = attr.localSizeBytes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, *threads, *smem));
}

extern "C" int bp_decode_launch(const float* ch, const float* fr, int8_t* out,
                                int B, int N, int iters, int flavor,
                                int es_every, cudaStream_t stream) {
  const int n = bp::log2_of(N);
  if (B <= 0 || n < 0 || iters < 0 || es_every < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Kernel kernel;
  size_t smem;
  const cudaError_t err = prepare(flavor, n, es_every, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, N / (2 * kPairs), smem, stream>>>(ch, fr, out, n, iters,
                                                es_every);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bp_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
