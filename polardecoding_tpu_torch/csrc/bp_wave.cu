// Wave steps of the continuous-batching BP engine on Hopper (sm_90a):
// persistent message state advanced K iterations at a time.
//
// Replaces two TPU kernels of polardecoding_tpu/ops/pallas/bp_kernel.py:
//   - bp_wave_pallas (:726, body _bp_wave_kernel :175): K plain iterations
//     on the state (FUSED = false);
//   - bp_wave_fused_pallas (:306, body _bp_wave_fused_kernel :206): merge of
//     the slots retired last wave from fresh LLRs, K iterations, then the
//     G-matrix decide, optionally checked every check_every iterations with
//     a per-frame latch (FUSED = true, CHECK = check_every > 0).
// It computes what polardecoding_tpu_torch/models/bp.bp_wave_plain and
// bp_wave_fused_plain compute, bit for bit for the two min-sum flavors:
// the whole state, u_hat and done.
//
// Design: one block per slot, the live-row sweep of bp_common.cuh, as
// bp_wave_mc.cu: rows L[1..n-1] and R[1..n-1] of the slot's lattice in
// shared memory (73,728 bytes at N = 1024, plus the check's N bytes in the
// fused kernel: 3 slots per SM), L[n] and R[n] in registers of the thread
// owning (v, v + N/2) at stage n-1, R[0] and L[0] in those of the thread
// owning (2v, 2v + 1) at stage 0; N / 4 threads of two pairs each.  The
// state is stage-major [2(n+1), B, N] in device memory (planes 0..n are L,
// n+1..2n+1 are R) and is updated in place.  With iters >= 1 an iteration
// reads only L[1..n] and R[0] and writes L[0..n-1] and R[1..n] before it
// reads them, so a kept slot moves n+1 planes in and 2n out; R[0] is never
// written, L[n] only where the merge replaced it.  With iters = 0 the
// unfused kernel changes nothing and returns at once; the fused one reads
// the other planes too, since its decide reads L[0] and R[n].  The merge
// is a select (a kept -0.0 survives): a retired slot reads only R[0] of
// the state, takes L[n] from llr and 0 for every other plane.  The decide
// takes each thread's decisions at (2v, 2v + 1), re-encodes them in the
// check's scratch and votes (bp::live_gmat_ok); the latch writes u_hat at
// a frame's first passing check.  The load with the merge and the
// write-back are bp::load_slot and bp::store_slot, shared with
// bp_wave_mc.cu: they touch the shared rows at each lane's home positions,
// so no block barrier stands around them.  Every branch on the vote or the
// slot's flags is uniform across the block.
// The fused kernel may be given a live mask: a slot that is neither live
// nor retired is held (the drain's slots whose frames are already counted,
// harness.make_wave_step): its block writes done = 0 and a zero u_hat row
// and returns before load_slot, so its planes are neither read nor written
// and it runs no iteration.  Without a mask every slot runs.
// N = 1024 has an instance compiled with constant n.
//
// What bounds it on this card: instruction issue in the sweep, as
// bp_decode.cu (the CHK's table on the FP32 pipe and skipped where it is
// 0 - 0; 8 block barriers per iteration at N = 1024, none at N <= 64); at
// K = 8 the state's trip through device memory, 31 planes of 4 KB per
// kept slot at N = 1024, adds a few tenths of a millisecond.

#include "bp_common.cuh"

namespace {

using bp::kPairs;
constexpr int kMaxThreads = 512 / kPairs;

struct WaveArgs {
  float* state;           // [2(n+1), B, N], in place
  const float* llr;       // [B, N], read for the retired slots (fused)
  const uint8_t* retire;  // [B] (fused)
  const uint8_t* live;    // [B] or null: every slot live (fused)
  int8_t* u;              // [B, N] (fused)
  uint8_t* done;          // [B] (fused)
  int B, n, iters, check_every;
};

// NC > 0 compiles the kernel for n = NC (the main path's N = 1024); NC = 0
// takes n at run time.
template <int F, bool FUSED, bool CHECK, int NC>
__global__ void __launch_bounds__(kMaxThreads, 3) bp_wave_kernel(WaveArgs a) {
  extern __shared__ float smem[];
  const int n = NC > 0 ? NC : a.n;
  const int N = 1 << n;
  const int T = N / (2 * kPairs);
  float* L = smem;                // L[1..n-1]
  float* R = smem + (n - 1) * N;  // R[1..n-1]
  uint8_t* x = reinterpret_cast<uint8_t*>(R + (n - 1) * N);  // fused: [N]
  const int t = threadIdx.x;
  const unsigned wm = bp::lane_mask(T);
  const int slot = blockIdx.x;
  const size_t plane = static_cast<size_t>(a.B) * N;
  const size_t row = static_cast<size_t>(slot) * N;
  // plane s of the slot: L[s] is plane s, R[s] plane n + 1 + s
  auto st = [&](int s) { return a.state + s * plane + row; };
  if (!FUSED && a.iters == 0) return;
  // a held slot: done and u_hat 0, its state untouched
  if (FUSED && a.live != nullptr && !a.live[slot] && !a.retire[slot]) {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int q = 2 * (t + k * T);
      a.u[row + q] = 0;
      a.u[row + q + 1] = 0;
    }
    if (t == 0) a.done[slot] = 0;
    return;
  }

  // the merge: a retired slot restarts from its LLRs (every plane 0 but
  // L[n], and R[0])
  const bool ret = FUSED && a.retire[slot];
  bp::Ends e;
  bp::load_slot(L, R, e, st, n, N, t, ret, a.iters == 0,
                [&](int p) { return a.llr[row + p]; });

  // CHECK: a frame's u_hat is written at its first passing check (the
  // latch), else from the decisions after the last iteration
  const auto store_u = [&] {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int q = 2 * (t + k * T);
      for (int j = 0; j < 2; ++j) {
        a.u[row + q + j] = bp::decide(e.l0[k][j], e.r0[k][j]);
      }
    }
  };
  bool done = false;
  for (int it = 0; it < a.iters; ++it) {
    bp::live_iteration<F>(L, R, e, n, N, t, wm);
    if (CHECK && !done &&
        ((it + 1) % a.check_every == 0 || it + 1 == a.iters) &&
        bp::live_gmat_ok(e, x, n, N, t, wm)) {
      done = true;
      store_u();
    }
  }
  if (FUSED && !CHECK) done = bp::live_gmat_ok(e, x, n, N, t, wm);
  if (FUSED && !(CHECK && done)) store_u();

  bp::store_slot(L, R, e, st, n, N, t, wm, ret);
  if (FUSED && t == 0) a.done[slot] = done ? 1 : 0;
}

using Kernel = void (*)(WaveArgs);

constexpr int kMainN = 10;  // log2 of the main path's N

template <int F, bool FUSED, bool CHECK>
Kernel instance(int n) {
  return n == kMainN ? bp_wave_kernel<F, FUSED, CHECK, kMainN>
                     : bp_wave_kernel<F, FUSED, CHECK, 0>;
}

template <int F>
Kernel kernel_of(int n, int fused, int check_every) {
  if (!fused) return instance<F, false, false>(n);
  return check_every > 0 ? instance<F, true, true>(n)
                         : instance<F, true, false>(n);
}

Kernel kernel_for(int flavor, int n, int fused, int check_every) {
  switch (flavor) {
    case bp::kMinsumLut:
      return kernel_of<bp::kMinsumLut>(n, fused, check_every);
    case bp::kMinsumLutFast:
      return kernel_of<bp::kMinsumLutFast>(n, fused, check_every);
    case bp::kSpa:
      return kernel_of<bp::kSpa>(n, fused, check_every);
    default:
      return nullptr;
  }
}

// The kernel of (flavor, fused, check_every) with its shared memory at n
// allowed; the fused kernel's decide takes the check's N bytes.
cudaError_t prepare(int flavor, int n, int fused, int check_every,
                    Kernel* kernel, size_t* smem) {
  *kernel = kernel_for(flavor, n, fused, check_every);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  *smem = bp::live_bytes(n, fused != 0);
  return cudaFuncSetAttribute(*kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// The launch shape at (N, flavor, fused, check_every): threads per block
// (one block per slot), shared memory per block, blocks resident per SM,
// and the kernel's registers per thread and local memory per thread
// (spills).
extern "C" int bp_wave_shape(int N, int flavor, int fused, int check_every,
                             int* threads, size_t* smem, int* blocks_per_sm,
                             int* regs, size_t* local_bytes) {
  const int n = bp::log2_of(N);
  if (n < 0 || check_every < 0) return static_cast<int>(cudaErrorInvalidValue);
  Kernel kernel;
  cudaError_t err = prepare(flavor, n, fused, check_every, &kernel, smem);
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

// state: [2(n+1), B, N] f32, updated in place.  fused = 0: llr, retire,
// live, u and done are unused (may be null).  fused = 1: llr [B, N] f32
// (read for the retired slots only), retire [B] bool, live [B] bool or null
// (a slot neither live nor retired is held), u [B, N] int8 and done [B]
// bool written.  N a power of two in [8, 1024].  Launches on `stream`
// without synchronising; returns the cudaError_t code.
extern "C" int bp_wave_launch(float* state, const float* llr,
                              const uint8_t* retire, const uint8_t* live,
                              int8_t* u, uint8_t* done,
                              int B, int N, int iters, int flavor, int fused,
                              int check_every, cudaStream_t stream) {
  const int n = bp::log2_of(N);
  if (B <= 0 || n < 0 || iters < 0 || check_every < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WaveArgs a{state, llr, retire, live, u, done, B, n, iters,
                   check_every};
  Kernel kernel;
  size_t smem;
  const cudaError_t err = prepare(flavor, n, fused, check_every, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, N / (2 * kPairs), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bp_wave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
