// The in-kernel Monte-Carlo BP wave on Hopper (sm_90a): refill generation,
// head merge, K iterations with cadenced G-matrix retirement and in-place
// refills, and per-slot error counting, in one kernel.
//
// Replaces the TPU kernel bp_wave_mc_pallas
// (polardecoding_tpu/ops/pallas/bp_kernel.py:640, body _bp_wave_mc_kernel
// :375) and computes what polardecoding_tpu_torch/models/bp.bp_wave_mc_plain
// computes, bit for bit for the two min-sum flavors: state, meta and stats.
//
// Design: one block per slot, the live-row sweep of bp_common.cuh: rows
// L[1..n-1] and R[1..n-1] of the slot's lattice in shared memory (73,728
// bytes at N = 1024, plus the check's N bytes), L[n] and R[n] in registers
// of the thread owning (v, v + N/2) at stage n-1, R[0] and L[0] in those of
// the thread owning (2v, 2v + 1) at stage 0.  The slot is loaded from and
// written back to the stage-major state [2(n+1), B, N] in place by
// bp::load_slot and bp::store_slot, shared with bp_wave.cu: the planes that
// an iteration writes before it reads them (R[1..n-1], L[0], R[n]) are read
// only when iters = 0, R[0] is never written and L[n] only where the slot
// restarted (a head merge or a refill).  The TPU kernel's MXU work
// becomes plain code: its one-hot table matmuls are row reads of u_table /
// x_table at the generation's PN offset m, and its lane reductions are
// block ANDs and counts.  Generation g of a wave has offset m + (g+1) * delta (mod 63)
// and noise words threefry2x32 under the run key at counter (step * spares
// + g, slot * N + lane), or bits[g, slot, lane]; since the words are
// counter-based, a generation's LLRs are computed when the slot consumes
// it (at the head merge, or at a retirement while a generation is left)
// rather than held as spares x N floats.  Each thread counts the errors of
// its positions (2v, 2v + 1), where it takes the decisions, reading their
// true u from meta or the table row when a frame retires; the per-slot
// scalars (m, iterations done, pending, generation pointer) are the same
// in every thread, and every branch on them is uniform.  A refill
// rewrites the shared rows at each lane's home positions, so it needs no
// block barrier.  meta stays [4, B, N] f32 with planes 0, 2 and 3
// lane-broadcast; stats are [B, 3] f32 (errbit, errblock, frames retired
// this wave), errblock counted once per retire event.  N = 1024 has an
// instance compiled with constant n.
//
// What bounds it on this card: instruction issue, as bp_decode.cu, and
// the same design: the table on the FP32 pipe and skipped where it is
// 0 - 0, 3 slots per SM at N = 1024 (the whole lattice held 2), 8 block
// barriers per iteration instead of 20 and max(0, n-6) + 1 per check
// instead of n + 2.  Its frames are younger than a fixed decode's (a slot
// refills as soon as its frame retires), so fewer of its CHKs skip the
// table.  A refill costs one row of threefry and Giles' polynomial, about
// 200 operations per position, against an iteration's 2n CHKs per pair.

#include "bp_common.cuh"
#include "noise.cuh"

namespace {

using bp::kPairs;
constexpr int kMaxThreads = 512 / kPairs;

struct McArgs {
  float* state;          // [2(n+1), B, N], in place
  float* meta;           // [4, B, N], in place
  const float* u_table;  // [128, N]
  const float* x_table;  // [128, N]
  const uint32_t* bits;  // [spares, B, N] or null (counter noise)
  float* stats;          // [B, 3]
  float sigma;
  uint32_t k0, k1, step;
  int B, n, iters, iter_max, delta, drain, spares, cadence;
};

// The LLR of codeword bit x with the noise word bits[at], or the counter
// word at (ctr, lane) when bits is null.  It runs only at a head merge or
// a refill.  The kernel compiled for n at run time calls it out of line
// (refill_llr_call): inlined, its threefry rounds and polynomial take
// registers the sweep needs, and that kernel spills; the one compiled for
// N = 1024 has them to spare and inlines it.
__device__ __forceinline__ float refill_llr(const uint32_t* bits, size_t at,
                                            uint32_t k0, uint32_t k1,
                                            uint32_t ctr, uint32_t lane,
                                            float x, float sigma) {
  const uint32_t w = bits ? bits[at] : mc::threefry_x0(k0, k1, ctr, lane);
  return mc::llr(w, x, 1.0f / sigma);
}
__device__ __noinline__ float refill_llr_call(const uint32_t* bits, size_t at,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t ctr, uint32_t lane,
                                              float x, float sigma) {
  return refill_llr(bits, at, k0, k1, ctr, lane, x, sigma);
}

// NC > 0 compiles the kernel for n = NC (the main path's N = 1024); NC = 0
// takes n at run time.
template <int F, int NC>
__global__ void __launch_bounds__(kMaxThreads, 3) bp_wave_mc_kernel(McArgs a) {
  extern __shared__ float smem[];
  const int n = NC > 0 ? NC : a.n;
  const int N = 1 << n;
  const int half = N >> 1;
  const int T = N / (2 * kPairs);
  float* L = smem;                  // L[1..n-1]
  float* R = smem + (n - 1) * N;    // R[1..n-1]
  uint8_t* x = reinterpret_cast<uint8_t*>(R + (n - 1) * N);
  const int t = threadIdx.x;
  const unsigned wm = bp::lane_mask(T);
  const int hs = bp::home_step(N);
  const int slot = blockIdx.x;
  const size_t plane = static_cast<size_t>(a.B) * N;
  const size_t row = static_cast<size_t>(slot) * N;
  // plane s of the slot: L[s] is plane s, R[s] plane n + 1 + s
  auto st = [&](int s) { return a.state + s * plane + row; };

  // per-slot scalars: meta planes 0, 2, 3 are lane-broadcast
  const float m_in = a.meta[row];
  const float it_in = a.meta[2 * plane + row];
  const float pend_in = a.meta[3 * plane + row];
  // every thread has read them before any writes its meta back
  bp::block_sync(T, wm);
  auto gen_m = [&](int g) {
    const float mg = m_in + static_cast<float>(((g + 1) * a.delta) % 63);
    return mg >= 63.0f ? mg - 63.0f : mg;
  };
  // the LLR of generation g (offset mg) at position p
  auto gen_llr = [&](int g, float mg, int p) {
    const size_t at = (static_cast<size_t>(g) * a.B + slot) * N + p;
    const uint32_t ctr =
        a.step * static_cast<uint32_t>(a.spares) + static_cast<uint32_t>(g);
    const uint32_t lane = static_cast<uint32_t>(row + p);
    const float x = a.x_table[static_cast<size_t>(mg) * N + p];
    if (NC > 0) return refill_llr(a.bits, at, a.k0, a.k1, ctr, lane, x, a.sigma);
    return refill_llr_call(a.bits, at, a.k0, a.k1, ctr, lane, x, a.sigma);
  };

  // head merge: a pending slot starts generation 0's frame (every plane 0
  // but L[n], its LLRs, and R[0])
  const bool rm = !a.drain && pend_in > 0.5f;
  const float m0 = gen_m(0);
  bp::Ends e;
  bp::load_slot(L, R, e, st, n, N, t, rm, a.iters == 0,
                [&](int p) { return gen_llr(0, m0, p); });
  float m_c = rm ? m0 : m_in;
  float it_c = rm ? 0.f : it_in;
  int ptr = rm ? 1 : 0;  // the next generation to consume; spares - ptr left
  float pend_c = a.drain ? pend_in : 0.f;
  // the true u of the slot's frame at position q: the meta it came in
  // with until its first refill or head merge (ptr still 0), then its
  // generation's table row (read when needed, not held in registers)
  const auto true_u = [&](int q) {
    return ptr == 0 ? a.meta[plane + row + q]
                    : a.u_table[static_cast<size_t>(m_c) * N + q];
  };
  // errbit, errblock, frames retired: the same in every thread, summed by
  // thread 0 in shared memory
  __shared__ float sums[3];
  if (t == 0) sums[0] = sums[1] = sums[2] = 0.f;

  for (int it = 0; it < a.iters; ++it) {
    bp::live_iteration<F>(L, R, e, n, N, t, wm);
    // iterations done: the plain version adds (iterations since the last
    // check) * alive at each check; alive changes only after the last
    // check, and sums of these small integers are exact, so adding it at
    // every iteration gives the same float
    const float alive = 1.f - pend_c;
    it_c = it_c + alive;
    const bool last = it == a.iters - 1;
    if ((it + 1) % a.cadence != 0 && !last) continue;
    const bool ok = bp::live_gmat_ok(e, x, n, N, t, wm);
    const bool done = alive > 0.5f && (ok || it_c >= static_cast<float>(a.iter_max));
    const bool has = !a.drain && ptr < a.spares;
    const bool retire_now = done && has;
    if (retire_now || (last && done)) {
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        for (int j = 0; j < 2; ++j) {
          const float u = bp::decide(e.l0[k][j], e.r0[k][j]);
          cnt += bp::block_count(u != true_u(2 * (t + k * T) + j), T, wm);
        }
      }
      if (t == 0) {
        sums[0] += static_cast<float>(cnt);
        sums[1] += cnt > 0 ? 1.f : 0.f;
        sums[2] += 1.f;
      }
    }
    if (retire_now) {  // restart the slot on its next generation, in place
      const float mg = gen_m(ptr);
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int v = t + k * T;
        const int h = bp::home(v, N);
        for (int s = 0; s < n - 1; ++s) {
          L[s * N + h] = 0.f;
          L[s * N + h + hs] = 0.f;
          R[s * N + h] = 0.f;
          R[s * N + h + hs] = 0.f;
        }
        for (int j = 0; j < 2; ++j) {
          e.ln[k][j] = gen_llr(ptr, mg, v + j * half);
          e.rn[k][j] = 0.f;
          e.l0[k][j] = 0.f;  // R[0], the frozen row, stays
        }
      }
      m_c = mg;
      it_c = 0.f;
      ++ptr;
    }
    if (last && done && !has) pend_c = 1.f;
  }

#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    for (int j = 0; j < 2; ++j) {
      const int q = 2 * (t + k * T) + j;
      a.meta[row + q] = m_c;
      a.meta[plane + row + q] = true_u(q);
      a.meta[2 * plane + row + q] = it_c;
      a.meta[3 * plane + row + q] = pend_c;
    }
  }
  // L[n] changed where the slot restarted (a head merge or a refill); the
  // meta first, or the kernel for n at run time spills
  bp::store_slot(L, R, e, st, n, N, t, wm, ptr > 0);
  if (t == 0) {
    a.stats[3 * static_cast<size_t>(slot)] = sums[0];
    a.stats[3 * static_cast<size_t>(slot) + 1] = sums[1];
    a.stats[3 * static_cast<size_t>(slot) + 2] = sums[2];
  }
}

using Kernel = void (*)(McArgs);

constexpr int kMainN = 10;  // log2 of the main path's N

template <int F>
Kernel kernel_of(int n) {
  return n == kMainN ? bp_wave_mc_kernel<F, kMainN> : bp_wave_mc_kernel<F, 0>;
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

// The kernel of `flavor` with its shared memory at n allowed.
cudaError_t prepare(int flavor, int n, Kernel* kernel, size_t* smem) {
  *kernel = kernel_for(flavor, n);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  *smem = bp::live_bytes(n, true);
  return cudaFuncSetAttribute(*kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// The launch shape at (N, flavor): threads per block (one block per slot),
// shared memory per block, blocks resident per SM, and the kernel's
// registers per thread and local memory per thread (spills).
extern "C" int bp_wave_mc_shape(int N, int flavor, int* threads, size_t* smem,
                                int* blocks_per_sm, int* regs,
                                size_t* local_bytes) {
  const int n = bp::log2_of(N);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Kernel kernel;
  cudaError_t err = prepare(flavor, n, &kernel, smem);
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

// See McArgs for the layouts; sigma > 0; seeds (k0, k1) and the step
// counter feed the counter noise when bits is null.  N a power of two in
// [8, 1024], spares >= 1, cadence >= 1.  Launches on `stream` without
// synchronising; returns the cudaError_t code.
extern "C" int bp_wave_mc_launch(float* state, float* meta,
                                 const float* u_table, const float* x_table,
                                 const uint32_t* bits, float* stats,
                                 float sigma, uint32_t k0, uint32_t k1,
                                 uint32_t step, int B, int N, int iters,
                                 int flavor, int iter_max, int delta,
                                 int drain, int spares, int cadence,
                                 cudaStream_t stream) {
  const int n = bp::log2_of(N);
  if (B <= 0 || n < 0 || iters < 0 || spares < 1 || cadence < 1 ||
      delta < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const McArgs a{state, meta, u_table, x_table, bits, stats, sigma,
                 k0,    k1,   step,    B,       n,    iters, iter_max,
                 delta, drain, spares, cadence};
  Kernel kernel;
  size_t smem;
  const cudaError_t err = prepare(flavor, n, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, N / (2 * kPairs), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bp_wave_mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
