// The in-kernel Monte-Carlo BP wave on Hopper (sm_90a): refill generation,
// head merge, K iterations with cadenced G-matrix retirement and in-place
// refills, and per-slot error counting, in one kernel.
//
// Replaces the TPU kernel bp_wave_mc_pallas
// (polardecoding_tpu/ops/pallas/bp_kernel.py:640, body _bp_wave_mc_kernel
// :375) and computes what polardecoding_tpu_torch/models/bp.bp_wave_mc_plain
// computes, bit for bit for the two min-sum flavors: state, meta and stats.
//
// Design: one block per slot, N/2 threads, the sweep of bp_common.cuh on
// the slot's lattice in shared memory (88 KB at N = 1024), loaded from and
// written back to the stage-major state [2(n+1), B, N] in place.  The TPU
// kernel's MXU work becomes plain code: its one-hot table matmuls are row
// reads of u_table / x_table at the generation's PN offset m, and its lane
// reductions are __syncthreads_and / __syncthreads_count.  Generation g of
// a wave has offset m + (g+1) * delta (mod 63) and noise words threefry2x32
// under the run key at counter (step * spares + g, slot * N + lane), or
// bits[g, slot, lane]; since the words are counter-based, a generation's
// LLRs are computed when the slot consumes it (at the head merge, or at a
// retirement while a generation is left) rather than held as spares x N
// floats.  Each thread keeps its two positions' true u in registers; the
// per-slot scalars (m, iterations done, pending, generation pointer) are
// the same in every thread, and every branch on them is uniform.  meta
// stays [4, B, N] f32 with planes 0, 2 and 3 lane-broadcast; stats are
// [B, 3] f32 (errbit, errblock, frames retired this wave), errblock counted
// once per retire event.
//
// What bounds it on this card: as bp_decode.cu, barriers (2n per
// iteration, n + 2 more per check) and shared-memory traffic, two blocks
// per SM; a refill costs one row of threefry and Giles' polynomial, about
// 200 operations per position, against an iteration's 2n CHKs per pair.

#include "bp_common.cuh"
#include "noise.cuh"

namespace {

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

template <int F>
__global__ void __launch_bounds__(512, 2) bp_wave_mc_kernel(McArgs a) {
  extern __shared__ float smem[];  // L = planes 0..n, R = planes n+1..2n+1
  const int n = a.n;
  const int N = 1 << n;
  const int half = N >> 1;
  const int S2 = 2 * (n + 1);
  float* L = smem;
  float* R = smem + (n + 1) * N;
  uint8_t* x = reinterpret_cast<uint8_t*>(smem + S2 * N);
  const int t = threadIdx.x;
  const int slot = blockIdx.x;
  const size_t plane = static_cast<size_t>(a.B) * N;
  const size_t row = static_cast<size_t>(slot) * N;
  const float inv_s = 1.0f / a.sigma;

  // per-slot scalars: meta planes 0, 2, 3 are lane-broadcast
  const float m_in = a.meta[row];
  const float it_in = a.meta[2 * plane + row];
  const float pend_in = a.meta[3 * plane + row];
  auto gen_m = [&](int g) {
    const float mg = m_in + static_cast<float>(((g + 1) * a.delta) % 63);
    return mg >= 63.0f ? mg - 63.0f : mg;
  };
  // the LLR of generation g (offset mg) at position p
  auto gen_llr = [&](int g, float mg, int p) {
    const uint32_t w =
        a.bits ? a.bits[(static_cast<size_t>(g) * a.B + slot) * N + p]
               : mc::threefry_x0(
                     a.k0, a.k1, a.step * static_cast<uint32_t>(a.spares) +
                                     static_cast<uint32_t>(g),
                     static_cast<uint32_t>(row + p));
    return mc::llr(w, a.x_table[static_cast<size_t>(mg) * N + p], inv_s);
  };

  // head merge: a pending slot starts generation 0's frame
  const bool rm = !a.drain && pend_in > 0.5f;
  const float m0 = gen_m(0);
  for (int s = 0; s < S2; ++s) {
    for (int p = t; p < N; p += half) {
      float v = a.state[s * plane + row + p];
      if (rm && s != n + 1) v = (s == n) ? gen_llr(0, m0, p) : 0.f;
      smem[s * N + p] = v;
    }
  }
  float u_c[2];  // true u of positions t and t + N/2
  for (int k = 0; k < 2; ++k) {
    const int p = t + k * half;
    u_c[k] = rm ? a.u_table[static_cast<size_t>(m0) * N + p]
                : a.meta[plane + row + p];
  }
  float m_c = rm ? m0 : m_in;
  float it_c = rm ? 0.f : it_in;
  float avail = a.drain ? 0.f : static_cast<float>(a.spares) - (rm ? 1.f : 0.f);
  int ptr = rm ? 1 : 0;  // the next generation to consume
  float pend_c = a.drain ? pend_in : 0.f;
  float eb = 0.f, ebl = 0.f, fr = 0.f;
  int since = 0;
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    bp::iteration<F>(L, R, n, N, t);
    ++since;
    const bool last = it == a.iters - 1;
    if ((it + 1) % a.cadence != 0 && !last) continue;
    const float alive = 1.f - pend_c;
    it_c = it_c + static_cast<float>(since) * alive;
    since = 0;
    const bool ok = bp::gmat_ok(L, R, x, n, N, t);
    const bool done = alive > 0.5f && (ok || it_c >= static_cast<float>(a.iter_max));
    const bool has = avail > 0.5f;
    const bool retire_now = done && has;
    if (retire_now || (last && done)) {
      int cnt = 0;
      for (int k = 0; k < 2; ++k) {
        const float u = bp::decision(L, R, t + k * half);
        cnt += __syncthreads_count(u != u_c[k]);
      }
      eb += static_cast<float>(cnt);
      ebl += cnt > 0 ? 1.f : 0.f;
      fr += 1.f;
    }
    if (retire_now) {  // restart the slot on its next generation, in place
      const float mg = gen_m(ptr);
      for (int s = 0; s < S2; ++s) {
        if (s == n + 1) continue;  // R[0], the frozen row, stays
        for (int p = t; p < N; p += half) {
          smem[s * N + p] = (s == n) ? gen_llr(ptr, mg, p) : 0.f;
        }
      }
      for (int k = 0; k < 2; ++k) {
        u_c[k] = a.u_table[static_cast<size_t>(mg) * N + t + k * half];
      }
      m_c = mg;
      it_c = 0.f;
      ++ptr;
      avail -= 1.f;
      __syncthreads();
    }
    if (last && done && !has) pend_c = 1.f;
  }

  for (int s = 0; s < S2; ++s) {
    for (int p = t; p < N; p += half) a.state[s * plane + row + p] = smem[s * N + p];
  }
  for (int k = 0; k < 2; ++k) {
    const size_t q = row + t + k * half;
    a.meta[q] = m_c;
    a.meta[plane + q] = u_c[k];
    a.meta[2 * plane + q] = it_c;
    a.meta[3 * plane + q] = pend_c;
  }
  if (t == 0) {
    a.stats[3 * static_cast<size_t>(slot)] = eb;
    a.stats[3 * static_cast<size_t>(slot) + 1] = ebl;
    a.stats[3 * static_cast<size_t>(slot) + 2] = fr;
  }
}

template <int F>
cudaError_t launch(const McArgs& a, cudaStream_t stream) {
  const size_t smem = bp::lattice_bytes(a.n);
  cudaError_t err = cudaFuncSetAttribute(
      bp_wave_mc_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bp_wave_mc_kernel<F><<<a.B, (1 << a.n) / 2, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

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
  switch (flavor) {
    case bp::kMinsumLut:
      return launch<bp::kMinsumLut>(a, stream);
    case bp::kMinsumLutFast:
      return launch<bp::kMinsumLutFast>(a, stream);
    case bp::kSpa:
      return launch<bp::kSpa>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bp_wave_mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
