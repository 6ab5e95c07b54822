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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    if (es_every > 0 && (it + 1) % es_every == 0) {
      for (int p = t; p < N; p += half) {
        x[p] = (fr[p] > 0.f) ? 0 : (L[p] + R[p] < 0.f ? 1 : 0);
      }
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
      if (__syncthreads_and(ok)) break;  // uniform across the block
    }
  }

  for (int p = t; p < N; p += half) {
    out[row + p] = (fr[p] > 0.f) ? 0 : (L[p] + R[p] < 0.f ? 1 : 0);
  }
}

template <int F>
cudaError_t launch(const float* ch, const float* fr, int8_t* out, int B, int n,
                   int iters, int es_every, cudaStream_t stream) {
  const int N = 1 << n;
  const size_t smem = 2 * static_cast<size_t>(n + 1) * N * sizeof(float) + N;
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
  int n = 0;
  while ((1 << n) < N) ++n;
  if (B <= 0 || N < 8 || N > 1024 || (1 << n) != N || iters < 0 ||
      es_every < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (flavor) {
    case kMinsumLut:
      return launch<kMinsumLut>(ch, fr, out, B, n, iters, es_every, stream);
    case kMinsumLutFast:
      return launch<kMinsumLutFast>(ch, fr, out, B, n, iters, es_every, stream);
    case kSpa:
      return launch<kSpa>(ch, fr, out, B, n, iters, es_every, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bp_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
