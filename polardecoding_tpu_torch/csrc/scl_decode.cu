// Exact successive-cancellation list decoding of polar codes on Hopper
// (sm_90a), with the frozen mask read at run time.
//
// Replaces the TPU kernel scl_decode_fast
// (polardecoding_tpu/ops/pallas/scl_fast_kernel.py:866) in its exact mode,
// and with it the two traced-mask kernels of the same contract,
// scl_decode_subtree (ops/pallas/scl_subtree_kernel.py:342) and
// scl_decode_tree (ops/pallas/scl_tree_kernel.py:376).  It computes what
// polardecoding_tpu_torch/models/scl.scl_decode computes, bit for bit:
// u_all [B, L, N] int8, PM [B, L] f32 and the median-tie counter [B] int32.
//
// Design: one thread block per frame and a serial loop over the N bits.
// Per-path state is the compact layout of models/_compact.py in dynamic
// shared memory: llr [L][N-1] f32 and bits [L][N-1] u8, where stage s owns
// the slot [2^s - 1, 2^(s+1) - 1) of a row.  Path copies are lazy: each path
// keeps one row pointer per stage and kind (llr, bits), and selection copies
// only those 2n pointers from its parent.  No copy of data is ever needed,
// because every write to a slot happens for all L paths at once and covers
// the whole slot: path k writes its own row k and points that stage at it,
// and the old contents of the slot are dead for every path.  The decided
// bits are not copied either: hist [N][L] keeps (parent << 1 | bit) of every
// slot at every bit, and the end of the kernel traces each final path back.
// At N = 1024 that is 5 KB of state and 1 KB of history per path, 197 KB at
// L = 32, within the 227 KB a block may have.
//
// Per bit j, with t = ntz(j):
//   1. (j > 0) the partial sums of bit j-1 up to stage t, fused with the
//      g-node at stage t that reads them: element e of path k is
//      u_k ^ XOR_{i < t, bit i of e == 0} bits_i[e mod 2^i], so every
//      thread computes its own elements with no barrier between the two;
//   2. f-nodes (CHK) at stages t-1 .. 0, one barrier per stage;
//   3. a frozen bit adds PHI(l, 0) to every PM.  An info bit forms the 2L
//      candidates [PM + PHI(l, 0), PM + PHI(l, 1)] and ranks each by
//      counting, rank = #{c' : v' < v} + #{c' < c : v' == v}, the order of
//      a stable ascending sort and of the JAX engine's top_k on -cand; the
//      candidate of rank r < L becomes slot r.
// The CHK, PHI and g arithmetic keep the plain version's operand order, and
// the library is built with -fmad=false and no fast math.
//
// What bounds it on this card: latency, not bytes or operations.  The
// decode is a chain of about 4 block-wide barriers per bit (4000 per frame
// at N = 1024), and most stages have few elements (L * 2^i at stage i), so
// most threads wait at most barriers.  Its design answers with more frames
// in flight: the state fits 4 blocks of 256 threads on an SM at N = 1024,
// L = 8.  Later versions could run the small stages and the selection
// inside one warp (shuffles and __syncwarp instead of __syncthreads), or
// decode several frames per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ops/chk.py LUT_THRESHOLDS / LUT_VALUES as f32 literals.
constexpr float kT0 = 0.196f, kT1 = 0.433f, kT2 = 0.71f, kT3 = 1.05f,
                kT4 = 1.508f, kT5 = 2.252f, kT6 = 4.5f;
constexpr float kV0 = 0.65f, kV1 = 0.55f, kV2 = 0.45f, kV3 = 0.35f,
                kV4 = 0.25f, kV5 = 0.15f, kV6 = 0.05f, kV7 = 0.0f;
constexpr float kBig = 1e30f;      // PM of inactive list slots
constexpr float kHalfBig = 5e29f;  // BIG / 2, the tie counter's guard
constexpr int kMaxThreads = 512;

// The balanced select tree of ops/chk._lut_tree: a value exactly at a
// threshold falls in the upper bin, NaN in bin 0.
__device__ __forceinline__ float lut(float x) {
  return x >= kT3 ? (x >= kT5 ? (x >= kT6 ? kV7 : kV6) : (x >= kT4 ? kV5 : kV4))
                  : (x >= kT1 ? (x >= kT2 ? kV3 : kV2) : (x >= kT0 ? kV1 : kV0));
}

// ops/chk.chk: sign(a) sign(b) min(|a|, |b|) + (delta(|a+b|) - delta(|a-b|)).
__device__ __forceinline__ float chk(float a, float b) {
  const float s = ((a >= 0.f) == (b >= 0.f)) ? 1.f : -1.f;
  const float sm = s * fminf(fabsf(a), fabsf(b));
  return sm + (lut(fabsf(a + b)) - lut(fabsf(a - b)));
}

// ops/chk.phi_penalties_both: PHI(l, 0) and PHI(l, 1).
__device__ __forceinline__ float phi(float l, bool one) {
  const float absl = fabsf(l);
  const bool disagree = one ? (l > 0.f) : (l < 0.f);
  return lut(absl) + (disagree ? absl : 0.f);
}

struct Layout {
  size_t llr, pm, cand, bits, hist, ptr, fz, ubit, total;
};

// Byte offsets in dynamic shared memory, f32 arrays first.
__host__ __device__ inline Layout layout(int n, int L) {
  const size_t N = size_t(1) << n, S = N - 1;
  Layout o;
  o.llr = 0;                              // f32 [L][S]
  o.pm = o.llr + 4 * L * S;               // f32 [L]
  o.cand = o.pm + 4 * L;                  // f32 [2L + 1]; [2L]: rank L's value
  o.bits = o.cand + 4 * (2 * L + 1);      // u8 [L][S]
  o.hist = o.bits + L * S;                // u8 [N][L]: parent << 1 | bit
  o.ptr = o.hist + N * L;                 // u8 [2 buffers][2 kinds][L][n]
  o.fz = o.ptr + 4 * size_t(L) * n;       // u8 [N]
  o.ubit = o.fz + N;                      // u8 [L]: bit j-1 of each path
  o.total = o.ubit + L;
  return o;
}

__global__ void __launch_bounds__(kMaxThreads)
scl_decode_kernel(const float* __restrict__ ch_all,
                  const uint8_t* __restrict__ frozen,
                  int8_t* __restrict__ u_out, float* __restrict__ pm_out,
                  int32_t* __restrict__ ties_out, int n, int L) {
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  const Layout o = layout(n, L);
  const int N = 1 << n, S = N - 1, L2 = 2 * L;
  float* llr = reinterpret_cast<float*>(sm + o.llr);
  float* PM = reinterpret_cast<float*>(sm + o.pm);
  float* cand = reinterpret_cast<float*>(sm + o.cand);
  uint8_t* bits = sm + o.bits;
  uint8_t* hist = sm + o.hist;
  uint8_t* ptr = sm + o.ptr;
  uint8_t* fz = sm + o.fz;
  uint8_t* ubit = sm + o.ubit;
  const int tid = threadIdx.x, T = blockDim.x;
  const int Ln = L * n;
  const float* ch = ch_all + static_cast<size_t>(blockIdx.x) * N;

  for (int i = tid; i < L * S; i += T) {
    llr[i] = 0.f;
    bits[i] = 0;
  }
  for (int i = tid; i < 2 * Ln; i += T) ptr[i] = (i / n) % L;  // buffer 0
  for (int j = tid; j < N; j += T) fz[j] = frozen[j];
  for (int k = tid; k < L; k += T) {
    PM[k] = k == 0 ? 0.f : kBig;
    ubit[k] = 0;
  }
  __syncthreads();

  int pb = 0;    // which pointer buffer is current (uniform)
  int ties = 0;  // kept by thread 0
  for (int j = 0; j < N; ++j) {
    const int t = j == 0 ? n : __ffs(j) - 1;
    uint8_t* pL = ptr + pb * 2 * Ln;  // llr row of (path, stage)
    uint8_t* pB = pL + Ln;            // bits row of (path, stage)
    if (t < n) {
      const int w = 1 << t;
      for (int idx = tid; idx < (L << t); idx += T) {
        const int k = idx >> t, e = idx & (w - 1);
        int v = ubit[k];
        for (int i = 0; i < t; ++i) {
          if (!((e >> i) & 1)) {
            v ^= bits[pB[k * n + i] * S + (1 << i) - 1 + (e & ((1 << i) - 1))];
          }
        }
        bits[k * S + w - 1 + e] = static_cast<uint8_t>(v);
        const float* src =
            (t + 1 == n) ? ch : llr + pL[k * n + t + 1] * S + (2 << t) - 1;
        const float up = src[e], lo = src[e + w];
        const float sgn = v ? -1.f : 1.f;
        llr[k * S + w - 1 + e] = lo + sgn * up;
        if (e == 0) {
          pL[k * n + t] = static_cast<uint8_t>(k);
          pB[k * n + t] = static_cast<uint8_t>(k);
        }
      }
      __syncthreads();
    }
    for (int i = t - 1; i >= 0; --i) {
      const int w = 1 << i;
      for (int idx = tid; idx < (L << i); idx += T) {
        const int k = idx >> i, e = idx & (w - 1);
        const float* src =
            (i + 1 == n) ? ch : llr + pL[k * n + i + 1] * S + (2 << i) - 1;
        llr[k * S + w - 1 + e] = chk(src[e], src[e + w]);
        if (e == 0) pL[k * n + i] = static_cast<uint8_t>(k);
      }
      __syncthreads();
    }
    if (fz[j]) {
      for (int k = tid; k < L; k += T) {
        PM[k] = PM[k] + phi(llr[k * S], false);
        hist[j * L + k] = static_cast<uint8_t>(k << 1);
        ubit[k] = 0;
      }
      __syncthreads();
      continue;
    }
    for (int c = tid; c < L2; c += T) {
      const int k = c < L ? c : c - L;
      cand[c] = PM[k] + phi(llr[k * S], c >= L);
    }
    __syncthreads();
    uint8_t* nL = ptr + (pb ^ 1) * 2 * Ln;
    uint8_t* nB = nL + Ln;
    for (int c = tid; c < L2; c += T) {
      const float v = cand[c];
      int r = 0;
      for (int q = 0; q < L2; ++q) {
        const float x = cand[q];
        r += (x < v) || (x == v && q < c);
      }
      if (r < L) {
        const int p = c < L ? c : c - L;
        const int b = c >= L;
        PM[r] = v;
        ubit[r] = static_cast<uint8_t>(b);
        hist[j * L + r] = static_cast<uint8_t>((p << 1) | b);
        for (int s = 0; s < n; ++s) {
          nL[r * n + s] = pL[p * n + s];
          nB[r * n + s] = pB[p * n + s];
        }
      } else if (r == L) {
        cand[L2] = v;
      }
    }
    __syncthreads();
    pb ^= 1;
    if (tid == 0 && PM[L - 1] == cand[L2] && cand[L2] < kHalfBig) ++ties;
  }

  // Trace each final path back through hist into the (now free) llr region,
  // then write u_all with consecutive threads on consecutive bytes.
  uint8_t* u_sm = sm + o.llr;
  const size_t frame = blockIdx.x;
  for (int k = tid; k < L; k += T) {
    int cur = k;
    for (int j = N - 1; j >= 0; --j) {
      const int h = hist[j * L + cur];
      u_sm[k * N + j] = static_cast<uint8_t>(h & 1);
      cur = h >> 1;
    }
    pm_out[frame * L + k] = PM[k];
  }
  if (tid == 0) ties_out[frame] = ties;
  __syncthreads();
  int8_t* out = u_out + frame * L * N;
  for (int i = tid; i < L * N; i += T) out[i] = static_cast<int8_t>(u_sm[i]);
}

}  // namespace

// Bytes of dynamic shared memory a block takes at (N, L).
extern "C" size_t scl_decode_smem_bytes(int N, int L) {
  int n = 0;
  while ((1 << n) < N) ++n;
  return layout(n, L).total;
}

// ch: [B, N] f32, frozen: [N] u8 (1 on frozen bits), u_out: [B, L, N] int8,
// pm_out: [B, L] f32, ties_out: [B] int32, all device pointers; N a power of
// two in [2, 1024], 1 <= L <= 32.  Launches on `stream` without
// synchronising; returns the cudaError_t code, cudaErrorInvalidValue also
// when the block's shared memory exceeds what the device allows.
extern "C" int scl_decode_launch(const float* ch, const uint8_t* frozen,
                                 int8_t* u_out, float* pm_out,
                                 int32_t* ties_out, int B, int N, int L,
                                 cudaStream_t stream) {
  int n = 0;
  while ((1 << n) < N) ++n;
  if (B <= 0 || N < 2 || N > 1024 || (1 << n) != N || L < 1 || L > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = layout(n, L).total;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(scl_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = 32 * L;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  scl_decode_kernel<<<B, threads, smem, stream>>>(ch, frozen, u_out, pm_out,
                                                  ties_out, n, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scl_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
