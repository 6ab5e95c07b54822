// Successive-cancellation list decoding of polar codes on Hopper (sm_90a),
// exact or with approximate rate-1 nodes, with the frozen mask and the node
// table read at run time.
//
// Replaces the TPU kernel scl_decode_fast
// (polardecoding_tpu/ops/pallas/scl_fast_kernel.py:866) in both its modes,
// exact (r1 = 0) and the bounded-fork rate-1 flavor (r1 > 0, its run_r1),
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
// Rate-1 (R1) nodes.  The per-leaf table gives, at the first leaf j of each
// R1 node of models/scl_fast.decompose, its stage s (width w = 2^s), and
// frozen bits in bit 0.  There the descent stops at stage s (alpha: llr
// slot s, or the channel for s = n), and the whole block is decided at
// once, t = min(L-1, w) forks in place of one per leaf:
//   A. per path, the t smallest |alpha_e| in (value, position) order, which
//      are the successive first-occurrence minima of the plain version for
//      |alpha| < BIG/2, ranked by counting;
//   B. t rounds of the 2L -> L selection above with penalties 0 and the
//      parent's k-th minimum; a round copies the 2n row pointers, the
//      path's origin before the node and its flip bits from the parent;
//   C. x = (alpha < 0) of the origin, its chosen positions flipped, into
//      hist[j..j+w) as scratch; and what the bits after the node read, as
//      the per-bit path would leave it, for all L paths in fresh rows: bits
//      slot i < s = x[w-2^(i+1) .. w-2^i) ^ x[w-2^i .. w), the code block of
//      the tail's left half, and ubit = x[w-1];
//   D. u = the polar transform of x in place in hist (its own inverse), with
//      (origin << 1) at leaf j and (path << 1) after it for the traceback.
// Its scratch is mins f32 [L][tmax], pos u16 [L][tmax], flips u32 [2][L]
// and orig u8 [2][L], with tmax = min(L-1, widest R1 node); 6 KB at
// L = 32, none in exact mode, whose layout is unchanged.
//
// What bounds it on this card: latency, not bytes or operations.  The
// decode is a chain of about 4 block-wide barriers per bit (3600 per frame
// at N = 1024 in exact mode), and most stages have few elements (L * 2^i at
// stage i), so most threads wait at most barriers.  An R1 node of width w
// takes about 2 min(L-1, w) + s + 3 barriers in place of about 4w.  The
// design answers with more frames in flight: the state fits 4 blocks of
// 256 threads on an SM at N = 1024, L = 8.  Later versions could run the
// small stages and the selection inside one warp (shuffles and __syncwarp
// instead of __syncthreads), or decode several frames per block.

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
  size_t llr, pm, cand, mins, flips, pos, bits, hist, ptr, fz, ubit, orig,
      total;
};

// Byte offsets in dynamic shared memory, 4-byte arrays first; tm = 0 (no R1
// node) gives the exact mode's layout.
__host__ __device__ inline Layout layout(int n, int L, int tm) {
  const size_t N = size_t(1) << n, S = N - 1;
  const size_t r1 = tm > 0;
  Layout o;
  o.llr = 0;                              // f32 [L][S]
  o.pm = o.llr + 4 * L * S;               // f32 [L]
  o.cand = o.pm + 4 * L;                  // f32 [2L + 1]; [2L]: rank L's value
  o.mins = o.cand + 4 * (2 * L + 1);      // f32 [L][tm]: R1 minima of |alpha|
  o.flips = o.mins + 4 * size_t(L) * tm;  // u32 [2][L]: R1 flip bits
  o.pos = o.flips + r1 * 8 * L;           // u16 [L][tm]: their positions
  o.bits = o.pos + 2 * size_t(L) * tm;    // u8 [L][S]
  o.hist = o.bits + L * S;                // u8 [N][L]: parent << 1 | bit
  o.ptr = o.hist + N * L;                 // u8 [2 buffers][2 kinds][L][n]
  o.fz = o.ptr + 4 * size_t(L) * n;       // u8 [N]: frozen | R1 stage << 1
  o.ubit = o.fz + N;                      // u8 [L]: bit j-1 of each path
  o.orig = o.ubit + L;                    // u8 [2][L]: R1 path before the node
  o.total = o.orig + r1 * 2 * L;
  return o;
}

// kR1 = false is the exact mode, compiled without the R1 branch.
template <bool kR1>
__global__ void __launch_bounds__(kMaxThreads)
scl_decode_kernel(const float* __restrict__ ch_all,
                  const uint8_t* __restrict__ leaf,
                  int8_t* __restrict__ u_out, float* __restrict__ pm_out,
                  int32_t* __restrict__ ties_out, int n, int L, int tm) {
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  const Layout o = layout(n, L, kR1 ? tm : 0);
  const int N = 1 << n, S = N - 1, L2 = 2 * L;
  float* llr = reinterpret_cast<float*>(sm + o.llr);
  float* PM = reinterpret_cast<float*>(sm + o.pm);
  float* cand = reinterpret_cast<float*>(sm + o.cand);
  float* mins = reinterpret_cast<float*>(sm + o.mins);
  uint32_t* flips = reinterpret_cast<uint32_t*>(sm + o.flips);
  uint16_t* pos = reinterpret_cast<uint16_t*>(sm + o.pos);
  uint8_t* bits = sm + o.bits;
  uint8_t* hist = sm + o.hist;
  uint8_t* ptr = sm + o.ptr;
  uint8_t* fz = sm + o.fz;
  uint8_t* ubit = sm + o.ubit;
  uint8_t* orig = sm + o.orig;
  const int tid = threadIdx.x, T = blockDim.x;
  const int Ln = L * n;
  const float* ch = ch_all + static_cast<size_t>(blockIdx.x) * N;

  for (int i = tid; i < L * S; i += T) {
    llr[i] = 0.f;
    bits[i] = 0;
  }
  for (int i = tid; i < 2 * Ln; i += T) ptr[i] = (i / n) % L;  // buffer 0
  for (int j = tid; j < N; j += T) fz[j] = leaf[j];
  for (int k = tid; k < L; k += T) {
    PM[k] = k == 0 ? 0.f : kBig;
    ubit[k] = 0;
  }
  __syncthreads();

  int pb = 0;    // which pointer buffer is current (uniform)
  int ties = 0;  // kept by thread 0
  for (int j = 0, step = 1; j < N; j += step) {
    const int t = j == 0 ? n : __ffs(j) - 1;
    const int s = kR1 ? fz[j] >> 1 : 0;  // stage of an R1 node starting here
    step = 1;
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
    for (int i = t - 1; i >= s; --i) {
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
    if (kR1 && s) {
      const int w = 1 << s, tt = min(L - 1, w);
      // the node's input LLRs of the path before the node
      auto alpha = [&](int k) -> const float* {
        return s == n ? ch : llr + k * S + w - 1;
      };
      // A. each path's tt smallest |alpha| in (value, position) order
      for (int idx = tid; tt && idx < (L << s); idx += T) {
        const int k = idx >> s, e = idx & (w - 1);
        const float* a = alpha(k);
        const float v = fabsf(a[e]);
        int r = 0;
        for (int q = 0; q < w && r < tt; ++q) {
          const float x = fabsf(a[q]);
          r += (x < v) || (x == v && q < e);
        }
        if (r < tt) {
          mins[k * tm + r] = v;
          pos[k * tm + r] = static_cast<uint16_t>(e);
        }
      }
      for (int k = tid; tt && k < L; k += T) {
        orig[k] = static_cast<uint8_t>(k);
        flips[k] = 0;
      }
      __syncthreads();
      // B. tt forks: candidates PM + 0 and PM + the k-th minimum
      int ob = 0;  // which orig/flips buffer is current (uniform)
      for (int k = 0; k < tt; ++k) {
        const uint8_t* og = orig + ob * L;
        const uint32_t* fg = flips + ob * L;
        for (int c = tid; c < L2; c += T) {
          cand[c] = c < L ? PM[c] + 0.f : PM[c - L] + mins[og[c - L] * tm + k];
        }
        __syncthreads();
        uint8_t* cL = ptr + pb * 2 * Ln;
        uint8_t* nL = ptr + (pb ^ 1) * 2 * Ln;
        for (int c = tid; c < L2; c += T) {
          const float v = cand[c];
          int r = 0;
          for (int q = 0; q < L2; ++q) {
            const float x = cand[q];
            r += (x < v) || (x == v && q < c);
          }
          if (r < L) {
            const int p = c < L ? c : c - L;
            const uint32_t b = c >= L;
            PM[r] = v;
            orig[(ob ^ 1) * L + r] = og[p];
            flips[(ob ^ 1) * L + r] = fg[p] | (b << k);
            for (int q = 0; q < n; ++q) {
              nL[r * n + q] = cL[p * n + q];
              nL[Ln + r * n + q] = cL[Ln + p * n + q];
            }
          } else if (r == L) {
            cand[L2] = v;
          }
        }
        __syncthreads();
        pb ^= 1;
        ob ^= 1;
        if (tid == 0 && PM[L - 1] == cand[L2] && cand[L2] < kHalfBig) ++ties;
      }
      // C. x of path r at position e, into hist as scratch, and the bits
      // slots below s and ubit that the bits after the node read
      auto xbit = [&](int r, int e) -> int {
        const int og = tt ? orig[ob * L + r] : r;
        const uint32_t f = tt ? flips[ob * L + r] : 0u;
        int v = alpha(og)[e] < 0.f;
        for (int k = 0; k < tt; ++k) {
          v ^= (pos[og * tm + k] == e) & static_cast<int>(f >> k);
        }
        return v & 1;
      };
      uint8_t* cB = ptr + pb * 2 * Ln + Ln;
      for (int idx = tid; idx < (L << s); idx += T) {
        const int r = idx >> s, e = idx & (w - 1);
        const int xe = xbit(r, e);
        hist[(j + e) * L + r] = static_cast<uint8_t>(xe);
        if (e == w - 1) {
          ubit[r] = static_cast<uint8_t>(xe);
        } else {  // entry e of the slots below s: stage i, element ei
          const int i = 31 - __clz(e + 1), ei = e + 1 - (1 << i);
          bits[r * S + e] = static_cast<uint8_t>(
              xbit(r, w - (2 << i) + ei) ^ xbit(r, w - (1 << i) + ei));
          if (ei == 0) cB[r * n + i] = static_cast<uint8_t>(r);
        }
      }
      __syncthreads();
      // D. u = the transform of x; the last level adds the traceback's
      // parents: the origin at leaf j, the path itself after it
      for (int d = 1; d < w; d <<= 1) {
        const bool last = 2 * d == w;
        for (int idx = tid; idx < (L << (s - 1)); idx += T) {
          const int r = idx >> (s - 1), m = idx & ((w >> 1) - 1);
          const int i = ((m & ~(d - 1)) << 1) | (m & (d - 1));
          uint8_t* hi = hist + (j + i) * L + r;
          uint8_t* lo = hist + (j + i + d) * L + r;
          int a = *hi ^ *lo, b = *lo;
          if (last) {
            a |= (i == 0 && tt ? orig[ob * L + r] : r) << 1;
            b |= r << 1;
          }
          *hi = static_cast<uint8_t>(a);
          *lo = static_cast<uint8_t>(b);
        }
        __syncthreads();
      }
      step = w;
      continue;
    }
    if (fz[j] & 1) {
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
        for (int q = 0; q < n; ++q) {
          nL[r * n + q] = pL[p * n + q];
          nB[r * n + q] = pB[p * n + q];
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

// Bytes of dynamic shared memory a block takes at (N, L) with R1 scratch
// for tmax forks per node (0 in exact mode).
extern "C" size_t scl_decode_smem_bytes(int N, int L, int tmax) {
  int n = 0;
  while ((1 << n) < N) ++n;
  return layout(n, L, tmax).total;
}

// ch: [B, N] f32; leaf: [N] u8, bit 0 set on frozen bits and bits 1..4 the
// stage s >= 1 of the R1 node starting at that bit (else 0); u_out:
// [B, L, N] int8, pm_out: [B, L] f32, ties_out: [B] int32, all device
// pointers; N a power of two in [2, 1024], 1 <= L <= 32; r1 non-zero when
// the table has R1 nodes, tmax = min(L - 1, width of the widest), else 0.
// Launches on `stream` without synchronising; returns the cudaError_t code,
// cudaErrorInvalidValue also when the block's shared memory exceeds what the
// device allows.
extern "C" int scl_decode_launch(const float* ch, const uint8_t* leaf,
                                 int8_t* u_out, float* pm_out,
                                 int32_t* ties_out, int B, int N, int L,
                                 int tmax, int r1, cudaStream_t stream) {
  int n = 0;
  while ((1 << n) < N) ++n;
  if (B <= 0 || N < 2 || N > 1024 || (1 << n) != N || L < 1 || L > 32 ||
      tmax < 0 || tmax > L - 1 || (!r1 && tmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = layout(n, L, tmax).total;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = r1 ? scl_decode_kernel<true> : scl_decode_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = 32 * L;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  kernel<<<B, threads, smem, stream>>>(ch, leaf, u_out, pm_out, ties_out, n,
                                       L, tmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scl_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
