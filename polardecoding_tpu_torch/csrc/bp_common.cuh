// Device code shared by the BP kernels (bp_decode.cu, bp_wave.cu,
// bp_wave_mc.cu): the table-corrected CHK, one flooding iteration on the
// live rows, the decision and the G-matrix rule, and the wave kernels'
// load and write-back of a slot of the state.
//
// A block runs one frame over the butterfly pairs of stage i, (u, u + 2^i)
// with u = ((v >> i) << (i + 1)) | (v & (2^i - 1)) for v in [0, N/2).  An
// iteration is an R-sweep over stages 0..n-1 then an L-sweep over n-1..0,
// each stage after the one before it (the reference's Gauss-Seidel order).
// The four butterfly equations keep the plain version's
// (models/bp.bp_iteration) operand order, and the sources are built with
// -fmad=false, so no a*b+c is contracted and every result is bit-equal to
// the plain version's.
//
// `live_iteration` / `live_gmat_ok`:
// - Rows.  Only L[1..n-1] and R[1..n-1] are in shared memory (2(n-1)N
//   floats: 73,728 bytes at N = 1024, 3 frames per SM).  L[n] (the channel row,
//   constant) and R[n] (written by the R-sweep's last stage and read only
//   by the check) live in registers of the thread whose stage-(n-1) pair
//   is (v, v + N/2); R[0] (the frozen row, constant) and L[0] (written by
//   the L-sweep's last stage and read only by the decision) in registers
//   of the thread whose stage-0 pair is (2v, 2v + 1) (`Ends`).  Rows
//   R[1..n-1] and L[0], R[n] of the previous iteration are dead: each is
//   written before it is read, since the R-sweep starts again from R[0].
// - Threads.  A block of T = N / 4 threads; thread t runs the kPairs = 2
//   lanes v = t + k T, so two pairs per stage as independent chains.
// - Barriers.  At stage i <= 5 the 32 lanes of virtual warp v >> 5 touch
//   only positions [64 (v >> 5), 64 (v >> 5) + 64) of any row, and the
//   virtual warps of one thread's two lanes are both in that thread's warp:
//   such a stage never reaches another warp's positions.  So a hazard
//   between two warps (read after write or write after read, on a row in
//   shared memory or the check's scratch) needs a stage >= 6 on one side.
//   The rule (`step_sync`): between two consecutive phases (a stage of a
//   sweep, a step of the check) a __syncthreads() stands where their
//   stages differ and one of them is >= 6, else a __syncwarp().  The two
//   phases at stage n-1 (the turn) share a thread's positions and write
//   only registers and L[n-1], which the R-sweep's stage does not touch, so
//   they need none.  Across iterations the L-sweep's stages 5..0 and the
//   next R-sweep's 0..5 are all warp-local.  That is 2(n-6) block barriers
//   per iteration for n >= 7 (8 at N = 1024, 2 at N = 128), none at
//   N <= 64, where a frame is one warp; the check adds max(0, n-6) and one
//   reduction.  Loads, stores and refills of the shared rows use each
//   lane's `home` positions, which lie in the same 64-position window.
// - The CHK's table.  The sweep is bound by instruction issue: the table
//   by compares and selects (ops/chk._lut_tree) is 14 operations on the
//   ALU pipe, which runs at half the FP32 pipe's rate, twice per CHK.  The
//   sweep takes it as an exact chain on the FP32 pipe (`lut_fma`), and
//   skips it where both of its arguments are past the last threshold
//   (`lut_fma_diff`), as they are for most CHKs of a converged frame.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bp {

// ops/chk.py LUT_THRESHOLDS / LUT_VALUES as f32 literals.
constexpr float kT0 = 0.196f, kT1 = 0.433f, kT2 = 0.71f, kT3 = 1.05f,
                kT4 = 1.508f, kT5 = 2.252f, kT6 = 4.5f;
constexpr float kV0 = 0.65f, kV1 = 0.55f, kV2 = 0.45f, kV3 = 0.35f,
                kV4 = 0.25f, kV5 = 0.15f, kV6 = 0.05f, kV7 = 0.0f;

enum Flavor { kMinsumLut = 0, kMinsumLutFast = 1, kSpa = 2 };

// fma(a, b, c) clamped to [0, 1], NaN to 0 (one FFMA.SAT on the card).
__device__ __forceinline__ float fma_sat(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  float r;
  asm("fma.rn.sat.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
#else
  const float r = fmaf(a, b, c);
  return r > 0.f ? (r < 1.f ? r : 1.f) : 0.f;
#endif
}

// The table of ops/chk.lut_correction for x = |.| (x >= 0 or NaN) on the
// FMA pipe: its select tree takes 7 compares and 7 selects, which run at
// half the FMA pipe's rate and bound the sweep.  A value exactly at a
// threshold falls in the upper bin; NaN becomes 0 (bin 0), and from v = kV7 each
// threshold above x adds its step: s = sat(2^32 (kT - x)) is exactly 1 for
// x < kT (a difference of at least 2^-26 at these thresholds) and 0 for
// x >= kT, and fma(s, kE, v) rounds v + kE to exactly the next value down
// the table (kE chosen so; tests/test_torch_bp_rows.py holds the chain
// against the table on the thresholds, their neighbours, 0, inf and NaN).
constexpr float kH = 0x1p32f;
constexpr float kE6 = 0x1.99999ap-5f, kE5 = 0x1.99999cp-4f,
                kE4 = 0x1.999998p-4f, kE3 = 0x1.999998p-4f,
                kE2 = 0x1.999998p-4f, kE1 = 0x1.9999a0p-4f,
                kE0 = 0x1.999990p-4f;
__device__ __forceinline__ float lut_fma(float x) {
  x = fmaxf(x, 0.f);
  float v = kV7;
  v = fmaf(fma_sat(x, -kH, kT6 * kH), kE6, v);
  v = fmaf(fma_sat(x, -kH, kT5 * kH), kE5, v);
  v = fmaf(fma_sat(x, -kH, kT4 * kH), kE4, v);
  v = fmaf(fma_sat(x, -kH, kT3 * kH), kE3, v);
  v = fmaf(fma_sat(x, -kH, kT2 * kH), kE2, v);
  v = fmaf(fma_sat(x, -kH, kT1 * kH), kE1, v);
  return fmaf(fma_sat(x, -kH, kT0 * kH), kE0, v);
}

// The table's difference at p and q by lut_fma, skipped where both
// p and q are at or above the last threshold: both values are then kV7
// and the difference +0, which converged frames give for most CHKs (a
// NaN fails the test and takes the table).
__device__ __forceinline__ float lut_fma_diff(float p, float q) {
  if (p >= kT6 && q >= kT6) return kV7 - kV7;
  return lut_fma(p) - lut_fma(q);
}

// The CHK of ops/chk.py in the plain version's operand order, its table
// by lut_fma_diff.
template <int F>
__device__ __forceinline__ float chk(float a, float b) {
  if (F == kMinsumLutFast) {
    const float ap = fabsf(a + b), aq = fabsf(a - b);
    return 0.5f * (ap - aq) + lut_fma_diff(ap, aq);
  }
  const float s = ((a >= 0.f) == (b >= 0.f)) ? 1.f : -1.f;
  const float sm = s * fminf(fabsf(a), fabsf(b));
  if (F == kSpa) {
    return sm + log1pf(expf(-fabsf(a + b))) - log1pf(expf(-fabsf(a - b)));
  }
  // the smaller of |a + b| and |a - b| is, rounded alike, ||a| - |b||, and
  // the larger is no smaller: at or above kT6 both table values are kV7
  // (the skip of lut_fma_diff, tested before a + b and a - b are formed)
  if (fabsf(fabsf(a) - fabsf(b)) >= kT6) return sm + (kV7 - kV7);
  return sm + (lut_fma(fabsf(a + b)) - lut_fma(fabsf(a - b)));
}

// ---------------------------------------------------------------------------
// The live-row sweep (see the header).

constexpr int kWarpStages = 6;  // stages 0..5 stay inside a warp
constexpr int kPairs = 2;       // butterfly pairs per thread and stage

// The end rows of a thread's lanes: r0, l0 at (2v, 2v + 1), ln, rn at
// (v, v + N/2).
struct Ends {
  float r0[kPairs][2], l0[kPairs][2], ln[kPairs][2], rn[kPairs][2];
};

// The mask of a block's lanes in its warp: the block has T threads.
__device__ __forceinline__ unsigned lane_mask(int T) {
  return T >= 32 ? 0xffffffffu : (1u << T) - 1u;
}

// A __syncwarp of the block's lanes (constant full mask where the block
// fills its warps, which compiles to a plain warp barrier).
__device__ __forceinline__ void warp_sync(unsigned wm) {
  if (wm == 0xffffffffu) {
    __syncwarp();
  } else {
    __syncwarp(wm);
  }
}

// The barrier between two consecutive phases at stages a and b.
__device__ __forceinline__ void step_sync(int a, int b, unsigned wm) {
  if (a != b && (a >= kWarpStages || b >= kWarpStages)) {
    __syncthreads();
  } else {
    warp_sync(wm);
  }
}

// The first of lane v's two home positions, p and p + home_step(N): inside
// the 64-position window of its virtual warp (the whole row when N < 64).
__device__ __forceinline__ int home_step(int N) { return N >= 64 ? 32 : N >> 1; }
__device__ __forceinline__ int home(int v, int N) {
  const int h = home_step(N);
  return (v / h) * 2 * h + v % h;
}

// One flooding iteration on the live rows: L and R are rows 1..n-1 of the
// two lattices (row i at (i - 1) N), T = N / 4 threads, so that lane 1's
// pair at stages 1..n-2 is lane 0's plus N/2 (2^i divides T).  The stages
// between 1 and n-2 run in two loops, those whose barrier before them is a
// __syncwarp and those where it is a __syncthreads (step_sync's rule).
// Every thread of the block must call it.
template <int F>
__device__ __forceinline__ void live_iteration(float* L, float* R, Ends& e,
                                               int n, int N, int t,
                                               unsigned wm) {
  const int T = N / (2 * kPairs);
  const int half = N >> 1;
  // stage i of the R-sweep (side 0) or the L-sweep (side 1), 1 <= i <= n-2
  const auto stage = [&](int i, bool l_side) {
    const int d = 1 << i;
    const int u0 = ((t >> i) << (i + 1)) | (t & (d - 1));
    const float* Ri = R + (i - 1) * N;  // R[i]
    const float* Ln = L + i * N;        // L[i+1]
    float* out = l_side ? L + (i - 1) * N : R + i * N;  // L[i] or R[i+1]
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int u = u0 + k * half;
      const int l = u + d;
      const float ru = Ri[u], rd = Ri[l], lu = Ln[u], ld = Ln[l];
      if (l_side) {
        out[u] = chk<F>(lu, ld + rd);
        out[l] = ld + chk<F>(ru, lu);
      } else {
        out[u] = chk<F>(ru, ld + rd);
        out[l] = rd + chk<F>(ru, lu);
      }
    }
  };
  const int low = n - 1 < kWarpStages ? n - 1 : kWarpStages;
  warp_sync(wm);  // the last iteration's L-sweep, or the load, in this warp
  // R-sweep, stage 0: R[0] in registers, L[1] and R[1] in shared memory
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int u = 2 * (t + k * T);
    const float2 l1 = *reinterpret_cast<const float2*>(L + u);
    float2 r1;
    r1.x = chk<F>(e.r0[k][0], l1.y + e.r0[k][1]);
    r1.y = e.r0[k][1] + chk<F>(e.r0[k][0], l1.x);
    *reinterpret_cast<float2*>(R + u) = r1;
  }
  for (int i = 1; i < low; ++i) {
    warp_sync(wm);
    stage(i, false);
  }
  for (int i = low; i < n - 1; ++i) {
    __syncthreads();
    stage(i, false);
  }
  // stage n-1 of both sweeps: L[n] and R[n] in registers, R[n-1] read once
  step_sync(n - 2, n - 1, wm);
  {
    const float* Ri = R + (n - 2) * N;  // R[n-1]
    float* Lo = L + (n - 2) * N;        // L[n-1]
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int v = t + k * T;
      const float ru = Ri[v], rd = Ri[v + half];
      const float lu = e.ln[k][0], ld = e.ln[k][1];
      const float c = chk<F>(ru, lu);  // R[n, d] and L[n-1, d] add it
      e.rn[k][0] = chk<F>(ru, ld + rd);
      e.rn[k][1] = rd + c;
      Lo[v] = chk<F>(lu, ld + rd);
      Lo[v + half] = ld + c;
    }
  }
  for (int i = n - 2; i >= kWarpStages - 1; --i) {  // after stage i + 1 >= 6
    __syncthreads();
    stage(i, true);
  }
  for (int i = n - 2 < kWarpStages - 2 ? n - 2 : kWarpStages - 2; i >= 1; --i) {
    warp_sync(wm);
    stage(i, true);
  }
  // L-sweep, stage 0: L[1] in shared memory, R[0] and L[0] in registers
  warp_sync(wm);
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int u = 2 * (t + k * T);
    const float2 l1 = *reinterpret_cast<const float2*>(L + u);
    e.l0[k][0] = chk<F>(l1.x, l1.y + e.r0[k][1]);
    e.l0[k][1] = l1.y + chk<F>(e.r0[k][0], l1.x);
  }
}

// The hard decision of one position from its L[0] and R[0]: 0 on a frozen
// bit (R[0] > 0), else sign(L[0] + R[0]).
__device__ __forceinline__ uint8_t decide(float l0, float r0) {
  return (r0 > 0.f) ? 0 : (l0 + r0 < 0.f ? 1 : 0);
}

// A barrier of the block's T threads, the block's AND and count of a
// per-thread predicate; a one-warp block (T <= 32) takes no block barrier.
__device__ __forceinline__ void block_sync(int T, unsigned wm) {
  if (T <= 32) {
    __syncwarp(wm);
  } else {
    __syncthreads();
  }
}
__device__ __forceinline__ bool block_and(bool p, int T, unsigned wm) {
  return (T <= 32 ? __all_sync(wm, p) : __syncthreads_and(p)) != 0;
}
__device__ __forceinline__ int block_count(bool p, int T, unsigned wm) {
  return T <= 32 ? __popc(__ballot_sync(wm, p)) : __syncthreads_count(p);
}

// The G-matrix rule on the live rows: the decision (taken at (2v, 2v + 1))
// re-encoded in x (N bytes of shared scratch, n xor stages, the last in
// registers) equals sign(L[n] + R[n]) (at (v, v + N/2)) at every position.
// Every thread of the block must call it; the result is the same in all.
__device__ __forceinline__ bool live_gmat_ok(const Ends& e, uint8_t* x,
                                             int n, int N, int t,
                                             unsigned wm) {
  const int T = N / (2 * kPairs);
  const int half = N >> 1;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int u = 2 * (t + k * T);
    x[u] = decide(e.l0[k][0], e.r0[k][0]);
    x[u + 1] = decide(e.l0[k][1], e.r0[k][1]);
  }
  for (int i = 0; i < n - 1; ++i) {
    step_sync(i > 0 ? i - 1 : 0, i, wm);  // the decision is at stage 0's pairs
    const int d = 1 << i;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int v = t + k * T;
      const int u = ((v >> i) << (i + 1)) | (v & (d - 1));
      x[u] ^= x[u + d];
    }
  }
  step_sync(n - 2, n - 1, wm);
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int v = t + k * T;
    const uint8_t hi = x[v + half];
    const uint8_t lo = x[v] ^ hi;  // stage n-1's xor
    ok = ok && lo == (e.ln[k][0] + e.rn[k][0] < 0.f ? 1 : 0) &&
         hi == (e.ln[k][1] + e.rn[k][1] < 0.f ? 1 : 0);
  }
  return block_and(ok, T, wm);
}

// A slot of the stage-major state [2(n+1), B, N] into the live rows and
// `e`: st(s) is the slot's row of plane s (L[s] is plane s, R[s] plane
// n + 1 + s).  An iteration reads only L[1..n] and R[0] and writes the
// other planes before it reads them, so those (R[1..n-1], R[n], L[0]) are
// read only where `dead` (a launch of no iteration) and are left unset
// otherwise.  A slot that restarts reads no plane but R[0]: it takes L[n]
// from ln_of(p) and 0 for every other plane, a select, so that a kept
// -0.0 survives.  Shared rows are written at each lane's home positions,
// so the load needs no block barrier.
template <class St, class LnOf>
__device__ __forceinline__ void load_slot(float* L, float* R, Ends& e,
                                          const St& st, int n, int N, int t,
                                          bool restart, bool dead,
                                          const LnOf& ln_of) {
  const int T = N / (2 * kPairs);
  const int half = N >> 1;
  const int hs = home_step(N);
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int v = t + k * T;
    const int h = home(v, N);
    for (int s = 1; s < n; ++s) {
      for (int c = 0; c < 2; ++c) {
        const int q = h + c * hs;
        L[(s - 1) * N + q] = restart ? 0.f : st(s)[q];
        if (dead) R[(s - 1) * N + q] = restart ? 0.f : st(n + 1 + s)[q];
      }
    }
    for (int j = 0; j < 2; ++j) {
      const int p = v + j * half;
      e.ln[k][j] = restart ? ln_of(p) : st(n)[p];
      e.rn[k][j] = (restart || !dead) ? 0.f : st(2 * n + 1)[p];
      const int q = 2 * v + j;
      e.r0[k][j] = st(n + 1)[q];
      e.l0[k][j] = (restart || !dead) ? 0.f : st(0)[q];
    }
  }
}

// The live rows and `e` back to the slot's planes (st as load_slot's):
// L[0..n-1] and R[1..n], and L[n] where `new_ln` (the slot restarted in
// this launch); R[0] is never written.  Called after the last iteration;
// the warp barrier orders this warp's last L-sweep stages before it.
template <class St>
__device__ __forceinline__ void store_slot(const float* L, const float* R,
                                           const Ends& e, const St& st, int n,
                                           int N, int t, unsigned wm,
                                           bool new_ln) {
  const int T = N / (2 * kPairs);
  const int half = N >> 1;
  const int hs = home_step(N);
  warp_sync(wm);
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int v = t + k * T;
    const int h = home(v, N);
    for (int s = 1; s < n; ++s) {
      for (int c = 0; c < 2; ++c) {
        const int q = h + c * hs;
        st(s)[q] = L[(s - 1) * N + q];
        st(n + 1 + s)[q] = R[(s - 1) * N + q];
      }
    }
    for (int j = 0; j < 2; ++j) {
      const int p = v + j * half;
      if (new_ln) st(n)[p] = e.ln[k][j];
      st(2 * n + 1)[p] = e.rn[k][j];
      st(0)[2 * v + j] = e.l0[k][j];
    }
  }
}

// Shared memory of one live-row block: rows 1..n-1 of both lattices, and
// the check's N bytes where a check runs.
inline size_t live_bytes(int n, bool check) {
  const size_t N = size_t{1} << n;
  return 2 * static_cast<size_t>(n - 1) * N * sizeof(float) + (check ? N : 0);
}

// log2 of a power of two N in [8, 1024], else -1.
inline int log2_of(int N) {
  int n = 0;
  while ((1 << n) < N && n < 11) ++n;
  return (N >= 8 && N <= 1024 && (1 << n) == N) ? n : -1;
}

}  // namespace bp
