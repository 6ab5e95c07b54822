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
// What bounds it on this card: latency.  A frame is a chain of dependent
// steps, and most steps have at most 32 work items (stage i holds L * 2^i
// elements; the L path metrics and 2L candidates fit one warp).  Its bytes
// (the LLRs in, u out) and operations take about 5% of its time at N = 1024,
// L = 8; the time falls almost in proportion to the frames resident on an SM
// (scripts/torch_scl_parts.py: 2.0 times faster at 10 frames than at 4).
// The design answers with three things:
//
// 1. One warp per frame.  A block holds F frames, one warp each, and warps
//    never wait on each other: every step ends in __syncwarp.  The selection
//    ranks its <= 64 candidates by counting over a shared array of 2L
//    values, rank = #{c' : v' < v} + #{c' < c : v' == v}, the order of a
//    stable ascending sort and of the JAX engine's top_k on -cand; ranks L-1
//    and L tie iff the candidate of rank L has an equal one before it.  The
//    lane of a candidate reads its parent's PM and pointers before the
//    ranking and, if it survives as slot r, writes them to slot r after it:
//    each path's row pointers are two 64-bit words (6 bits per stage, one
//    word for the LLR rows, one for the partial-sum rows), so a survivor's
//    copy is two 8-byte moves.  The last decided bit of every path is one
//    warp-uniform 32-bit word.  The host picks F and the grid from the
//    card's occupancy for the block's shared memory; the warps stride over
//    the frames.
// 2. A node schedule read at run time (ops/scl_kernel.py builds the per-leaf
//    table from models/scl_fast.decompose): at the first leaf of an
//    all-frozen (R0) or repetition (REP) node of width w = 2^s the descent
//    stops at stage s, and the w leaf LLRs come from s full-width levels
//    [chk(up, dn); dn + up] in place on the node's input, the same f and g
//    values the per-bit schedule computes when every partner bit is 0; each
//    path then adds PHI(l, 0) of its frozen leaves to its PM one by one in
//    leaf order, the per-bit path's f32 association, and a REP node forks
//    once on its last leaf.  Their partial sums are zero (the pointers of
//    those stages go to a zero row), the REP node's last bit is its fork's.
//    R1 nodes (r1 > 0) are decided at once (below).  Other leaves run bit by
//    bit.
// 3. Less shared memory per frame.  The partial sums are bit-packed, and
//    the stage n-1 LLRs are not kept per path: before bit N/2 they are the
//    one path-independent f row chk(ch[e], ch[e + N/2]), after it every
//    path's g value is one of ch[e + N/2] + 1 ch[e] and ch[e + N/2] - 1
//    ch[e], both kept once and chosen by the path's partial-sum bit.  The
//    (parent << 1 | bit) history goes to the frame's own u_out block in
//    [N][L] order during the decode; at the end it is read back into
//    shared memory, each path is traced back, and u_all overwrites it.  An
//    R0/REP node of width N/2 starting at bit N/2 would need the per-path
//    stage n-1 row: the table splits it into its two halves.
//
// Shared memory per frame (bytes, W = max(1, N/32) words):
//   llr   f32 [L][N/2 - 1] (stages 0 .. n-2; at the end the history [N][L])
//   top   f32 [N]  stage n-1: f row, or g+ in [0, N/2) and g- after it; the
//                  node input of a node of width N.  Not in exact mode at
//                  N = 1024, which holds it in registers (kTopRegs)
//   bits  u32 [L + 1][W]  stages 0 .. n-1 packed, slots 0..4 in word 0 at
//                  bit 2^i - 1, slot i >= 5 at word 2^(i-5); row L is zero
//   ptr   u64 [2][L], cand f32 [2L], pm f32 [L], og u8 [L]
//   R1 only: mins f32 [L][tm], flips u32 [L], X u32 [L][xw], pos u16 [L][tm]
// At N = 1024 in exact mode, without top, that is 17,744 bytes at L = 8
// (13 frames on an SM), 35,344 at L = 16 (6 frames) and 70,560 at L = 32
// (3 frames); the flavor keeps top and adds its R1 scratch (22,272 bytes
// in all at L = 8 for the FASTR1 presets, 10 frames).  A block adds the
// node table (N bytes) once.
//
// Per bit j, t = ntz(j) (n for j = 0), stop s (the node's stage, else 0):
//   A. (t < n) slot t's partial sums from the bits slots below t and the
//      last bit, word by word: bit e of the slot is
//      u ^ XOR_{i < t, bit i of e == 0} bits_i[e mod 2^i], for i < 5 a
//      spread of slot i by one multiplication, for i >= 5 a whole word;
//   B. (t < n) the g-node at stage t; f-nodes (CHK) at stages t-1 .. s;
//   C. a frozen leaf adds PHI(l, 0) to every PM; an info leaf ranks the 2L
//      candidates [PM + PHI(l, 0), PM + PHI(l, 1)]; candidate of rank r < L
//      becomes slot r; a node as above.
// At N = 1024 with the 5G mask at rate 1/2 a frame takes 525 descents (the
// bits and nodes that start one), 458 forks and 68 R0/REP nodes in exact
// mode; with the FASTR1 presets' R1 nodes 161 descents, 58 forks and 36 R1
// nodes of 198 forks in all.
//
// Rate-1 (R1) nodes, at their first leaf j, stage s (w = 2^s), with
// tt = min(L - 1, w) forks in place of one per leaf:
//   A. per path, the tt smallest |alpha_e| of its node input in (value,
//      position) order, the plain version's successive first-occurrence
//      minima for |alpha| < BIG/2, each element ranked by counting over all
//      w of its path;
//   B. tt rounds of the selection with penalties 0 and the origin's k-th
//      minimum; a survivor takes its parent's origin (the path before the
//      node) and flip bits, both in shared memory;
//   C. x = (alpha < 0) of the origin, packed by a ballot, its chosen
//      positions flipped; the bits slots below s that the bits after the
//      node read, slot i = x[w-2^(i+1) .. w-2^i) ^ x[w-2^i .. w), into the
//      path's own row, and the last bit x[w-1];
//   D. u = the polar transform of x on the packed words (its own inverse),
//      written to the history with the origin as parent at leaf j and the
//      path itself after it; the pointers are the origin's.
// The CHK, PHI and g arithmetic keep the plain version's operand order, and
// the library is built with -fmad=false and no fast math.

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
constexpr int kMaxFrames = 16;     // frames (warps) per block
constexpr unsigned kAll = 0xffffffffu;
// node kinds of the table, bits 5-6 (bits 1-4 the stage, bit 0 frozen)
constexpr int kLeaf = 0, kRep = 2, kR1Node = 3;  // 1: R0
// one 1 every 6 bits: a row index in every stage field of a pointer word
constexpr uint64_t kFieldOnes = 0x041041041041041ull;

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

__device__ __forceinline__ int field(uint64_t w, int i) {
  return static_cast<int>(w >> (6 * i)) & 63;
}

// w with its stage fields lo .. hi set to row v (none when lo > hi)
__device__ __forceinline__ uint64_t with_fields(uint64_t w, int lo, int hi,
                                                int v) {
  if (lo > hi) return w;
  const uint64_t m = ((uint64_t(1) << (6 * (hi - lo + 1))) - 1) << (6 * lo);
  return (w & ~m) | ((uint64_t(v) * kFieldOnes) & m);
}

// slot i < 5 of a partial-sum row spread over a word: bit b gets s[b mod
// 2^i] where bit i of b is 0
__constant__ uint32_t kSpread[5] = {0x55555555u, 0x11111111u, 0x01010101u,
                                    0x00010001u, 0x00000001u};
// the polar transform's in-word levels d = 1 .. 16: positions with bit d 0
__constant__ uint32_t kPair[5] = {0x55555555u, 0x33333333u, 0x0F0F0F0Fu,
                                  0x00FF00FFu, 0x0000FFFFu};

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

struct Layout {
  size_t llr, top, bits, ptr, cand, pm, mins, fl, xw, pos, og, total;
};

// Byte offsets of one frame's region; tm = xw = 0 in exact mode, and no
// top row where the warp's registers hold it (top_regs).
__host__ __device__ inline Layout layout(int n, int L, int tm, int xw,
                                         bool top_regs) {
  const size_t N = size_t(1) << n, S2 = N / 2 - 1;
  const size_t W = N >= 32 ? N / 32 : 1;
  Layout o;
  o.llr = 0;
  const size_t llr_bytes = 4 * L * S2 > N * L ? 4 * L * S2 : N * L;
  o.top = up16(o.llr + llr_bytes);
  o.bits = up16(o.top + (top_regs ? 0 : 4 * N));
  o.ptr = up16(o.bits + 4 * (L + 1) * W);
  o.cand = up16(o.ptr + 16 * size_t(L));
  o.pm = o.cand + 8 * size_t(L);
  o.mins = up16(o.pm + 4 * size_t(L));
  o.fl = o.mins + 4 * size_t(L) * tm;
  o.xw = o.fl + (xw ? 4 * size_t(L) : 0);
  o.pos = o.xw + 4 * size_t(L) * xw;
  o.og = o.pos + 2 * size_t(L) * tm;
  o.total = up16(o.og + L);
  return o;
}

// kR1 = false is the exact mode, compiled without the R1 branch.  kLogN and
// kL, when not 0, fix n and L at compile time, for the presets' shapes
// (kernel_for): their loops and shifts then have constant bounds, which the
// card runs markedly faster (PERF.md, section 6).  The node loops below stay
// rolled (#pragma unroll 1): unrolled, the larger code ran slower.
//
// Exact mode at N = 1024 (kTopRegs) keeps the stage n-1 row in registers
// instead: lane l holds element l + 32 m as tr[m], m = 0 .. 31.  Every
// access to it pairs e with e + 256 or e + 512, of the same e mod 32, so
// the g- and f-nodes of stages n-1 and n-2 read and write only their own
// lane's elements, with loops unrolled over the element chunk so that tr
// is indexed by constants.  An R0/REP node of stage >= n-1 starts only at
// leaf 0 (the table splits the width-N/2 node at bit N/2), when the llr
// region holds nothing yet: its input and in-place descent go there.  The
// frame's region then has no top row: 17,744 bytes at L = 8, 13 frames an
// SM.
template <bool kR1, int kLogN, int kL>
__global__ void __launch_bounds__(32 * kMaxFrames)
scl_decode_kernel(const float* __restrict__ ch_all,
                  const uint8_t* __restrict__ table,
                  int8_t* __restrict__ u_out, float* __restrict__ pm_out,
                  int32_t* __restrict__ ties_out, int B, int n_arg, int L_arg,
                  int tm, int xw) {
  constexpr bool kTopRegs = !kR1 && kLogN == 10;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n = kLogN ? kLogN : n_arg, L = kL ? kL : L_arg;
  const int N = 1 << n, half = N >> 1, S2 = half - 1;
  const int W = N >= 32 ? N / 32 : 1, L2 = 2 * L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int F = blockDim.x >> 5;
  const Layout o = layout(n, L, kR1 ? tm : 0, kR1 ? xw : 0, kTopRegs);
  uint8_t* tab = smem;
  for (int i = threadIdx.x; i < N; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  uint8_t* fm = smem + up16(N) + size_t(warp) * o.total;
  float* llr = reinterpret_cast<float*>(fm + o.llr);
  // the stage n-1 row in shared memory, or (kTopRegs) the scratch of a node
  // of stage >= n-1 at leaf 0
  float* top = kTopRegs ? llr : reinterpret_cast<float*>(fm + o.top);
  // kTopRegs: the lane's part of the stage n-1 row (N = 1024: its halves
  // are 16 chunks of 32, stage n-2's w = 256 is 8)
  float tr[32];
  uint32_t* bits = reinterpret_cast<uint32_t*>(fm + o.bits);
  uint64_t* ptrL = reinterpret_cast<uint64_t*>(fm + o.ptr);
  uint64_t* ptrB = ptrL + L;
  float* cand = reinterpret_cast<float*>(fm + o.cand);
  float* mins = reinterpret_cast<float*>(fm + o.mins);
  uint32_t* fl_s = reinterpret_cast<uint32_t*>(fm + o.fl);
  uint32_t* X = reinterpret_cast<uint32_t*>(fm + o.xw);
  uint16_t* pos = reinterpret_cast<uint16_t*>(fm + o.pos);
  uint8_t* og_s = fm + o.og;
  float* pm_s = reinterpret_cast<float*>(fm + o.pm);

  for (int frame = blockIdx.x * F + warp; frame < B;
       frame += gridDim.x * F) {
    const float* ch = ch_all + size_t(frame) * N;
    int8_t* hist = u_out + size_t(frame) * L * N;  // [N][L] until the end
    for (int i = lane; i < W; i += 32) bits[L * W + i] = 0;  // the zero row
    if (lane < L) {
      ptrL[lane] = ptrB[lane] = uint64_t(lane) * kFieldOnes;
      pm_s[lane] = lane == 0 ? 0.f : kBig;
    }
    uint32_t ubits = 0;  // bit k: the last decided bit of path k (uniform)
    int ties = 0;        // uniform
    int j = 0;
    bool second = false;  // j >= N/2: the stage n-1 row holds g+ and g-
    __syncwarp();

    // bit e of partial-sum slot i in row `row`
    auto bit_at = [&](int row, int i, int e) -> int {
      return i >= 5 ? (bits[row * W + (1 << (i - 5)) + (e >> 5)] >> (e & 31)) & 1
                    : (bits[row * W] >> ((1 << i) - 1 + e)) & 1;
    };
    // stage-i LLR element e of the path whose rows are rl (LLR) and rb
    // (partial sums); i <= n - 1, and i <= n - 2 under kTopRegs
    auto src_at = [&](int rl, int rb, int i, int e) -> float {
      if (!kTopRegs && i == n - 1) {
        return second && bit_at(rb, i, e) ? top[half + e] : top[e];
      }
      return llr[rl * S2 + (1 << i) - 1 + e];
    };

    // the ranks r0, r1 of the 2L candidates v0 (c = lane) and v1 (c = lane
    // + 32), rank = #{c' : v' < v} + #{c' < c : v' == v}; a tie of ranks
    // L-1 and L counted.  Ends in a __syncwarp: the caller reads the old
    // list before and a survivor writes its slot r < L after.
    auto rank = [&](float v0, float v1, int& r0, int& r1) {
      if (lane < L2) cand[lane] = v0;
      if (lane + 32 < L2) cand[lane + 32] = v1;
      __syncwarp();
      const float2* c2 = reinterpret_cast<const float2*>(cand);
      int lt0 = 0, eq0 = 0, lt1 = 0, eq1 = 0;
      const int c1 = lane + 32;
      for (int q = 0; q < L; ++q) {
        const float2 x = c2[q];
        lt0 += (x.x < v0) + (x.y < v0);
        eq0 += ((x.x == v0) & (2 * q < lane)) + ((x.y == v0) & (2 * q + 1 < lane));
        if (L > 16) {
          lt1 += (x.x < v1) + (x.y < v1);
          eq1 += ((x.x == v1) & (2 * q < c1)) + ((x.y == v1) & (2 * q + 1 < c1));
        }
      }
      r0 = lt0 + eq0;
      r1 = lt1 + eq1;
      // ranks L-1 and L hold equal values iff the candidate of rank L has an
      // equal one before it
      const bool tie = (lane < L2 && r0 == L && eq0 > 0 && v0 < kHalfBig) ||
                       (c1 < L2 && r1 == L && eq1 > 0 && v1 < kHalfBig);
      ties += __ballot_sync(kAll, tie) != 0u;
      __syncwarp();
    };

    while (j < N) {
      const int code = tab[j];
      const int kind = (code >> 5) & 3;
      const int s = kind ? (code >> 1) & 15 : 0;
      const int t = j == 0 ? n : __ffs(j) - 1;
      second = j >= half;
      const int hiL = t < n - 2 ? t : n - 2;  // LLR stages written: s .. hiL
      // the pointer words of a path whose rows at the stages written here
      // are row v, and the partial-sum rows below s row `below`
      auto upd = [&](uint64_t& wl, uint64_t& wb, int v, int below) {
        wl = with_fields(wl, s, hiL, v);
        if (t < n) wb = with_fields(wb, t, t, v);
        wb = with_fields(wb, 0, s - 1, below);
      };

      if (t < n) {
        // A. slot t's partial sums, path k's own row
        if (t < 5) {
          uint32_t v = 0;
          if (lane < L) {
            const uint64_t pw = ptrB[lane];
            v = (ubits >> lane) & 1 ? kAll : 0u;
            for (int i = 0; i < t; ++i) {
              const uint32_t w0 = bits[field(pw, i) * W];
              v ^= ((w0 >> ((1 << i) - 1)) & ((1u << (1 << i)) - 1)) * kSpread[i];
            }
          }
          __syncwarp();
          if (lane < L) {
            const uint32_t m = (1u << (1 << t)) - 1, off = (1u << t) - 1;
            const uint32_t w0 = bits[lane * W];
            bits[lane * W] = (w0 & ~(m << off)) | ((v & m) << off);
          }
        } else {
          const int lw = t - 5, Wt = 1 << lw;
          for (int idx = lane; idx < (L << lw); idx += 32) {
            const int k = idx >> lw, q = idx & (Wt - 1);
            const uint64_t pw = ptrB[k];
            uint32_t v = (ubits >> k) & 1 ? kAll : 0u;
            for (int i = 0; i < 5; ++i) {
              const uint32_t w0 = bits[field(pw, i) * W];
              v ^= ((w0 >> ((1 << i) - 1)) & ((1u << (1 << i)) - 1)) * kSpread[i];
            }
            for (int i = 5; i < t; ++i) {
              const int b = 1 << (i - 5);
              if (!(q & b)) v ^= bits[field(pw, i) * W + b + (q & (b - 1))];
            }
            bits[k * W + Wt + q] = v;
          }
        }
        __syncwarp();
        // B. the g-node at stage t
        if (kTopRegs && t == n - 1) {
          #pragma unroll
          for (int q = 0; q < 16; ++q) {
            const int e = lane + 32 * q;
            const float up = ch[e], lo = ch[e + half];
            tr[q] = lo + 1.f * up;
            tr[16 + q] = lo + -1.f * up;
          }
        } else if (kTopRegs && t == n - 2) {
          #pragma unroll 1
          for (int k = 0; k < L; ++k) {
            const int rb = field(ptrB[k], t + 1);
            #pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int e = lane + 32 * q;
              const float up = second && bit_at(rb, n - 1, e) ? tr[16 + q] : tr[q];
              const float lo =
                  second && bit_at(rb, n - 1, e + 256) ? tr[24 + q] : tr[8 + q];
              const float sgn = bit_at(k, t, e) ? -1.f : 1.f;
              llr[k * S2 + 255 + e] = lo + sgn * up;
            }
          }
        } else if (t == n - 1) {
          for (int e = lane; e < half; e += 32) {
            const float up = ch[e], lo = ch[e + half];
            top[e] = lo + 1.f * up;
            top[half + e] = lo + -1.f * up;
          }
        } else {
          const int w = 1 << t;
          for (int idx = lane; idx < (L << t); idx += 32) {
            const int k = idx >> t, e = idx & (w - 1);
            const int rl = field(ptrL[k], t + 1), rb = field(ptrB[k], t + 1);
            const float up = src_at(rl, rb, t + 1, e);
            const float lo = src_at(rl, rb, t + 1, e + w);
            const float sgn = bit_at(k, t, e) ? -1.f : 1.f;
            llr[k * S2 + w - 1 + e] = lo + sgn * up;
          }
        }
        __syncwarp();
      }
      // f-nodes at stages t-1 .. s, each reading the path's own row
      for (int i = t - 1; i >= s; --i) {
        if (kTopRegs && i == n - 1 && s < n - 1) {
          #pragma unroll
          for (int q = 0; q < 16; ++q) {
            const int e = lane + 32 * q;
            tr[q] = chk(ch[e], ch[e + half]);
          }
        } else if (kTopRegs && i == n - 2) {
          #pragma unroll 1
          for (int k = 0; k < L; ++k) {
            #pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int e = lane + 32 * q;
              const float up = second && bit_at(k, n - 1, e) ? tr[16 + q] : tr[q];
              const float lo =
                  second && bit_at(k, n - 1, e + 256) ? tr[24 + q] : tr[8 + q];
              llr[k * S2 + 255 + e] = chk(up, lo);
            }
          }
        } else if (i == n - 1) {  // (kTopRegs: the input of a node at leaf 0)
          for (int e = lane; e < half; e += 32) top[e] = chk(ch[e], ch[e + half]);
        } else {
          const int w = 1 << i;
          for (int idx = lane; idx < (L << i); idx += 32) {
            const int k = idx >> i, e = idx & (w - 1);
            llr[k * S2 + w - 1 + e] =
                chk(src_at(k, k, i + 1, e), src_at(k, k, i + 1, e + w));
          }
        }
        __syncwarp();
      }
      if (s == n) {  // a node of width N: its input is the channel
        for (int e = lane; e < N; e += 32) top[e] = ch[e];
        __syncwarp();
      }

      // the fork of every path at bit jj on its leaf LLR leaf(p): lane c
      // forms candidate c (and c + 32) from path p = c mod L and its bit
      // c >= L, reads p's pointers, and writes them, the PM and the history
      // into slot r if its rank r < L
      auto fork = [&](auto leaf, int jj) {
        const int c1 = lane + 32, p0 = lane < L ? lane : lane - L, p1 = c1 - L;
        const bool on0 = lane < L2, on1 = c1 < L2;
        float v0 = 0.f, v1 = 0.f;
        uint64_t wl0 = 0, wb0 = 0, wl1 = 0, wb1 = 0;
        if (on0) {
          v0 = pm_s[p0] + phi(leaf(p0), lane >= L);
          wl0 = ptrL[p0];
          wb0 = ptrB[p0];
        }
        if (on1) {
          v1 = pm_s[p1] + phi(leaf(p1), true);
          wl1 = ptrL[p1];
          wb1 = ptrB[p1];
        }
        int r0, r1;
        rank(v0, v1, r0, r1);
        const bool s0 = on0 && r0 < L, s1 = on1 && r1 < L;
        const int b0 = lane >= L;
        ubits = __reduce_or_sync(kAll, (s0 && b0 ? 1u << r0 : 0u) |
                                           (s1 ? 1u << r1 : 0u));
        auto survive = [&](int r, int p, int b, float v, uint64_t wl,
                           uint64_t wb) {
          upd(wl, wb, p, L);
          pm_s[r] = v;
          ptrL[r] = wl;
          ptrB[r] = wb;
          hist[size_t(jj) * L + r] = static_cast<int8_t>((p << 1) | b);
        };
        if (s0) survive(r0, p0, b0, v0, wl0, wb0);
        if (s1) survive(r1, p1, 1, v1, wl1, wb1);
      };
      // the pointers of a step with no fork: every path keeps its rows
      auto keep = [&]() {
        if (lane < L) {
          uint64_t wl = ptrL[lane], wb = ptrB[lane];
          upd(wl, wb, lane, L);
          ptrL[lane] = wl;
          ptrB[lane] = wb;
        }
      };

      if (kind == kLeaf) {
        if (code & 1) {
          if (lane < L) {
            pm_s[lane] = pm_s[lane] + phi(src_at(lane, lane, 0, 0), false);
            hist[size_t(j) * L + lane] = static_cast<int8_t>(lane << 1);
          }
          ubits = 0;
          keep();
        } else {
          fork([&](int p) { return src_at(p, p, 0, 0); }, j);
        }
        j += 1;
      } else if (!kR1 || kind != kR1Node) {
        // R0 / REP: the all-zero-partial-sum descent in place on the node's
        // input, own row k, or once for all paths at stage n-1 (j = 0) and n
        const int w = 1 << s, cnt = kind == kRep ? w - 1 : w;
        const bool shared = s >= n - 1;
        const int P = shared ? 1 : L;  // copies of the node input
        auto A = [&](int k) -> float* {
          return shared ? top : llr + k * S2 + w - 1;
        };
        #pragma unroll 1
        for (int lv = 0; lv < s; ++lv) {
          const int lh = s - 1 - lv, h = 1 << lh;  // pairs (m, m + h)
          #pragma unroll 1
          for (int idx = lane; idx < (P << (s - 1)); idx += 32) {
            const int k = idx >> (s - 1), m = idx & ((w >> 1) - 1);
            const int i0 = ((m >> lh) << (lh + 1)) | (m & (h - 1));
            float* a = A(k);
            const float up = a[i0], dn = a[i0 + h];
            a[i0] = chk(up, dn);
            a[i0 + h] = dn + up;
          }
          __syncwarp();
        }
        // PHI(l, 0) of the frozen leaves in place, then each path's PM adds
        // them in leaf order
        #pragma unroll 1
        for (int idx = lane; idx < P * cnt; idx += 32) {
          const int k = idx / cnt, m = idx - k * cnt;
          float* a = A(k);
          a[m] = phi(a[m], false);
        }
        #pragma unroll 1
        for (int idx = lane; idx < cnt * L; idx += 32) {
          hist[size_t(j) * L + idx] = static_cast<int8_t>((idx % L) << 1);
        }
        __syncwarp();
        if (lane < L) {
          const float* a = A(lane);
          float pm = pm_s[lane];
          #pragma unroll 4
          for (int m = 0; m < cnt; ++m) pm = pm + a[m];
          pm_s[lane] = pm;
        }
        if (kind == kRep) {
          __syncwarp();
          fork([&](int p) { return A(p)[w - 1]; }, j + w - 1);
        } else {
          ubits = 0;
          keep();
        }
        j += w;
      } else {
        // R1: tt forks decide the whole block (header note, A-D)
        const int w = 1 << s, tt = L - 1 < w ? L - 1 : w;
        const int Wn = w >= 32 ? w >> 5 : 1;
        // the node input of path k: the path's own row (s <= n-2), the
        // one shared row (s = n, and s = n-1 before bit N/2), or per element
        // one of g+ and g- (s = n-1 after it)
        const bool sel = s == n - 1 && second;
        const float* abase = s >= n - 1 ? top : llr + w - 1;
        const int astride = s >= n - 1 ? 0 : S2;
        auto alpha = [&](int k, int e) -> float {
          return sel && bit_at(k, s, e) ? top[half + e] : abase[k * astride + e];
        };
        // A. each path's tt smallest |alpha| in (value, position) order, the
        // rank of every element counted over all w of its path (an early
        // exit would leave the warp waiting for its slowest lane)
        #pragma unroll 1
        for (int idx = lane; tt && idx < (L << s); idx += 32) {
          const int k = idx >> s, e = idx & (w - 1);
          const float v = fabsf(alpha(k, e));
          int r = 0;
          if (!sel) {  // a row in shared memory
            const float* a = abase + k * astride;
            #pragma unroll 4
            for (int q = 0; q < w; ++q) {
              const float x = fabsf(a[q]);
              r += (x < v) | ((x == v) & (q < e));
            }
          } else {
            #pragma unroll 1
            for (int q = 0; q < w; ++q) {
              const float x = fabsf(alpha(k, q));
              r += (x < v) | ((x == v) & (q < e));
            }
          }
          if (r < tt) {
            mins[k * tm + r] = v;
            pos[k * tm + r] = static_cast<uint16_t>(e);
          }
        }
        __syncwarp();
        // B. tt forks: candidates PM + 0 and PM + the origin's k-th minimum;
        // a survivor takes its parent's origin (og_s) and flip bits (fl_s)
        if (lane < L) {
          og_s[lane] = static_cast<uint8_t>(lane);
          fl_s[lane] = 0;
        }
        __syncwarp();
        #pragma unroll 1
        for (int kk = 0; kk < tt; ++kk) {
          const int c1 = lane + 32, p0 = lane < L ? lane : lane - L, p1 = c1 - L;
          const bool on0 = lane < L2, on1 = c1 < L2;
          float v0 = 0.f, v1 = 0.f;
          int og0 = 0, og1 = 0;
          uint32_t f0 = 0, f1 = 0;
          if (on0) {
            og0 = og_s[p0];
            f0 = fl_s[p0];
            v0 = lane < L ? pm_s[p0] + 0.f : pm_s[p0] + mins[og0 * tm + kk];
          }
          if (on1) {
            og1 = og_s[p1];
            f1 = fl_s[p1];
            v1 = pm_s[p1] + mins[og1 * tm + kk];
          }
          int r0, r1;
          rank(v0, v1, r0, r1);
          if (on0 && r0 < L) {
            pm_s[r0] = v0;
            og_s[r0] = static_cast<uint8_t>(og0);
            fl_s[r0] = f0 | (uint32_t(lane >= L) << kk);
          }
          if (on1 && r1 < L) {
            pm_s[r1] = v1;
            og_s[r1] = static_cast<uint8_t>(og1);
            fl_s[r1] = f1 | (1u << kk);
          }
          __syncwarp();
        }
        // C. x of every path, its flips applied, packed by one ballot per
        // 32 elements (a path's w < 32 bits are its lanes' segment)
        #pragma unroll 1
        for (int base = 0; base < (L << s); base += 32) {
          const int idx = base + lane, r = idx >> s, e = idx & (w - 1);
          const bool act = idx < (L << s);
          bool xb = false;
          if (act) {
            const int og = og_s[r];
            const uint32_t f = fl_s[r];
            xb = alpha(og, e) < 0.f;
            #pragma unroll 1
            for (int kk = 0; kk < tt; ++kk) {  // a path's positions differ
              xb ^= ((f >> kk) & 1) && pos[og * tm + kk] == e;
            }
          }
          const uint32_t word = __ballot_sync(kAll, xb);
          if (w >= 32) {
            if (lane == 0) X[r * xw + (e >> 5)] = word;
          } else if (act && e == 0) {
            X[r * xw] = (word >> lane) & ((1u << w) - 1);
          }
        }
        __syncwarp();
        // the bits slots below s and the last bit of path `lane`, then u
        uint32_t ub = 0;
        if (lane < L) {
          uint32_t* x = X + lane * xw;
          const int end = w >= 32 ? 32 : w;
          const uint32_t last = x[Wn - 1];
          uint32_t w0 = bits[lane * W];
          #pragma unroll 1
          for (int i = 0; i < s && i < 5; ++i) {
            const uint32_t m = (1u << (1 << i)) - 1, off = (1u << i) - 1;
            const uint32_t a = (last >> (end - (2 << i))) & m;
            const uint32_t b = (last >> (end - (1 << i))) & m;
            w0 = (w0 & ~(m << off)) | ((a ^ b) << off);
          }
          bits[lane * W] = w0;
          #pragma unroll 1
          for (int i = 5; i < s; ++i) {
            const int b = 1 << (i - 5);
            #pragma unroll 1
            for (int q = 0; q < b; ++q) {
              bits[lane * W + b + q] =
                  x[((w - (2 << i)) >> 5) + q] ^ x[((w - (1 << i)) >> 5) + q];
            }
          }
          ub = (last >> (end - 1)) & 1;
          #pragma unroll 1
          for (int q = 0; q < Wn; ++q) {
            uint32_t u = x[q];
            #pragma unroll 1
            for (int d = 0; d < 5 && (1 << d) < w; ++d) {
              u ^= (u >> (1 << d)) & kPair[d];
            }
            x[q] = u;
          }
          #pragma unroll 1
          for (int dw = 1; dw < Wn; dw <<= 1) {
            #pragma unroll 1
            for (int q = 0; q < Wn; ++q) {
              if (!(q & dw)) x[q] ^= x[q + dw];
            }
          }
        }
        ubits = __ballot_sync(kAll, ub);
        __syncwarp();
        // D. the history: the origin at leaf j, the path itself after it
        #pragma unroll 1
        for (int idx = lane; idx < w * L; idx += 32) {
          const int e = idx / L, r = idx - e * L;
          const int u = (X[r * xw + (e >> 5)] >> (e & 31)) & 1;
          const int par = e == 0 ? og_s[r] : r;
          hist[size_t(j + e) * L + r] = static_cast<int8_t>((par << 1) | u);
        }
        uint64_t wl = 0, wb = 0;
        if (lane < L) {
          const int og = og_s[lane];
          wl = ptrL[og];
          wb = ptrB[og];
          upd(wl, wb, og, lane);
        }
        __syncwarp();
        if (lane < L) {
          ptrL[lane] = wl;
          ptrB[lane] = wb;
        }
        j += w;
      }
      __syncwarp();
    }

    // Trace each final path back through the history, read into the (now
    // free) llr region, into packed bits in the bits region; then u_all.
    uint8_t* H = fm + o.llr;
    const int NL = N * L;
    if ((NL & 15) == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(hist);
      for (int i = lane; i < NL / 16; i += 32) {
        reinterpret_cast<uint4*>(H)[i] = src[i];
      }
    } else {
      for (int i = lane; i < NL; i += 32) H[i] = static_cast<uint8_t>(hist[i]);
    }
    __syncwarp();
    if (lane < L) {
      int cur = lane;
      uint32_t acc = 0;
      for (int jj = N - 1; jj >= 0; --jj) {
        const int h = H[jj * L + cur];
        acc |= uint32_t(h & 1) << (jj & 31);
        cur = h >> 1;
        if ((jj & 31) == 0) {
          bits[lane * W + (jj >> 5)] = acc;
          acc = 0;
        }
      }
      pm_out[size_t(frame) * L + lane] = pm_s[lane];
    }
    if (lane == 0) ties_out[frame] = ties;
    __syncwarp();
    int8_t* out = u_out + size_t(frame) * L * N;
    if ((N & 15) == 0) {
      const int cpr = N >> 4;  // 16-byte chunks per path
      for (int i = lane; i < L * cpr; i += 32) {
        const int k = i / cpr, c = i - k * cpr;
        const uint32_t b16 =
            (bits[k * W + (c >> 1)] >> ((c & 1) * 16)) & 0xFFFFu;
        uint4 v;
        v.x = ((b16 & 0xF) * 0x00204081u) & 0x01010101u;
        v.y = (((b16 >> 4) & 0xF) * 0x00204081u) & 0x01010101u;
        v.z = (((b16 >> 8) & 0xF) * 0x00204081u) & 0x01010101u;
        v.w = (((b16 >> 12) & 0xF) * 0x00204081u) & 0x01010101u;
        reinterpret_cast<uint4*>(out)[i] = v;
      }
    } else {
      for (int i = lane; i < L * N; i += 32) {
        const int k = i / N, jj = i - k * N;
        out[i] = static_cast<int8_t>((bits[k * W + (jj >> 5)] >> (jj & 31)) & 1);
      }
    }
    __syncwarp();
  }
}

}  // namespace

namespace {

using Kernel = void (*)(const float*, const uint8_t*, int8_t*, float*,
                        int32_t*, int, int, int, int, int);

// The instantiation for (n, L, mode): the presets' shapes N = 1024 at L = 8,
// 16 and 32 have their own, every other shape the one with n and L read at
// run time.
template <bool kR1>
Kernel kernel_of(int n, int L) {
  if (n == 10 && L == 8) return scl_decode_kernel<kR1, 10, 8>;
  if (n == 10 && L == 16) return scl_decode_kernel<kR1, 10, 16>;
  if (n == 10 && L == 32) return scl_decode_kernel<kR1, 10, 32>;
  return scl_decode_kernel<kR1, 0, 0>;
}

Kernel kernel_for(int n, int L, int r1) {
  return r1 ? kernel_of<true>(n, L) : kernel_of<false>(n, L);
}

// Whether kernel_for(n, L, r1) keeps the stage n-1 row in registers (its
// kTopRegs): the exact instantiations with n fixed at 10.
bool top_regs(int n, int L, int r1) {
  return !r1 && n == 10 && (L == 8 || L == 16 || L == 32);
}

// The launch shape at (n, L, tm, xw, mode) on the current device: frames
// per block F (the most resident frames per SM, the fewest per block on a
// tie), its blocks per SM and shared memory, cached per shape and device.
struct Shape {
  int dev, n, L, tm, xw, r1, frames, blocks_per_sm, sms;
  size_t smem;
};
Shape g_shapes[16];
int g_nshapes = 0;

cudaError_t shape_of(int n, int L, int tm, int xw, int r1, Shape* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < g_nshapes; ++i) {
    const Shape& c = g_shapes[i];
    if (c.dev == dev && c.n == n && c.L == L && c.tm == tm && c.xw == xw &&
        c.r1 == r1) {
      *out = c;
      return cudaSuccess;
    }
  }
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const Kernel kernel = kernel_for(n, L, r1);
  const size_t frame = layout(n, L, tm, xw, top_regs(n, L, r1)).total;
  const size_t tab = up16(size_t(1) << n);
  Shape best{dev, n, L, tm, xw, r1, 0, 0, sms, 0};
  for (int F = 1; F <= kMaxFrames; ++F) {
    const size_t bytes = tab + F * frame;
    if (bytes > static_cast<size_t>(optin)) break;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, 32 * F,
                                                        bytes);
    if (err != cudaSuccess) return err;
    if (nb * F > best.frames * best.blocks_per_sm) {
      best.frames = F;
      best.blocks_per_sm = nb;
      best.smem = bytes;
    }
  }
  if (best.frames == 0) return cudaErrorInvalidValue;  // one frame too big
  if (g_nshapes < 16) g_shapes[g_nshapes++] = best;
  *out = best;
  return cudaSuccess;
}

int log2_of(int N) {
  int n = 0;
  while ((1 << n) < N) ++n;
  return n;
}

bool valid(int B, int N, int L, int tmax, int xw, int r1) {
  const int n = log2_of(N);
  return B > 0 && N >= 2 && N <= 1024 && (1 << n) == N && L >= 1 && L <= 32 &&
         tmax >= 0 && tmax <= L - 1 && xw >= 0 && xw <= (N >= 32 ? N / 32 : 1) &&
         (r1 || (!tmax && !xw)) && (!r1 || xw >= 1);
}

}  // namespace

// The launch shape of B frames at (N, L) with R1 scratch for tmax forks and
// xwords packed words per node (both 0 in exact mode): threads and blocks
// of the grid, bytes of dynamic shared memory per block, frames per block
// (threads / 32) and resident blocks per SM.  Returns the cudaError_t code.
extern "C" int scl_decode_shape(int B, int N, int L, int tmax, int xwords,
                                int r1, int* threads, int* blocks,
                                size_t* smem, int* blocks_per_sm) {
  if (!valid(B, N, L, tmax, xwords, r1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh;
  const cudaError_t err = shape_of(log2_of(N), L, tmax, xwords, r1 != 0, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int want = (B + sh.frames - 1) / sh.frames;
  const int most = sh.blocks_per_sm * sh.sms;
  *threads = 32 * sh.frames;
  *blocks = want < most ? want : most;
  *smem = sh.smem;
  *blocks_per_sm = sh.blocks_per_sm;
  return 0;
}

// Bytes of shared memory one frame takes at (N, L, tmax, xwords); xwords > 0
// is the rate-1 flavor.
extern "C" size_t scl_decode_frame_bytes(int N, int L, int tmax, int xwords) {
  const int n = log2_of(N);
  return layout(n, L, tmax, xwords, top_regs(n, L, xwords > 0)).total;
}

// The instantiation that decodes (N, L, mode): its registers per thread,
// local memory per thread (non-zero when registers spill) and whether it
// keeps the stage n-1 row in registers.  Returns the cudaError_t code.
extern "C" int scl_decode_kernel_info(int N, int L, int r1, int* regs,
                                      size_t* local_bytes, int* in_regs) {
  if (!valid(1, N, L, r1 ? L - 1 : 0, r1 ? 1 : 0, r1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = log2_of(N);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(n, L, r1));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = attr.localSizeBytes;
  *in_regs = top_regs(n, L, r1);
  return 0;
}

// ch: [B, N] f32; table: [N] u8, the node table of ops/scl_kernel.py (bit 0
// frozen, bits 1-4 the stage of a node starting at that leaf, bits 5-6 its
// kind: 1 R0, 2 REP, 3 R1); u_out: [B, L, N] int8, 16-byte aligned,
// pm_out: [B, L] f32, ties_out: [B] int32, all device pointers; N a power
// of two in [2, 1024], 1 <= L <= 32; r1 non-zero when the table has R1
// nodes, then tmax = min(L - 1, width of the widest) and xwords = its
// packed words, max(1, width / 32); both 0 otherwise.  Launches on `stream`
// without synchronising; returns the cudaError_t code,
// cudaErrorInvalidValue also when a frame's shared memory exceeds what a
// block may have.
extern "C" int scl_decode_launch(const float* ch, const uint8_t* table,
                                 int8_t* u_out, float* pm_out,
                                 int32_t* ties_out, int B, int N, int L,
                                 int tmax, int xwords, int r1,
                                 cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(u_out) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  int threads = 0, blocks = 0, per_sm = 0;
  size_t smem = 0;
  const int rc = scl_decode_shape(B, N, L, tmax, xwords, r1, &threads,
                                  &blocks, &smem, &per_sm);
  if (rc != 0) return rc;
  const Kernel kernel = kernel_for(log2_of(N), L, r1);
  // the attribute is the kernel's, not the shape's: set it for this one
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(ch, table, u_out, pm_out, ties_out,
                                            B, log2_of(N), L, tmax, xwords);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scl_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
