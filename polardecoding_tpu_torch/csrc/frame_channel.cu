// The frame step's threefry channel on Hopper (sm_90a): per-frame keys,
// noise words, jax.random.normal's Gaussian and the channel LLRs of the
// codewords x [B, N], in one launch.
//
// Replaces no TPU kernel: the JAX package computes this function in XLA
// (polardecoding_tpu/ops/channel.py:27 awgn_llr, :44 frame_keys, called from
// its jitted frame step).  It computes what
// polardecoding_tpu_torch/ops/channel.awgn_llr(x, frame_keys(key, fidx),
// sigma) computes, bit for bit, which is the JAX package's frame step's LLRs:
// frame b's key is threefry2x32 of the counter (0, fidx[b] mod 2^32) under
// the point key (jax.random.fold_in), element (b, j)'s word the two words of
// threefry2x32 of the counter (0, j) under that key, xored
// (jax.random.bits), then jax's uniform, XLA's erf_inv (noise.cuh),
// y = fmaf(erfinv(u), sigma * sqrt(2), 1 - 2x) with sigma * sqrt(2) one
// float32 product, and the LLR (y + y) / sigma^2, correctly rounded.  With
// `bits` [B, N] given, those words replace the threefry words.  With a
// sigma table of S entries (the fused SNR sweep, where frame i runs at
// sigmas[i mod S]), frame b's sigma is sigmas[fidx[b] mod S] and its
// sigma * sqrt(2) and sigma^2 are the same two float32 products, formed
// once a frame where the key is folded.
//
// What bounds it on this card: integer issue.  An element needs a two-word
// threefry block, about 70 integer operations, and about 70 float ones
// (the uniform, one branch of log1p and one of Giles' pair, the fma, the
// add and the divide), against 8 bytes (x in, the LLR out).  The design
// spends nothing else on integers: a block takes a tile of kElems elements
// a thread (noise.cuh's Tile, frames and lanes by shifts); a frame's key is
// folded once, by one thread of the block, into shared memory, not once an
// element; the threefry counter's first word is 0, so its first key
// injection is the key itself; N = 1024 has an instance compiled with
// constant n, where a tile is one frame, its key one shared load, and every
// address a register plus an immediate.

#include "noise.cuh"

namespace {

constexpr int kMainN = 10;  // log2 of the main path's N
constexpr int kElemsLog = 2;  // 4 elements a thread
using Tile = mc::Tile<kElemsLog>;

constexpr float kSqrt2 = 0x1.6a09e6p+0f;

// NC > 0 compiles the kernel for n = NC; NC = 0 takes n at run time.
// TABLE: each frame's sigma from the table `sigmas` of S entries (then
// `bits` is null); else the scalar `sigma` for every frame.
template <int NC, bool TABLE>
__global__ void __launch_bounds__(mc::kThreads)
frame_channel_kernel(const float* __restrict__ x,
                     const long long* __restrict__ fidx,
                     const long long* __restrict__ key,
                     const uint32_t* __restrict__ bits,
                     const float* __restrict__ sigmas, float* __restrict__ out,
                     float sigma, int S, int B, int n_arg) {
  // the tile's frame keys: one at n >= kTileLog, kTile >> n below
  constexpr int kKeys = NC >= Tile::kTileLog ? 1 : Tile::kTile >> NC;
  __shared__ uint2 keys[kKeys];
  // with a table, each frame's (sigma * sqrt(2), sigma^2)
  __shared__ float2 scales[TABLE ? kKeys : 1];
  const int n = NC > 0 ? NC : n_arg;
  const Tile tile(n, B);
  if (!bits) {  // TABLE implies no bits
    const uint32_t p0 = static_cast<uint32_t>(key[0]);
    const uint32_t p1 = static_cast<uint32_t>(key[1]);
    for (int f = threadIdx.x; f < tile.frames; f += mc::kThreads) {
      const long long i = fidx[tile.b0 + f];
      keys[f] = mc::threefry2x32(p0, p1, 0u, static_cast<uint32_t>(i));
      if (TABLE) {
        const long long r = i % S;  // the floor modulus, as torch's %
        const float s = sigmas[r < 0 ? r + S : r];
        scales[f] = make_float2(s * kSqrt2, s * s);
      }
    }
    __syncthreads();
  }
  const float s_sqrt2 = sigma * kSqrt2;
  const float s2 = sigma * sigma;
#pragma unroll
  for (int k = 0; k < Tile::kElems; ++k) {
    const int i = k * mc::kThreads + static_cast<int>(threadIdx.x);
    const int f = tile.frame(i);
    if (f >= tile.frames) break;
    const int lane = tile.lane(i);
    const size_t e = (static_cast<size_t>(tile.b0 + f) << n) + lane;
    uint32_t w;
    if (bits) {
      w = bits[e];
    } else {
      const uint2 kf = keys[f];
      const uint2 z = mc::threefry2x32(kf.x, kf.y, 0u,
                                       static_cast<uint32_t>(lane));
      w = z.x ^ z.y;
    }
    const float2 sc = TABLE ? scales[f] : make_float2(s_sqrt2, s2);
    const float y = fmaf(mc::erfinv_jax(mc::uniform_jax(w)), sc.x,
                         1.0f - 2.0f * x[e]);
    out[e] = __fdiv_rn(y + y, sc.y);
  }
}

using Kernel = void (*)(const float*, const long long*, const long long*,
                        const uint32_t*, const float*, float*, float, int, int,
                        int);

Kernel kernel_for(int n, bool table) {
  if (table)
    return n == kMainN ? frame_channel_kernel<kMainN, true>
                       : frame_channel_kernel<0, true>;
  return n == kMainN ? frame_channel_kernel<kMainN, false>
                     : frame_channel_kernel<0, false>;
}

}  // namespace

// x: [B, N] f32 0/1 with N = 2^n, fidx: [B] int64 frame indices (the low 32
// bits are folded in), key: [2] int64, the point key's two words, bits:
// [B, N] 32-bit words or null (threefry words under each frame's key; with
// bits, fidx and key are not read), sigmas: [S] f32 or null (then every
// frame takes `sigma`; with sigmas, bits must be null), out: [B, N] f32.
// Launches on `stream` without synchronising; returns the cudaError_t code.
extern "C" int frame_channel_launch(const float* x, const long long* fidx,
                                    const long long* key, const uint32_t* bits,
                                    const float* sigmas, float* out,
                                    float sigma, int S, int B, int n,
                                    cudaStream_t stream) {
  if (B <= 0 || n < 0 || n > 30 || (sigmas && (bits || S <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = Tile::blocks(B, n);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  kernel_for(n, sigmas != nullptr)<<<static_cast<unsigned>(blocks),
                                     mc::kThreads, 0, stream>>>(
      x, fidx, key, bits, sigmas, out, sigma, S, B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* frame_channel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
