// The floor under the SCL list-decode kernel on Hopper (sm_90a): a kernel
// with csrc/scl_decode.cu's launch shape and outputs that decodes nothing.
//
// Replaces the three TPU floor probes, whose bodies are variants of one
// empty body: scripts/probe_floor.py:77 (make(init) / _body, variants bare
// and init), scripts/probe_floor2.py:63 (make(B, scratch, u_rows, u_dtype,
// dma_in): bare, C16, C4, noscratch, no_u, u_i32, no_in) and
// scripts/probe_floor3.py:40 (bare_call: grid sizes, back-to-back calls).
// It computes what polardecoding_tpu_torch/ops/probe_kernel.floor_plain
// computes: constant outputs.
//
// Design: csrc/scl_decode.cu's launch shape, which the wrapper takes from
// scl_decode_shape: F frames per block, one warp each, the warps striding
// over the frames from blockIdx.x * F + warp by gridDim.x * F; the block's
// dynamic shared memory holds the per-leaf table once (when given) and F
// frame regions of frame_bytes (scl_decode_frame_bytes), and per switch:
//   init    zero-fills the frame's region before each frame, as the TPU
//           probe's "init" zero-fills its VMEM scratch;
//   dma_in  copies the per-leaf table into the block's shared memory once
//           and the frame's LLR row into the first 4N bytes of its region,
//           as the TPU pipeline copies the input block into VMEM; without
//           it ("no_in") the LLRs are never read;
//   U       int8 or int32 decisions, u_rows (N or 1) per path;
//   ties    written when the pointer is not null (three outputs, row 9).
// The outputs are written as scl_decode writes them, consecutive lanes on
// consecutive elements: u [B, L, u_rows] = 0, pm [B, L] = 0, ties [B] = 0.
// Stores to dynamic shared memory are kept by the compiler: the array is an
// external object, so no store to it is dead.
//
// What bounds it on this card: bytes and the launch.  At B = 16384, L = 8,
// N = 1024 it reads 64 MiB of LLRs and writes 128 MiB of int8 decisions,
// 60 us at 3.35 TB/s; the zero-fill stays on the chip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

template <typename U>
__global__ void __launch_bounds__(kMaxThreads)
probe_floor_kernel(const float* __restrict__ ch,
                   const uint8_t* __restrict__ leaf, U* __restrict__ u_out,
                   float* __restrict__ pm_out, int32_t* __restrict__ ties_out,
                   int B, int N, int L, int u_rows, int frame_bytes, int init,
                   int dma_in) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int F = blockDim.x >> 5;
  const int tab = leaf != nullptr && dma_in ? (N + 15) & ~15 : 0;
  if (tab) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) sm[i] = leaf[i];
    __syncthreads();
  }
  uint8_t* region = sm + tab + warp * frame_bytes;
  for (int frame = blockIdx.x * F + warp; frame < B; frame += gridDim.x * F) {
    if (init) {
      uint4* r4 = reinterpret_cast<uint4*>(region);
      const int n16 = frame_bytes / 16;
      for (int i = lane; i < n16; i += 32) r4[i] = make_uint4(0, 0, 0, 0);
      for (int i = 16 * n16 + lane; i < frame_bytes; i += 32) region[i] = 0;
      __syncwarp();
    }
    if (dma_in) {
      float* row = reinterpret_cast<float*>(region);
      const float* src = ch + static_cast<size_t>(frame) * N;
      for (int i = lane; i < N; i += 32) row[i] = src[i];
      __syncwarp();
    }
    U* u = u_out + static_cast<size_t>(frame) * L * u_rows;
    for (int i = lane; i < L * u_rows; i += 32) u[i] = 0;
    for (int k = lane; k < L; k += 32) pm_out[size_t(frame) * L + k] = 0.f;
    if (ties_out != nullptr && lane == 0) ties_out[frame] = 0;
    __syncwarp();
  }
}

template <typename U>
cudaError_t launch(const float* ch, const uint8_t* leaf, void* u_out,
                   float* pm_out, int32_t* ties_out, int B, int N, int L,
                   int u_rows, int threads, int blocks, int frame_bytes,
                   int smem_bytes, int init, int dma_in, cudaStream_t stream) {
  auto kernel = probe_floor_kernel<U>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem_bytes, stream>>>(
      ch, leaf, static_cast<U*>(u_out), pm_out, ties_out, B, N, L, u_rows,
      frame_bytes, init, dma_in);
  return cudaGetLastError();
}

}  // namespace

// ch: [B, N] f32 (read only with dma_in); leaf: [N] u8 or null; u_out:
// [B, L, u_rows] int8 (u_i32 = 0) or int32; pm_out: [B, L] f32; ties_out:
// [B] int32 or null; all device pointers.  threads a multiple of 32 in
// [32, 512] (one warp a frame), blocks >= 1, frame_bytes of shared memory
// per frame (a multiple of 16, at least 4N with dma_in).  Launches on
// `stream` without synchronising; returns the cudaError_t code,
// cudaErrorInvalidValue also when the shared memory exceeds what the device
// allows.
extern "C" int probe_floor_launch(const float* ch, const uint8_t* leaf,
                                  void* u_out, float* pm_out,
                                  int32_t* ties_out, int B, int N, int L,
                                  int u_rows, int u_i32, int threads,
                                  int blocks, int frame_bytes, int init,
                                  int dma_in, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || L <= 0 || u_rows <= 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 || blocks <= 0 ||
      frame_bytes < 0 || frame_bytes % 16 || (dma_in && frame_bytes < 4 * N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tab = leaf != nullptr && dma_in ? (N + 15) & ~15 : 0;
  const long long smem = tab + static_cast<long long>(threads / 32) * frame_bytes;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(smem);
  err = u_i32 ? launch<int32_t>(ch, leaf, u_out, pm_out, ties_out, B, N, L,
                                u_rows, threads, blocks, frame_bytes, bytes,
                                init, dma_in, stream)
              : launch<int8_t>(ch, leaf, u_out, pm_out, ties_out, B, N, L,
                               u_rows, threads, blocks, frame_bytes, bytes,
                               init, dma_in, stream);
  return static_cast<int>(err);
}

extern "C" const char* probe_floor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
