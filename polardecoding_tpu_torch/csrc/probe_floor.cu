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
// Design: one block per frame with the thread count and the dynamic shared
// memory the wrapper takes from scl_decode (32 L threads in [64, 512],
// scl_decode_smem_bytes(N, L, 0) bytes), and per switch:
//   init    zero-fills all of that shared memory, as the TPU probe's "init"
//           zero-fills its VMEM scratch;
//   dma_in  copies the frame's LLR row (and the per-leaf table when given)
//           into the first 5N bytes of shared memory, as the TPU pipeline
//           copies the input block into VMEM; without it ("no_in") the LLRs
//           are never read;
//   U       int8 or int32 decisions, u_rows (N or 1) per path;
//   ties    written when the pointer is not null (three outputs, row 9).
// The outputs are written as scl_decode writes them, consecutive threads on
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
                   int N, int L, int u_rows, int smem_bytes, int init,
                   int dma_in) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t frame = blockIdx.x;
  if (init) {
    uint4* sm4 = reinterpret_cast<uint4*>(sm);
    const int n16 = smem_bytes / 16;
    for (int i = tid; i < n16; i += T) sm4[i] = make_uint4(0, 0, 0, 0);
    for (int i = 16 * n16 + tid; i < smem_bytes; i += T) sm[i] = 0;
    __syncthreads();
  }
  if (dma_in) {
    float* row = reinterpret_cast<float*>(sm);
    const float* src = ch + frame * N;
    for (int i = tid; i < N; i += T) row[i] = src[i];
    if (leaf != nullptr) {
      for (int i = tid; i < N; i += T) sm[4 * N + i] = leaf[i];
    }
    __syncthreads();
  }
  U* u = u_out + frame * L * u_rows;
  for (int i = tid; i < L * u_rows; i += T) u[i] = 0;
  for (int k = tid; k < L; k += T) pm_out[frame * L + k] = 0.f;
  if (ties_out != nullptr && tid == 0) ties_out[frame] = 0;
}

template <typename U>
cudaError_t launch(const float* ch, const uint8_t* leaf, void* u_out,
                   float* pm_out, int32_t* ties_out, int B, int N, int L,
                   int u_rows, int threads, int smem_bytes, int init,
                   int dma_in, cudaStream_t stream) {
  auto kernel = probe_floor_kernel<U>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem_bytes, stream>>>(
      ch, leaf, static_cast<U*>(u_out), pm_out, ties_out, N, L, u_rows,
      smem_bytes, init, dma_in);
  return cudaGetLastError();
}

}  // namespace

// ch: [B, N] f32 (read only with dma_in); leaf: [N] u8 or null; u_out:
// [B, L, u_rows] int8 (u_i32 = 0) or int32; pm_out: [B, L] f32; ties_out:
// [B] int32 or null; all device pointers.  threads in [1, 512]; smem_bytes
// of dynamic shared memory, at least 4N (+ N with a table) with dma_in.
// Launches on `stream` without synchronising; returns the cudaError_t code,
// cudaErrorInvalidValue also when the shared memory exceeds what the device
// allows.
extern "C" int probe_floor_launch(const float* ch, const uint8_t* leaf,
                                  void* u_out, float* pm_out,
                                  int32_t* ties_out, int B, int N, int L,
                                  int u_rows, int u_i32, int threads,
                                  int smem_bytes, int init, int dma_in,
                                  cudaStream_t stream) {
  const int row_bytes = 4 * N + (leaf != nullptr ? N : 0);
  if (B <= 0 || N <= 0 || L <= 0 || u_rows <= 0 || threads <= 0 ||
      threads > kMaxThreads || smem_bytes < 0 ||
      (dma_in && smem_bytes < row_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = u_i32 ? launch<int32_t>(ch, leaf, u_out, pm_out, ties_out, B, N, L,
                                u_rows, threads, smem_bytes, init, dma_in,
                                stream)
              : launch<int8_t>(ch, leaf, u_out, pm_out, ties_out, B, N, L,
                               u_rows, threads, smem_bytes, init, dma_in,
                               stream);
  return static_cast<int>(err);
}

extern "C" const char* probe_floor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
