// Masked (campaign, slot) cell count: the exact-count fold's hot op.
//
//   counts[c * W + w] += #{ i : mask[i] && campaign[i] == c && slot[i] == w }
//
// Replaces the TPU kernel streambench_tpu/ops/pallas_count.py:count_tiles
// (body _kernel), which forms the one-hot product camp_oh^T[C,T] .
// slot_oh[T,W] per 512-row tile on the MXU.  On a GPU the same function is
// a masked histogram, so this kernel scatters with integer atomics instead
// of multiplying one-hots.  Integer adds commute, so the result is
// bit-identical to the plain PyTorch version in any order.
//
// Unlike the JAX kernel, which returned counts + delta, this one adds IN
// PLACE into the caller's counts buffer (the window state's counts tensor).
//
// Rows whose (campaign, slot) lies outside [0, C) x [0, W) count nowhere,
// as their one-hot rows are zero in the TPU kernel; nothing is ever written
// out of bounds.
//
// What bounds it: at the main path's shape (B = 8192 rows, C = 100, W = 16)
// the kernel reads 8192 x (4 + 4 + 1) B ~ 74 KB plus at most 1600 cells of
// read-modify-write, well under a microsecond of HBM time at 3.35 TB/s, so
// it is bound by launch latency, not bytes.  Two paths:
//   - shared memory, while C * W * 4 bytes fit a block's dynamic shared
//     memory: each block zeroes a private histogram, walks a grid-stride
//     range of rows with shared-memory atomics, then adds its nonzero cells
//     to global memory;
//   - global, otherwise (e.g. C = 1e6): atomics straight into counts.
// Built with nvcc for sm_90a and bound through ctypes (plain C entry).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ bool cell_of(const int32_t* campaign,
                                        const int32_t* slot,
                                        const uint8_t* mask, int64_t i,
                                        int64_t C, int64_t W,
                                        int64_t* cell) {
  if (!mask[i]) return false;
  const int64_t c = campaign[i];
  const int64_t w = slot[i];
  if (c < 0 || c >= C || w < 0 || w >= W) return false;
  *cell = c * W + w;
  return true;
}

__global__ void count_cells_shared(int32_t* __restrict__ counts,
                                   const int32_t* __restrict__ campaign,
                                   const int32_t* __restrict__ slot,
                                   const uint8_t* __restrict__ mask,
                                   int64_t n, int64_t C, int64_t W) {
  extern __shared__ int32_t hist[];
  const int cells = static_cast<int>(C * W);
  for (int k = threadIdx.x; k < cells; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int64_t cell;
    if (cell_of(campaign, slot, mask, i, C, W, &cell))
      atomicAdd(&hist[cell], 1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const int32_t v = hist[k];
    if (v) atomicAdd(&counts[k], v);
  }
}

__global__ void count_cells_global(int32_t* __restrict__ counts,
                                   const int32_t* __restrict__ campaign,
                                   const int32_t* __restrict__ slot,
                                   const uint8_t* __restrict__ mask,
                                   int64_t n, int64_t C, int64_t W) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int64_t cell;
    if (cell_of(campaign, slot, mask, i, C, W, &cell))
      atomicAdd(&counts[cell], 1);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// All pointers are device pointers; mask is one byte per row (torch.bool
// or torch.uint8).  Does not synchronise and allocates nothing.
extern "C" int sb_count_cells(void* counts, const void* campaign,
                              const void* slot, const void* mask,
                              int64_t n, int64_t C, int64_t W,
                              void* stream) {
  if (n <= 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = 0, smem_optin = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&smem_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(counts);
  const int32_t* camp = static_cast<const int32_t*>(campaign);
  const int32_t* sl = static_cast<const int32_t*>(slot);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const int64_t cells = C * W;
  const int64_t smem = cells * static_cast<int64_t>(sizeof(int32_t));
  const int64_t want =
      (n + kThreads * kRowsPerThread - 1) / (kThreads * kRowsPerThread);
  if (smem <= smem_optin) {
    // each block flushes all of its cells, so keep the block count near
    // one per SM: more blocks would only add flush traffic
    const int blocks = static_cast<int>(want < sms ? want : sms);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(count_cells_shared,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    count_cells_shared<<<blocks, kThreads, static_cast<size_t>(smem), s>>>(
        out, camp, sl, mk, n, C, W);
  } else {
    const int64_t cap = static_cast<int64_t>(sms) * 8;
    const int blocks = static_cast<int>(want < cap ? want : cap);
    count_cells_global<<<blocks, kThreads, 0, s>>>(out, camp, sl, mk, n, C,
                                                   W);
  }
  return cudaGetLastError();
}
