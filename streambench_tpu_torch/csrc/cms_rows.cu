// K3: the count-min sketch's hashed row update and point query.
//
//   col_d(key)   = splitmix32(uint32(key) ^ SALT[d]) & (Wd - 1)
//   update:        table[d * Wd + col_d(key_i)] += mask_i ? weight_i : 0
//                  for d < D, and total += sum_i (mask_i ? weight_i : 0)
//   query:         out_i = min_d table[d * Wd + col_d(key_i)]
//   refresh_small: small[d * Ws + (h_d(key_i) & (Ws - 1))]
//                      = max(., min_d fat[d * Wd + col_d(key_i)])
//                  for every masked row (the two-stage sketch's second half)
//   cols:          cols[d * B + i] = col_d(key_i)   (SALSA's columns)
//
// Not a TPU kernel: the port of the XLA program that
// streambench_tpu/ops/cms.py jits out of _row_cols + update / query /
// update2's small-stage refresh (cms.py:43-93, :145-170).  As eager torch
// ops the D salted hashes alone are D x 13 launches a call (splitmix32 in
// int64, ops/hll.py), ~80 launches an update and ~70 a query, several
// hundred a session batch; here each is one launch, hashing in native
// uint32 (wrapping as XLA's uint32 does).
//
// Design: one thread per row, 256-thread blocks (ops/cmsrows.py:
// launch_plan).  A row hashes its key D times and adds with integer
// atomics (atomicAdd, atomicMax), so the result equals the plain PyTorch
// version's exactly in any order; int32 sums wrap as XLA's do with x64
// off.  The batch's masked weight is reduced in the block (warp shuffles,
// then one shared slot a warp) and added to `total` with one atomicAdd a
// block.  All updates are IN PLACE into the caller's table, total and
// small plane; refresh_small launches after update on the same stream, so
// it reads the updated fat plane.  The salts sit in constant memory.
//
// What bounds it: bytes, in principle: 1 B of mask a row, and 8 B of key
// and weight only for an unmasked row (a masked row reads its mask and
// stops), plus 8 B a cell an unmasked row touches for the update (read
// and written once) and 4 B a gathered cell for the query, at 3.35 TB/s.
// At the engine's step (D = 4, Wd = 2048, B = 8192 rows, a third masked)
// that is ~0.1 MB, 0.03 us, so the launch
// floor (an empty kernel, ~0.8 us on the card, K1's sb_empty_launch) is
// the real bound; chip_smoke.py also holds a bandwidth case (B = 2^22, D
// = 8, Wd = 2^20).  No shared-memory staging of the plane: a step touches
// at most D * B cells of a plane that L2 holds whole.
//
// Built with nvcc for sm_90a and bound through ctypes (plain C entry
// points, all pointers c_void_p, each returning cudaGetLastError()).  No
// entry point synchronises or allocates, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

// cms.py:_SALTS: distinct odd salts decorrelate the rows of one splitmix
// stream; depth is at most 8.
__constant__ uint32_t kSalts[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0xFC545C4Fu,
                                   0x2545F491u, 0x61C88647u};

// ops/hll.py:splitmix32, the 32-bit splitmix finalizer, in uint32.
__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x21F0AAADu;
  x = (x ^ (x >> 15)) * 0x735A2D97u;
  return x ^ (x >> 15);
}

__device__ __forceinline__ uint32_t row_hash(int32_t key, int d) {
  return splitmix32(static_cast<uint32_t>(key) ^ kSalts[d]);
}

__device__ __forceinline__ int32_t point_min(const int32_t* table,
                                             int32_t key, int D,
                                             uint32_t width_mask,
                                             int64_t width) {
  int32_t est = INT32_MAX;
  for (int d = 0; d < D; ++d) {
    const int64_t cell = d * width + (row_hash(key, d) & width_mask);
    est = min(est, table[cell]);
  }
  return est;
}

__global__ void cms_update_kernel(int32_t* __restrict__ table,
                                  int32_t* __restrict__ total,
                                  const int32_t* __restrict__ keys,
                                  const int32_t* __restrict__ weights,
                                  const uint8_t* __restrict__ mask, int D,
                                  int64_t Wd, int64_t B) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  uint32_t w = 0;
  if (i < B && __ldg(mask + i)) {
    const int32_t key = __ldg(keys + i);
    w = static_cast<uint32_t>(__ldg(weights + i));
    const uint32_t wmask = static_cast<uint32_t>(Wd - 1);
    for (int d = 0; d < D; ++d)
      atomicAdd(table + d * Wd + (row_hash(key, d) & wmask),
                static_cast<int32_t>(w));
  }
  // the block's masked weight, wrapping in 32 bits like the plane
  for (int off = 16; off > 0; off >>= 1)
    w += __shfl_down_sync(0xffffffffu, w, off);
  __shared__ uint32_t warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
    for (int k = 0; k < (blockDim.x + 31) / 32; ++k) s += warp_sums[k];
    if (s) atomicAdd(reinterpret_cast<unsigned int*>(total), s);
  }
}

__global__ void cms_query_kernel(const int32_t* __restrict__ table,
                                 const int32_t* __restrict__ keys,
                                 int32_t* __restrict__ out, int D,
                                 int64_t Wd, int64_t B) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= B) return;
  out[i] = point_min(table, __ldg(keys + i), D,
                     static_cast<uint32_t>(Wd - 1), Wd);
}

__global__ void cms_refresh_small_kernel(const int32_t* __restrict__ fat,
                                         int32_t* __restrict__ small,
                                         const int32_t* __restrict__ keys,
                                         const uint8_t* __restrict__ mask,
                                         int D, int64_t Wd, int64_t Ws,
                                         int64_t B) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= B || !__ldg(mask + i)) return;
  const int32_t key = __ldg(keys + i);
  const int32_t est = point_min(fat, key, D,
                                static_cast<uint32_t>(Wd - 1), Wd);
  const uint32_t smask = static_cast<uint32_t>(Ws - 1);
  for (int d = 0; d < D; ++d)
    atomicMax(small + d * Ws + (row_hash(key, d) & smask), est);
}

__global__ void cms_cols_kernel(const int32_t* __restrict__ keys,
                                int32_t* __restrict__ cols, int D,
                                int64_t Wd, int64_t B) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= B) return;
  const int32_t key = __ldg(keys + i);
  const uint32_t wmask = static_cast<uint32_t>(Wd - 1);
  for (int d = 0; d < D; ++d)
    cols[d * B + i] = static_cast<int32_t>(row_hash(key, d) & wmask);
}

// Each entry point launches one kernel of `blocks` x `threads`
// (ops/cmsrows.py:launch_plan) on `stream` and returns cudaGetLastError()
// (0 = launched).  Pointers are device pointers; mask is one byte a row
// (torch.bool or torch.uint8).

extern "C" int sb_cms_update(void* table, void* total, const void* keys,
                             const void* weights, const void* mask, int D,
                             int64_t Wd, int64_t B, int blocks, int threads,
                             void* stream) {
  cms_update_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(table), static_cast<int32_t*>(total),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(weights),
      static_cast<const uint8_t*>(mask), D, Wd, B);
  return cudaGetLastError();
}

extern "C" int sb_cms_query(const void* table, const void* keys, void* out,
                            int D, int64_t Wd, int64_t B, int blocks,
                            int threads, void* stream) {
  cms_query_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(keys),
      static_cast<int32_t*>(out), D, Wd, B);
  return cudaGetLastError();
}

extern "C" int sb_cms_refresh_small(const void* fat, void* small,
                                    const void* keys, const void* mask, int D,
                                    int64_t Wd, int64_t Ws, int64_t B,
                                    int blocks, int threads, void* stream) {
  cms_refresh_small_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fat), static_cast<int32_t*>(small),
      static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(mask), D,
      Wd, Ws, B);
  return cudaGetLastError();
}

extern "C" int sb_cms_cols(const void* keys, void* cols, int D, int64_t Wd,
                           int64_t B, int blocks, int threads, void* stream) {
  cms_cols_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(cols), D, Wd,
      B);
  return cudaGetLastError();
}
