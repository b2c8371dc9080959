// K3: the count-min sketch's hashed row update and point query.
//
//   col_d(key)    = splitmix32(uint32(key) ^ SALT[d]) & (Wd - 1)
//   update:         table[d * Wd + col_d(key_i)] += mask_i ? weight_i : 0
//                   for d < D, and total += sum_i (mask_i ? weight_i : 0)
//   query:          out_i = min_d table[d * Wd + col_d(key_i)]
//   refresh_small:  small[d * Ws + (h_d(key_i) & (Ws - 1))]
//                       = max(., min_d fat[d * Wd + col_d(key_i)])
//                   for every masked row (the two-stage sketch's second half)
//   cols:           cols[d * B + i] = col_d(key_i)   (SALSA's columns)
//   update_query:   update, then out_i = query(table, key_i) for every row
//   update2_query:  update, refresh_small, then out_i = query(small, key_i)
//
// Not a TPU kernel: the port of the XLA program that
// streambench_tpu/ops/cms.py jits out of _row_cols (:43) + update (:53),
// query (:88), update2 (:145) and query_small (:164).  The session fold
// updates and then queries the same keys for each closed set
// (streambench_tpu/engine/sketches.py:_session_cms_scan, :1083-1125, one
// XLA program there); sb_cms_update_query is that pair, and for the
// two-stage sketch that triple, in one call: the update, the refresh and
// the query launched back to back on one stream.  Every result equals the
// plain PyTorch version's (ops/cmsrows.py) bit for bit in any order:
// integer adds and maxes commute, and int32 sums wrap as XLA's do with
// x64 off.  The salts sit in constant memory; hashing is native uint32.
//
// One tier: one row a thread (the query, the refresh, the columns, and
// the update below WIDE_MIN_ROWS = 2^16 rows), integer atomics into the
// plane in device memory.  From 2^16 rows the update takes 4 rows a
// thread, keys and weights loaded 16 bytes at a time where the alignment
// allows, and adds each row's weight first into a table of 256 keys in
// the block's shared memory (a slot a key hash, taken by the first key to
// claim it with atomicCAS), flushed to the plane at the block's end: a
// hot key then reaches L2 once a block, not once a row.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, an empty kernel
// ~0.8 us, K1's sb_empty_launch): bytes, in principle:
// 1 B of mask a row, 4 B of key a row that is hashed and 4 B of weight
// an unmasked row, each distinct cell read once and each changed cell
// written once, 4 B out a queried row.  At the engine's step (D = 4, Wd = 2048, B = 8192
// rows) that is ~0.1 MB, ~0.03 us: launch latency bounds each launch
// (2-3 us, 5 us for the refresh, whose atomicMax meet on the 1,024 cells
// of a [4, 256] small stage).  At the bandwidth case (B = 2^22, D = 8,
// Wd = 2^20, a 32 MB plane) the update is bound by L2's same-address
// atomics on the hot keys of a Zipf stream (the head key is ~9.5 % of
// the rows at s = 1.1), which the hot-key table takes off L2: on one
// H100 80GB HBM3 at 700 W, chip_smoke.py phase 3 timed it at 0.21 ms
// against 0.81 ms without the table.  The threshold: at 8192 rows the
// table cost 10-20 % on near-distinct keys (the engine's closed sessions
// are interned users) and 4 rows a thread 30-60 % (8 blocks against 32);
// at 2^16 rows the table nearly halved the update's time.
//
// Measured and left out (the same phase, the same card): merging equal
// keys in the warp before the atomics (__match_any_sync, then
// __reduce_add_sync) cost ~1.5 us at the engine's step and gained
// nothing on top of the hot-key table at the bandwidth case; and a
// thread block cluster that kept the plane in shared memory (deltas in
// each CTA, the reduce over distributed shared memory, the write-back
// with plain stores, one launch for update and query) took 7.4 us of
// device time at the engine's step against 4.8 us for the two launches
// it replaced, and per eager call was within 10 % of this one call.
//
// Built with nvcc for sm_90a and bound through ctypes (plain C entry
// points, all pointers c_void_p, each returning a CUDA error, 0 =
// launched).  No entry point synchronises or allocates, so a CUDA graph
// can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDepth = 8;
constexpr int kThreads = 256;          // a block
constexpr int kHotBits = 8;            // the wide update's hot table
constexpr int kHotSlots = 1 << kHotBits;

// cms.py:_SALTS: distinct odd salts decorrelate the rows of one splitmix
// stream; depth is at most 8.
__constant__ uint32_t kSalts[kMaxDepth] = {
    0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du, 0x27D4EB2Fu,
    0x165667B1u, 0xFC545C4Fu, 0x2545F491u, 0x61C88647u};

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

// The block's masked weight (each thread's `w`), wrapping in 32 bits.
__device__ __forceinline__ uint32_t block_sum(uint32_t w,
                                              uint32_t* warp_sums) {
  w = __reduce_add_sync(0xffffffffu, w);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = w;
  __syncthreads();
  uint32_t s = 0;
  if (threadIdx.x == 0)
    for (int k = 0; k < static_cast<int>(blockDim.x + 31) / 32; ++k)
      s += warp_sums[k];
  return s;                              // thread 0's is the block's
}

struct UpdateArgs {
  int32_t* table;
  int32_t* total;
  const int32_t* keys;
  const int32_t* weights;
  const uint8_t* mask;
  int D;
  int64_t Wd;
  int64_t B;
};

// R rows a thread: rows [R * t, R * t + R) of global thread t; with R = 4
// keys and weights come 16 bytes at a time and the mask 4 (the plan takes
// R = 4 only where they are so aligned).  kHot: each row's weight first
// tries the block's table of kHotSlots keys in shared memory (a slot a key
// hash, claimed by the first key to reach it with atomicCAS), flushed to
// the plane at the block's end; a key that finds its slot taken goes to
// L2.
template <int R, bool kHot>
__global__ void __launch_bounds__(kThreads)
    cms_update_kernel(const UpdateArgs a) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  __shared__ unsigned long long hot_tag[kHot ? kHotSlots : 1];
  __shared__ uint32_t hot_sum[kHot ? kHotSlots : 1];
  if (kHot) {
    for (int j = threadIdx.x; j < kHotSlots; j += blockDim.x) {
      hot_tag[j] = 0ull;
      hot_sum[j] = 0u;
    }
    __syncthreads();
  }
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * R;
  int32_t key[R];
  uint32_t w[R];
  bool live[R];
  if (R == 4 && r0 + 4 <= a.B) {
    const int4 k4 = __ldg(reinterpret_cast<const int4*>(a.keys + r0));
    const int4 w4 = __ldg(reinterpret_cast<const int4*>(a.weights + r0));
    const uint32_t m4 =
        __ldg(reinterpret_cast<const unsigned int*>(a.mask + r0));
    const int32_t ks[4] = {k4.x, k4.y, k4.z, k4.w};
    const int32_t ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < R; ++j) {
      key[j] = ks[j];
      live[j] = (m4 >> (8 * j)) & 0xffu;
      w[j] = live[j] ? static_cast<uint32_t>(ws[j]) : 0u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t i = r0 + j;
      const bool in = i < a.B;
      key[j] = in ? __ldg(a.keys + i) : 0;
      const uint32_t wi = in ? static_cast<uint32_t>(__ldg(a.weights + i))
                             : 0u;
      live[j] = in && __ldg(a.mask + i);
      w[j] = live[j] ? wi : 0u;
    }
  }
  const uint32_t wmask = static_cast<uint32_t>(a.Wd - 1);
  uint32_t wsum = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    wsum += w[j];
    const uint32_t s = w[j];
    if (s) {
      bool held = false;
      if (kHot) {
        const uint32_t slot = row_hash(key[j], 0) >> (32 - kHotBits);
        const unsigned long long tag =
            static_cast<uint32_t>(key[j]) | 1ull << 32;
        const unsigned long long was = atomicCAS(hot_tag + slot, 0ull, tag);
        held = was == 0ull || was == tag;
        if (held) atomicAdd(hot_sum + slot, s);
      }
      if (!held)
        for (int d = 0; d < a.D; ++d)
          atomicAdd(a.table + d * a.Wd + (row_hash(key[j], d) & wmask),
                    static_cast<int32_t>(s));
    }
  }
  const uint32_t s = block_sum(wsum, warp_sums);   // a block barrier
  if (threadIdx.x == 0 && s)
    atomicAdd(reinterpret_cast<unsigned int*>(a.total), s);
  if (kHot) {
    for (int j = threadIdx.x; j < kHotSlots; j += blockDim.x) {
      const uint32_t t = hot_sum[j];
      if (t) {
        const int32_t k = static_cast<int32_t>(hot_tag[j] & 0xffffffffull);
        for (int d = 0; d < a.D; ++d)
          atomicAdd(a.table + d * a.Wd + (row_hash(k, d) & wmask),
                    static_cast<int32_t>(t));
      }
    }
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

}  // namespace

// Each entry point launches on `stream` and returns a CUDA error (0 =
// launched).  Pointers are device pointers; mask is one byte a row
// (torch.bool or torch.uint8).  blocks, threads, rows_per_thread and hot
// come from ops/cmsrows.py:launch_plan.

extern "C" int sb_cms_update(void* table, void* total, const void* keys,
                             const void* weights, const void* mask, int D,
                             int64_t Wd, int64_t B, int blocks, int threads,
                             int rows_per_thread, int hot, void* stream) {
  const UpdateArgs a{static_cast<int32_t*>(table),
                     static_cast<int32_t*>(total),
                     static_cast<const int32_t*>(keys),
                     static_cast<const int32_t*>(weights),
                     static_cast<const uint8_t*>(mask), D, Wd, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_thread == 1 && !hot)
    cms_update_kernel<1, false><<<blocks, threads, 0, s>>>(a);
  else if (rows_per_thread == 1)
    cms_update_kernel<1, true><<<blocks, threads, 0, s>>>(a);
  else if (rows_per_thread == 4 && hot)
    cms_update_kernel<4, true><<<blocks, threads, 0, s>>>(a);
  else
    return cudaErrorInvalidValue;
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

// update_query (small = NULL) and update2_query in one call: the update
// under its plan (blocks, threads, rows_per_thread, hot), then (small) the
// refresh, then the query of the plane or the small stage, one row a
// thread, back to back on `stream`; out is int32[B].
extern "C" int sb_cms_update_query(void* table, void* total,
                                   const void* keys, const void* weights,
                                   const void* mask, void* small, void* out,
                                   int D, int64_t Wd, int64_t Ws, int64_t B,
                                   int blocks, int threads,
                                   int rows_per_thread, int hot,
                                   void* stream) {
  int e = sb_cms_update(table, total, keys, weights, mask, D, Wd, B, blocks,
                        threads, rows_per_thread, hot, stream);
  if (e) return e;
  const int grid = static_cast<int>((B + kThreads - 1) / kThreads);
  if (small) {
    e = sb_cms_refresh_small(table, small, keys, mask, D, Wd, Ws, B, grid,
                             kThreads, stream);
    if (e) return e;
  }
  return sb_cms_query(small ? small : table, keys, out, D, small ? Ws : Wd,
                      B, grid, kThreads, stream);
}

