// K1: the masked (campaign, slot) cell count, the exact-count fold's hot op.
//
//   counts[c * W + w] += #{ i : mask[i] && 0 <= campaign[i] = c < C
//                               && 0 <= slot[i] = w < W }
//
// Replaces the TPU kernel streambench_tpu/ops/pallas_count.py:count_tiles
// (body _kernel), which forms the one-hot product camp_oh^T[C,T] .
// slot_oh[T,W] per 512-row tile on the MXU.  On a GPU the same function is
// a masked histogram: integer atomics, not one-hot products.  Integer adds
// commute, so the result is bit-identical to the plain PyTorch version in
// any order.  The add is IN PLACE into the caller's counts buffer (the JAX
// kernel returned counts + delta).  Rows whose (campaign, slot) lies
// outside [0, C) x [0, W) count nowhere, as their one-hot rows are zero in
// the TPU kernel; nothing is ever written out of bounds.
//
// Shapes.  The stock catchup's 8192-event batches span more event time
// than the ring allows, so the span guard halves every batch: the main
// path launches K1 at B = 4096 rows on a C x W = 100 x 16 plane (PERF.md
// section 4).  One launch there reads 4096 x (4 + 4 + 1) B = 36 KB.  A
// full micro-batch is 8192 rows; chip_smoke.py also holds K1 at 65,536
// rows (a scan group's rows in one launch), at BASELINE #5's C = 1e6 and
// at 16.7M rows (151 MB, the bandwidth case).
//
// Design.  Every thread owns runs of 4 consecutive rows and loads a run's
// campaign and slot as 16-byte int4 vectors and its mask bytes as one
// 4-byte word, all before any branch, so one round of loads is in flight
// per run.  The rows before the first 16-byte-aligned campaign row (the
// head of a view such as packed[k]) and the ragged tail are two more units
// of at most 4 rows, read with scalar loads by the same grid-stride loop;
// an array whose alignment differs from campaign's is read with scalar
// loads throughout.  Tiers, chosen by ops/count.py:launch_plan from the
// rows and cells (thresholds measured on the card, PERF.md, PR 2):
//   - direct: fewer than 4096 + C * W rows (the main path: 4096 rows on
//     1,600 cells), one run per thread: one atomic per counted row straight
//     into counts, nothing to zero, nothing to flush;
//   - private: from 4096 + C * W rows on (scan groups, long catchups): one
//     shared-memory histogram per block, zeroed once, a grid-stride loop
//     (one run per thread up to one 1024-thread block per SM), shared
//     atomics, then one global add per nonzero cell;
//   - global: the plane does not fit a block's shared memory (C = 1e6):
//     the direct tier's code with a grid-stride loop capped at 8 blocks
//     per SM.
// No warp aggregation of equal cells (__match_any_sync): on the catchup's
// own rows 40 % of a warp's rounds of atomics repeat a cell, yet one
// atomic per row measured 0.55 us per launch faster than a probe-gated
// aggregation there (PERF.md, PR 2); only a hot cell, which no
// configuration of the repo produces, would gain.
//
// No tensor cores: the TPU's one-hot product spends B * C * W multiply-adds
// and B * C one-hot bytes of fast memory on B useful adds, and at C = 1e6
// the one-hot operand cannot be built at all.  No TMA or cp.async: a
// main-path launch reads 36 KB, which one round of 16-byte loads covers,
// and the bandwidth case (16.7M rows) reaches ~86 % of its byte bound with
// plain vector loads from 32 warps per SM, so staging has little to gain.
//
// What bounds it: at the main path's shape the byte bound is ~0.01 us, so
// the launch floor (an empty kernel, sb_empty_launch, ~0.8 us on the card)
// and the latency of one load round and one atomic round bound it, and on
// the host the wrapper's Python and ctypes cost per call.  At B = 16.7M
// rows (151 MB) bytes bound it: 0.045 ms at 3.35 TB/s.
//
// Registers (nvcc -Xptxas=-v, sm_90a, PERF.md PR 2): 30 per thread in the
// direct/global kernel, 29 in the private one, 4 in the empty one; no
// stack, no spills (chip_smoke.py prints ptxas's lines at every build).
// Built with nvcc for sm_90a and bound through ctypes (plain C entry
// points, all pointers c_void_p).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// The launch plan of ops/count.py:launch_plan, as ops/count.py:_PlanArgs
// lays it out (ctypes.Structure, same field order).
struct Plan {
  int64_t runs;             // runs of kRows rows read with vector loads
  int32_t C, W;
  int32_t private_tier;     // 0: direct or global tier, 1: private
  int32_t blocks, threads;
  int32_t head, tail;       // scalar-loaded rows before / after the runs
  int32_t vec_slot, vec_mask;
};

namespace {

constexpr int kMaxDevices = 64;
constexpr int kRows = 4;    // rows per run (ops/count.py ROWS_PER_THREAD)
constexpr int kDirectThreads = 256;
constexpr int kPrivateThreads = 1024;

// whether the private kernel may take the device's whole opt-in shared
// memory yet: cudaFuncSetAttribute runs once per device, to that maximum
std::atomic<bool> g_smem_opted_in[kMaxDevices];

// Loads rows [start, start + kRows) of p: as one int4 when `vec` (the run
// is a body run and p's run is 16-byte aligned), else as n scalar loads.
__device__ __forceinline__ void load_run(const int32_t* __restrict__ p,
                                         int64_t start, int n, bool vec,
                                         int32_t (&out)[kRows]) {
  if (vec) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p + start));
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      out[r] = r < n ? __ldg(p + start + r) : 0;
  }
}

// The run's mask bytes, byte r of the result for row r (0 past n).
__device__ __forceinline__ uint32_t load_mask(const uint8_t* __restrict__ p,
                                              int64_t start, int n,
                                              bool vec) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p + start);
  uint32_t m = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < n) m |= static_cast<uint32_t>(__ldg(p + start + r)) << (8 * r);
  return m;
}

// Units: [0, runs) are body runs of kRows rows starting at head + u * kRows
// (vector loads); then the head rows [0, head) if head > 0, then the tail
// rows [head + runs * kRows, ... + tail) if tail > 0 (scalar loads).
template <bool kPrivate>
__global__ void __launch_bounds__(kPrivate ? kPrivateThreads : kDirectThreads)
    count_cells_kernel(int32_t* __restrict__ counts,
                       const int32_t* __restrict__ campaign,
                       const int32_t* __restrict__ slot,
                       const uint8_t* __restrict__ mask, const Plan p) {
  extern __shared__ int32_t hist[];
  const int32_t cells = p.C * p.W;
  int32_t* target = counts;
  if (kPrivate) {
    for (int k = threadIdx.x; k < cells; k += blockDim.x) hist[k] = 0;
    __syncthreads();
    target = hist;
  }
  const int64_t units = p.runs + (p.head > 0) + (p.tail > 0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       u < units; u += stride) {
    const bool body = u < p.runs;
    int64_t start = p.head + u * kRows;
    int n = kRows;
    if (!body) {
      const bool is_head = p.head > 0 && u == p.runs;
      start = is_head ? 0 : p.head + p.runs * kRows;
      n = is_head ? p.head : p.tail;
    }
    int32_t c[kRows], s[kRows];
    load_run(campaign, start, n, body, c);
    load_run(slot, start, n, body && p.vec_slot, s);
    const uint32_t m = load_mask(mask, start, n, body && p.vec_mask);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (((m >> (8 * r)) & 0xff) != 0 &&
          static_cast<uint32_t>(c[r]) < static_cast<uint32_t>(p.C) &&
          static_cast<uint32_t>(s[r]) < static_cast<uint32_t>(p.W))
        atomicAdd(target + c[r] * p.W + s[r], 1);
    }
  }
  if (kPrivate) {
    __syncthreads();
    for (int k = threadIdx.x; k < cells; k += blockDim.x) {
      const int32_t v = hist[k];
      if (v) atomicAdd(&counts[k], v);
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// The device's SM count and the shared memory a block may opt in to; 0 or
// a CUDA error.  The wrapper asks once per device and caches the answer.
extern "C" int sb_device_limits(int device, int* sms, int* smem_optin) {
  cudaError_t err = cudaDeviceGetAttribute(
      sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Launches K1 on `stream` with `plan` (a Plan, host memory) and returns
// cudaGetLastError() (0 = launched).  The other pointers are device
// pointers; mask is one byte per row (torch.bool or torch.uint8).  Does not
// synchronise and allocates nothing, so a CUDA graph can capture it.
extern "C" int sb_count_cells(void* counts, const void* campaign,
                              const void* slot, const void* mask,
                              const void* plan, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(counts);
  const int32_t* camp = static_cast<const int32_t*>(campaign);
  const int32_t* sl = static_cast<const int32_t*>(slot);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  if (!p.private_tier) {
    count_cells_kernel<false><<<p.blocks, p.threads, 0, s>>>(out, camp, sl,
                                                             mk, p);
    return cudaGetLastError();
  }
  const int smem = p.C * p.W * static_cast<int>(sizeof(int32_t));
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!g_smem_opted_in[device].load()) {
      // setting the same maximum twice is harmless, so threads may race
      int optin = 0;
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(count_cells_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
      if (err != cudaSuccess) return err;
      g_smem_opted_in[device].store(true);
    }
  }
  count_cells_kernel<true><<<p.blocks, p.threads, smem, s>>>(out, camp, sl,
                                                             mk, p);
  return cudaGetLastError();
}

// An empty kernel on `stream`: the least time any launch takes, the floor
// chip_smoke.py reads K1's time at the main path's shape against.
extern "C" int sb_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
