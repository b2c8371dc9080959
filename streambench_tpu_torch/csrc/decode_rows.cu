// K2: device decode of raw journal rows, bytes -> (campaign, is_view, rel, valid).
//
// For every row r with lens[r] > 0, starting at byte s = starts[r] of buf
// and ending (exclusive) at e = s + lens[r]:
//   - h = FNV-1a 32-bit over the 36 ad-id bytes buf[s + 113 .. s + 149);
//   - campaign = vals[slot] of the first slot (h + p) & (T - 1), p < probes,
//     whose 36-byte key equals the ad bytes; -1 when none does;
//   - is_view = buf[e - 62 .. e - 58) == "view";
//   - the 13 digits buf[e - 40 .. e - 27) as t = hi * 10^9 + lo (hi the first
//     4, lo the last 9), rel = (hi - base_hi) * 10^9 + (lo - base_lo)
//     narrowed to int32;
//   - valid = 1.
// Rows with lens[r] == 0 (pad rows) get campaign -1, is_view 0, rel 0,
// valid 0.
//
// Replaces no Pallas kernel: it is the port of an XLA fusion, the decode
// half of the reference's jitted step, streambench_tpu/ops/devdecode.py:
// _decode_columns (inside decode_fold_scan).  Written as eager torch ops
// that fusion is ~36 hash steps x 3 ops, the probe loop and 13 digit steps,
// on the order of 150 launches per row group; here it is one launch per
// dispatch, over all of its [kp, B] rows.
//
// Exactness.  The hash is uint32 arithmetic, which wraps as the
// reference's uint32 jnp ops do.  The time arithmetic is done in uint32 as
// well and reinterpreted as int32 at the end: +, - and * are ring
// operations mod 2^32, so the result equals the reference's int32 ops,
// which wrap at every step, without signed overflow (undefined in C++).
// A byte index is read as JAX's gather reads it: a negative index counts
// from the end of the buffer, then it is clamped into [0, cap).
//
// What bounds it.  Its bytes, each input read once: the join table's
// slots that this run's probes reach (36 B of key and 4 B of value a slot,
// each distinct slot once: a row's chain up to its match or the first
// unused slot), a pad row's length (4 B), a real row's (start, len) (8 B),
// 36 B of ad id, 4 B of event type and 13 B of digits, and 4 + 1 + 4 + 1 =
// 10 B written a row (chip_smoke.py:_decode_bytes counts them).  At the
// stock catchup's dispatch (4096 real rows in one 8192-row group) that
// bound lies below the launch floor (an empty kernel, ~0.0008 ms): at
// that shape the latency of one row's chain of dependent steps bounds it.
// A [64, 8192] dispatch (~37 MB of function bytes) is bound by bytes.
//
// Design (ops/decode.py:decode_plan chooses the tier, the block size and
// the grid; the kernel follows the plan it is given):
//   1. The slot table, staged.  Next to keys/vals the host builds, once
//      per table, a 32-bit tag per slot (FNV-1a of its key), vals and a
//      used bit per slot (the slots build_ad_table filled), packed into one
//      16-byte-padded array (ops/decode.py:slot_meta).  In the smem tier
//      each block that holds a real row copies that array into shared
//      memory with one cp.async.bulk (1-D TMA) completed on an mbarrier,
//      and issues its row loads while the copy is in flight.  A probe
//      compares the row's hash with the slot's tag in shared memory, the
//      tags and used bits of 4 slots loaded at once; only the first tag
//      match leaves the search, and the warp's threads then verify their
//      candidates' keys together, as nine 4-byte global loads each, in one
//      round (a verify inside the search would cost the warp one round per
//      distinct match depth among its rows).  A tag that matches another
//      key sends its thread back to the search.  A table whose array does
//      not fit the 48 KB a block takes without opting in (more than 4,096
//      slots, so more than 2,048 ads) runs the global tier: the same code,
//      tags, vals and used bits read from global memory (L2).
//   2. Stop at the first unused slot.  build_ad_table inserts by linear
//      probing and never deletes, and equal bytes hash equally, so a key
//      equal to the row's ad lies before any unused slot on the row's
//      chain: a probe that reaches an unused slot returns -1.  An all-zero
//      ad equals an unused slot's zero key and gets its -1 either way.
//      probes stays the loop's bound.  An unknown ad now stops at the
//      first hole, not after every probe.
//   3. 16-byte row loads.  The ad span [s+113, s+149) covers 3 or 4
//      aligned 16-byte chunks, the event type [e-62, e-58) 1 or 2 and the
//      digits [e-40, e-27) 1 or 2 (the literal between them is not read):
//      ~6 LDG.128 a row, all issued before any use, in place of 53 byte
//      loads ~260 B apart; funnel shifts move the bytes into place in
//      registers.  This path needs buf's base 16-byte aligned (the plan's
//      `vector`) and both spans inside [0, cap & ~15); any other row, or
//      any other buffer, reads its bytes one at a time under the gather
//      rule, in this same kernel.
//   4. A grid for 132 SMs: one row a thread, in 64-thread blocks for a
//      dispatch of up to 16,896 rows, so the main dispatch's 4,096 real
//      rows run in 64 blocks on 64 SMs (256-thread blocks would put them
//      on 16), and in 256-thread blocks past that (chip_decode_probe.py
//      sweeps these choices).  A pad row writes its fixed values, and a
//      block of pad rows copies nothing.
//
// Measured (chip_smoke.py's K2 cases, one H100 80GB HBM3 at 700 W; the
// final run's numbers are in PERF.md section 6): 0.0034 ms at the main
// dispatch, ~4x an empty kernel's 0.0008 ms, against 0.0099 ms for the
// one-thread-per-row byte-load kernel this design replaced; what remains
// is one chain of dependent steps per row ((start, len), then the row's
// chunks, the 36-step hash, the tag search, one verify round, the
// stores).  0.046 ms at [64, 8192]: 0.24 of the byte bound, and 0.52 of
// the bound its spans' 32-byte sectors give (79 MB: the card cannot fetch
// the 53 bytes a row needs without the sectors around them).  48
// registers in either tier, no spills.
//
// Built with nvcc for sm_90a (-Xptxas -v prints registers and spills) and
// bound through ctypes (plain C entry point, all pointers c_void_p).

#include <cuda_runtime.h>
#include <stdint.h>

// The launch plan of ops/decode.py:decode_plan, as ops/decode.py:_PlanArgs
// lays it out (ctypes.Structure, same field order).
struct Plan {
  int32_t smem_tier;        // 1: the slot table staged in shared memory
  int32_t threads, blocks;
  int32_t smem_bytes;       // the staged table's bytes (0 in the global tier)
  int32_t vector;           // buf is 16-byte aligned: 16-byte row loads
};

namespace {

constexpr int kUuidLen = 36;
constexpr int kAdWords = kUuidLen / 4;
constexpr int kAdOff = 113;
constexpr int kVtOff = 62;        // end-relative start of the event type's
                                  // last 4 bytes ("view")
constexpr int kDigOff = 40;       // end-relative start of the 13 digits
constexpr int kSufOff = 27;       // end-relative end of the digits
constexpr int kTimeDigits = 13;
constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kView = 0x77656976u;   // "view", little-endian
constexpr int kMaxThreads = 256;
constexpr int kBatch = 4;         // probes whose tags are loaded together

struct Args {
  const uint8_t* buf;
  int64_t cap;
  const int32_t* starts;
  const int32_t* lens;
  int64_t rows;
  const uint8_t* keys;
  const uint32_t* meta;     // tags [tp], vals [tp], used bits [up] words
  int32_t table, probes, base_hi, base_lo;
  int32_t* campaign;
  uint8_t* is_view;
  int32_t* rel;
  uint8_t* valid;
  int32_t smem_bytes, vector;
};

// buf[i] with JAX's gather rule: negative i counts from the end, then
// clamp into [0, cap).
__device__ __forceinline__ uint32_t load_byte(const uint8_t* __restrict__ buf,
                                              int64_t cap, int64_t i) {
  if (i < 0) i += cap;
  i = i < 0 ? 0 : (i >= cap ? cap - 1 : i);
  return buf[i];
}

// kWords little-endian words of buf[at, at + 4 * kWords) by the gather
// rule, one byte at a time; bytes at or past `n` are left 0.
template <int kWords>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ buf,
                                           int64_t cap, int64_t at, int n,
                                           uint32_t (&out)[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * k + b < n) w |= load_byte(buf, cap, at + 4 * k + b) << (8 * b);
    out[k] = w;
  }
}

// kWords little-endian words of buf[at, at + n) from the 16-byte chunks
// that hold them (at >= 0, at + n <= cap & ~15, buf 16-byte aligned): the
// chunks are loaded first, all at once, then shifted down by at % 16 bytes
// in registers (whole words by selects, then one funnel shift a word).
// Bytes past `n` are whatever the chunks hold there.
template <int kWords, int kChunks>
__device__ __forceinline__ void load_chunks(const uint8_t* __restrict__ buf,
                                            int64_t at, int n,
                                            uint32_t (&out)[kWords]) {
  static_assert(kWords <= 4 * kChunks - 4, "a shift by 3 words must leave "
                "kWords + 1 words");
  const uint4* p = reinterpret_cast<const uint4*>(buf + (at & ~int64_t{15}));
  const int o = static_cast<int>(at & 15);
  const int need = (o + n + 15) >> 4;
  uint32_t w[4 * kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c < need) v = __ldg(p + c);
    w[4 * c] = v.x;
    w[4 * c + 1] = v.y;
    w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  }
  const int q = o >> 2;
#pragma unroll
  for (int i = 0; i + 2 < 4 * kChunks; ++i) w[i] = (q & 2) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i + 1 < 4 * kChunks; ++i) w[i] = (q & 1) ? w[i + 1] : w[i];
  const uint32_t sh = 8u * static_cast<uint32_t>(o & 3);
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    out[k] = __funnelshift_r(w[k], w[k + 1], sh);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for phase 0 of the mbarrier at `bar` (the table copy) to complete.
__device__ __forceinline__ void bar_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(0u) : "memory");
  }
}

template <bool kSmem>
__device__ __forceinline__ uint32_t table_word(const uint32_t* p) {
  return kSmem ? *p : __ldg(p);
}

// Decodes the real row r = buf[s, e) into the four outputs.  In the smem
// tier `stage` receives the slot table, whose copy completes on the
// mbarrier at `bar_at`.
template <bool kSmem>
__device__ __forceinline__ void decode_row(const Args& a,
                                           const uint32_t* stage,
                                           uint32_t bar_at, int64_t r,
                                           int64_t s, int64_t e) {
  const uint32_t mask = static_cast<uint32_t>(a.table) - 1u;
  const uint32_t tp = (static_cast<uint32_t>(a.table) + 3u) & ~3u;
  const uint32_t* tags = kSmem ? stage : a.meta;
  const uint32_t* vals = tags + tp;
  const uint32_t* used = tags + 2 * tp;
  const int64_t cap16 = a.cap & ~int64_t{15};

  // the row's bytes: 9 words of ad id, the event type's last 4 bytes and
  // 13 digits (in 4 words)
  uint32_t ad[kAdWords], vt[1], dg[4];
  if (a.vector && s + kAdOff >= 0 && s + kAdOff + kUuidLen <= cap16 &&
      e - kVtOff >= 0 && e - kSufOff <= cap16) {
    load_chunks<kAdWords, 4>(a.buf, s + kAdOff, kUuidLen, ad);
    load_chunks<1, 2>(a.buf, e - kVtOff, 4, vt);
    load_chunks<4, 2>(a.buf, e - kDigOff, kTimeDigits, dg);
  } else {
    load_bytes<kAdWords>(a.buf, a.cap, s + kAdOff, kUuidLen, ad);
    load_bytes<1>(a.buf, a.cap, e - kVtOff, 4, vt);
    load_bytes<4>(a.buf, a.cap, e - kDigOff, kTimeDigits, dg);
  }

  uint32_t h = kFnvOffset;
#pragma unroll
  for (int k = 0; k < kAdWords; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      h = (h ^ ((ad[k] >> (8 * b)) & 0xffu)) * kFnvPrime;

  // linear probe: the first slot whose key equals the ad bytes.  Tags
  // screen the slots and an unused slot ends the chain; the used bits
  // and tags of kBatch slots are loaded at once.  The search for the
  // next tag match ends before its key is verified, so a warp's threads
  // verify together, in one round of global loads, whatever the depth
  // of each one's match (a tag that matches a different key sends its
  // thread around again).
  if (kSmem) bar_wait(bar_at);
  int32_t camp = -1;
  for (int32_t p = 0; p < a.probes;) {
    int32_t cand = -1;
    bool hole = false;
    for (int32_t q = p; q < a.probes && cand < 0 && !hole; q += kBatch) {
      uint32_t tag[kBatch], use[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const uint32_t slot = (h + static_cast<uint32_t>(q + j)) & mask;
        tag[j] = table_word<kSmem>(tags + slot);
        use[j] = table_word<kSmem>(used + (slot >> 5)) >> (slot & 31u);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (cand >= 0 || hole || q + j >= a.probes) continue;
        if (!(use[j] & 1u)) {
          hole = true;
        } else if (tag[j] == h) {
          cand = q + j;
        }
      }
    }
    if (cand < 0) break;          // an unused slot, or the bound
    const uint32_t slot = (h + static_cast<uint32_t>(cand)) & mask;
    const uint32_t* key = reinterpret_cast<const uint32_t*>(
        a.keys + static_cast<size_t>(slot) * kUuidLen);
    uint32_t diff = 0;
#pragma unroll
    for (int k = 0; k < kAdWords; ++k) diff |= __ldg(key + k) ^ ad[k];
    if (diff == 0) {
      camp = static_cast<int32_t>(table_word<kSmem>(vals + slot));
      break;
    }
    p = cand + 1;
  }

  // 13 tail-anchored digits, split at 10^9, in uint32 (wraps as int32 does)
  uint32_t hi = 0, lo = 0;
#pragma unroll
  for (int k = 0; k < kTimeDigits; ++k) {
    const uint32_t d = ((dg[k >> 2] >> (8 * (k & 3))) & 0xffu) - 48u;
    if (k < 4) {
      hi = hi * 10u + d;
    } else {
      lo = lo * 10u + d;
    }
  }
  const uint32_t t = (hi - static_cast<uint32_t>(a.base_hi)) * 1000000000u +
                     (lo - static_cast<uint32_t>(a.base_lo));

  a.campaign[r] = camp;
  a.is_view[r] = vt[0] == kView ? 1 : 0;
  a.rel[r] = static_cast<int32_t>(t);
  a.valid[r] = 1;
}

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
    decode_rows_kernel(const Args a) {
  extern __shared__ __align__(128) uint32_t stage[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_at = smem_addr(&bar);
  if (kSmem && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_at)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  // start and length in one round of loads (a pad row's start is unused)
  const int32_t len = r < a.rows ? __ldg(a.lens + r) : 0;
  const int64_t s = r < a.rows ? __ldg(a.starts + r) : 0;
  // one barrier publishes the mbarrier's init and tells whether the block
  // holds a real row; only then does it copy the slot table
  const bool staged = kSmem && __syncthreads_or(len > 0);
  if (staged && threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        ::"r"(bar_at), "r"(a.smem_bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
        "bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(stage)), "l"(a.meta), "r"(a.smem_bytes),
          "r"(bar_at) : "memory");
  }
  if (r < a.rows && len <= 0) {   // pad row (the probe never ships a
                                  // negative length)
    a.campaign[r] = -1;
    a.is_view[r] = 0;
    a.rel[r] = 0;
    a.valid[r] = 0;
  } else if (r < a.rows) {
    decode_row<kSmem>(a, stage, bar_at, r, s, s + len);
  }
  // the copy must land before the block's shared memory is released
  if (staged && threadIdx.x == 0) bar_wait(bar_at);
}

}  // namespace

// Launches K2 on `stream` with `plan` (a Plan, host memory) over `rows`
// rows; returns cudaGetLastError() (0 = launched).  Every other pointer is
// a device pointer: buf u8[cap], starts and lens i32[rows], keys u8[table,
// 36] (4-byte aligned), meta u32 (ops/decode.py:slot_meta, 16-byte
// aligned); outputs campaign i32[rows], is_view u8[rows], rel i32[rows],
// valid u8[rows].  table is a power of two.  Does not synchronise and
// allocates nothing, so a CUDA graph can capture it.
extern "C" int sb_decode_rows(const void* buf, int64_t cap,
                              const void* starts, const void* lens,
                              int64_t rows, const void* keys,
                              const void* meta, int32_t table,
                              int32_t probes, int32_t base_hi,
                              int32_t base_lo, void* campaign, void* is_view,
                              void* rel, void* valid, const void* plan,
                              void* stream) {
  if (rows <= 0) return 0;
  const Plan& p = *static_cast<const Plan*>(plan);
  const Args a{static_cast<const uint8_t*>(buf),
               cap,
               static_cast<const int32_t*>(starts),
               static_cast<const int32_t*>(lens),
               rows,
               static_cast<const uint8_t*>(keys),
               static_cast<const uint32_t*>(meta),
               table,
               probes,
               base_hi,
               base_lo,
               static_cast<int32_t*>(campaign),
               static_cast<uint8_t*>(is_view),
               static_cast<int32_t*>(rel),
               static_cast<uint8_t*>(valid),
               p.smem_bytes,
               p.vector};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the plan keeps the staged table within the 48 KB a block takes
  // without opting in, so no launch sets a function attribute
  if (p.smem_tier) {
    decode_rows_kernel<true><<<p.blocks, p.threads, p.smem_bytes, s>>>(a);
  } else {
    decode_rows_kernel<false><<<p.blocks, p.threads, 0, s>>>(a);
  }
  return cudaGetLastError();
}
