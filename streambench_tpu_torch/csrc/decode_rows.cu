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
// The host probe drops rows whose rebased time leaves int32, so on every
// row the engine ships the value is the exact time.  A byte index is read
// as JAX's gather reads it: a negative index counts from the end of the
// buffer, then it is clamped into [0, cap); probe-accepted rows never
// leave their own extent, so this only keeps any other input in bounds.
//
// Design: one thread per row, a grid sized to R, byte loads (rows start at
// any byte, so no vector loads yet).  The ad bytes are kept in registers
// (9 x 32 bits) for the hash and the key compare.
//
// What bounds it.  Its bytes, each input read once: the join table once
// (T x (36 + 4) B; 2048 slots, 80 KB, at config #1, which then stays in
// L2 for every probe), a pad row's length (4 B), a real row's (start,
// len) (8 B), 36 B of ad id, 4 B of event type and 13 B of digits, and
// 4 + 1 + 4 + 1 = 10 B written a row.  The stock catchup's dispatch (4096
// rows in one 8192-row group) needs 430,080 B, 0.000128 ms at 3.35 TB/s
// (H100 SXM data sheet).  It measured 0.0099 ms on one H100 80GB HBM3 at
// 700 W (PERF.md, PR 6), 77x that bound and 12x the launch floor: a warp
// waits on its deepest linear-probe chain (config #1's table of 1,000
// ads chains up to 12-18 slots deep; the probes' key reads, ~1.5 a row,
// come from L2) and on byte loads ~250 B apart.  Shorter chains, keys in
// shared memory or word loads are a later change, made on a measurement.
//
// Built with nvcc for sm_90a and bound through ctypes (plain C entry
// point, all pointers c_void_p).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUuidLen = 36;
constexpr int kAdOff = 113;
constexpr int kTmOff = 58;        // end-relative start of the time literal
constexpr int kDigOff = 40;       // end-relative start of the 13 digits
constexpr int kTimeDigits = 13;
constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr int kThreads = 256;

// buf[i] with JAX's gather rule: negative i counts from the end, then
// clamp into [0, cap).
__device__ __forceinline__ uint8_t load_byte(const uint8_t* __restrict__ buf,
                                             int64_t cap, int64_t i) {
  if (i < 0) i += cap;
  i = i < 0 ? 0 : (i >= cap ? cap - 1 : i);
  return buf[i];
}

__global__ void decode_rows_kernel(
    const uint8_t* __restrict__ buf, int64_t cap,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
    int64_t rows, const uint8_t* __restrict__ keys,
    const int32_t* __restrict__ vals, int32_t table, int32_t probes,
    int32_t base_hi, int32_t base_lo, int32_t* __restrict__ campaign,
    uint8_t* __restrict__ is_view, int32_t* __restrict__ rel,
    uint8_t* __restrict__ valid) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (r >= rows) return;
  const int32_t len = lens[r];
  if (len <= 0) {   // pad row (the probe never ships a negative length)
    campaign[r] = -1;
    is_view[r] = 0;
    rel[r] = 0;
    valid[r] = 0;
    return;
  }
  const int64_t s = starts[r];
  const int64_t e = s + len;

  // ad id bytes, packed 4 to a register, and their FNV-1a hash
  uint32_t ad[kUuidLen / 4];
  uint32_t h = kFnvOffset;
#pragma unroll
  for (int w = 0; w < kUuidLen / 4; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t c = load_byte(buf, cap, s + kAdOff + 4 * w + b);
      h = (h ^ c) * kFnvPrime;
      word |= c << (8 * b);
    }
    ad[w] = word;
  }

  // linear probe: the first slot whose key equals the ad bytes
  int32_t camp = -1;
  const uint32_t mask = static_cast<uint32_t>(table) - 1u;
  for (int32_t p = 0; p < probes; ++p) {
    const uint32_t slot = (h + static_cast<uint32_t>(p)) & mask;
    const uint8_t* key = keys + static_cast<int64_t>(slot) * kUuidLen;
    bool hit = true;
#pragma unroll
    for (int w = 0; w < kUuidLen / 4; ++w) {
      const uint32_t kw = static_cast<uint32_t>(key[4 * w]) |
                          static_cast<uint32_t>(key[4 * w + 1]) << 8 |
                          static_cast<uint32_t>(key[4 * w + 2]) << 16 |
                          static_cast<uint32_t>(key[4 * w + 3]) << 24;
      hit &= kw == ad[w];
    }
    if (hit) {
      camp = vals[slot];
      break;
    }
  }

  // the 4 bytes before the event_time literal: "view" ends no other type
  const int64_t vt = e - (kTmOff + 4);
  const bool view = load_byte(buf, cap, vt) == 'v' &&
                    load_byte(buf, cap, vt + 1) == 'i' &&
                    load_byte(buf, cap, vt + 2) == 'e' &&
                    load_byte(buf, cap, vt + 3) == 'w';

  // 13 tail-anchored digits, split at 10^9, in uint32 (wraps as int32 does)
  uint32_t hi = 0, lo = 0;
#pragma unroll
  for (int k = 0; k < kTimeDigits; ++k) {
    const uint32_t d =
        static_cast<uint32_t>(load_byte(buf, cap, e - kDigOff + k)) - 48u;
    if (k < 4) {
      hi = hi * 10u + d;
    } else {
      lo = lo * 10u + d;
    }
  }
  const uint32_t t = (hi - static_cast<uint32_t>(base_hi)) * 1000000000u +
                     (lo - static_cast<uint32_t>(base_lo));

  campaign[r] = camp;
  is_view[r] = view ? 1 : 0;
  rel[r] = static_cast<int32_t>(t);
  valid[r] = 1;
}

}  // namespace

// Launches K2 on `stream` over `rows` rows; returns cudaGetLastError()
// (0 = launched).  Every pointer is a device pointer: buf u8[cap], starts
// and lens i32[rows], keys u8[table, 36], vals i32[table]; outputs
// campaign i32[rows], is_view u8[rows], rel i32[rows], valid u8[rows].
// table is a power of two.
extern "C" int sb_decode_rows(const void* buf, int64_t cap,
                              const void* starts, const void* lens,
                              int64_t rows, const void* keys,
                              const void* vals, int32_t table,
                              int32_t probes, int32_t base_hi,
                              int32_t base_lo, void* campaign, void* is_view,
                              void* rel, void* valid, void* stream) {
  if (rows <= 0) return 0;
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  decode_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), cap,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(lens),
      rows, static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(vals), table, probes, base_hi, base_lo,
      static_cast<int32_t*>(campaign), static_cast<uint8_t*>(is_view),
      static_cast<int32_t*>(rel), static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}
