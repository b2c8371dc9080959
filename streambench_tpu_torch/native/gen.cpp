// Native event formatter: the load generator's hot loop.
//
// The reference's generator spends its per-event budget building a JSON
// string on the JVM (make-kafka-event-at, data/src/setup/core.clj:163-181).
// The Python peer (datagen/gen.py EventSource) does the same at ~3 us/event,
// which is fine on a many-core host but starves the co-located engine on a
// single-core one: the paced producer and the engine share that core, so
// every producer-side microsecond is stolen from the pipeline under test.
// This formatter renders the identical wire format at ~50 ns/event so the
// producer's share of the core rounds to zero.
//
// Plain C ABI (loaded via ctypes, same discipline as encoder.cpp): all
// buffers are caller-owned; the RNG state is caller-held and updated in
// place so successive calls continue one deterministic stream.

#include <cstdint>
#include <cstring>

namespace {

// splitmix64 — tiny, well-distributed, and stateless per step.  Chosen over
// reproducing Python's Mersenne Twister: the wire format carries no RNG
// contract (the oracle replays the journal), only the *distributions*
// matter (uniform id choice, the reference's skew odds, core.clj:166-174).
inline uint64_t next_u64(uint64_t &state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Unbiased-enough bounded draw (128-bit multiply; bias < 2^-32 for the
// small bounds used here).
inline uint64_t bounded(uint64_t &state, uint64_t n) {
  return (uint64_t)(((__uint128_t)next_u64(state) * n) >> 64);
}

inline char *put(char *p, const char *s, size_t n) {
  std::memcpy(p, s, n);
  return p + n;
}

inline char *put_i64(char *p, int64_t v) {
  if (v < 0) {
    *p++ = '-';
    v = -v;
  }
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

}  // namespace

extern "C" {

// Renders n_events wire-format ad events (newline-terminated JSON lines,
// field order and spacing identical to datagen/gen.py::EventSource) into
// `out`.  Ids are fixed-stride blobs (UUID strings are uniform width);
// ad/event types are concatenated variable-length strings described by a
// length array.  Returns bytes written, or -1 when out_cap could not hold
// the worst case (caller sizes via sb_format_events_cap).
int64_t sb_format_events(
    const char *users, int32_t user_len, int32_t n_users,
    const char *pages, int32_t page_len, int32_t n_pages,
    const char *ads, int32_t ad_len, int32_t n_ads,
    const char *ad_types, const int32_t *ad_type_len, int32_t n_ad_types,
    const char *ev_types, const int32_t *ev_type_len, int32_t n_ev_types,
    const int64_t *ts_ms, int64_t n_events,
    uint64_t *rng_state, int32_t with_skew,
    char *out, int64_t out_cap) {
  if (n_users <= 0 || n_pages <= 0 || n_ads <= 0 || n_ad_types <= 0 ||
      n_ev_types <= 0)
    return -1;
  // Precompute type-string offsets + the worst-case line length.
  int32_t ad_off[65], ev_off[65];  // prefix sums write index n_types
  if (n_ad_types > 64 || n_ev_types > 64) return -1;
  int32_t max_ad_t = 0, max_ev_t = 0;
  ad_off[0] = 0;
  for (int i = 0; i < n_ad_types; i++) {
    ad_off[i + 1] = ad_off[i] + ad_type_len[i];
    if (ad_type_len[i] > max_ad_t) max_ad_t = ad_type_len[i];
  }
  ev_off[0] = 0;
  for (int i = 0; i < n_ev_types; i++) {
    ev_off[i + 1] = ev_off[i] + ev_type_len[i];
    if (ev_type_len[i] > max_ev_t) max_ev_t = ev_type_len[i];
  }
  static const char k_user[] = "{\"user_id\": \"";
  static const char k_page[] = "\", \"page_id\": \"";
  static const char k_ad[] = "\", \"ad_id\": \"";
  static const char k_adt[] = "\", \"ad_type\": \"";
  static const char k_evt[] = "\", \"event_type\": \"";
  static const char k_time[] = "\", \"event_time\": \"";
  static const char k_tail[] = "\", \"ip_address\": \"1.2.3.4\"}\n";
  const int64_t fixed = (sizeof(k_user) - 1) + (sizeof(k_page) - 1) +
                        (sizeof(k_ad) - 1) + (sizeof(k_adt) - 1) +
                        (sizeof(k_evt) - 1) + (sizeof(k_time) - 1) +
                        (sizeof(k_tail) - 1);
  const int64_t worst =
      fixed + user_len + page_len + ad_len + max_ad_t + max_ev_t + 21;
  if (n_events * worst > out_cap) return -1;

  uint64_t st = *rng_state;
  char *p = out;
  for (int64_t i = 0; i < n_events; i++) {
    int64_t t = ts_ms[i];
    if (with_skew) {
      // +-50 ms skew; 1/100,000 events late by up to 60 s (core.clj:166-174)
      t += 50 - (int64_t)bounded(st, 100);
      if (bounded(st, 100000) == 0) t -= (int64_t)bounded(st, 60000);
    }
    p = put(p, k_user, sizeof(k_user) - 1);
    p = put(p, users + bounded(st, n_users) * user_len, user_len);
    p = put(p, k_page, sizeof(k_page) - 1);
    p = put(p, pages + bounded(st, n_pages) * page_len, page_len);
    p = put(p, k_ad, sizeof(k_ad) - 1);
    p = put(p, ads + bounded(st, n_ads) * ad_len, ad_len);
    p = put(p, k_adt, sizeof(k_adt) - 1);
    uint64_t a = bounded(st, n_ad_types);
    p = put(p, ad_types + ad_off[a], ad_type_len[a]);
    p = put(p, k_evt, sizeof(k_evt) - 1);
    uint64_t e = bounded(st, n_ev_types);
    p = put(p, ev_types + ev_off[e], ev_type_len[e]);
    p = put(p, k_time, sizeof(k_time) - 1);
    p = put_i64(p, t);
    p = put(p, k_tail, sizeof(k_tail) - 1);
  }
  *rng_state = st;
  return p - out;
}

// Worst-case output bytes per event for the given id/type geometry, so the
// caller can size `out` exactly once.
int64_t sb_format_events_cap(int32_t user_len, int32_t page_len,
                             int32_t ad_len, const int32_t *ad_type_len,
                             int32_t n_ad_types, const int32_t *ev_type_len,
                             int32_t n_ev_types) {
  int32_t max_ad_t = 0, max_ev_t = 0;
  for (int i = 0; i < n_ad_types; i++)
    if (ad_type_len[i] > max_ad_t) max_ad_t = ad_type_len[i];
  for (int i = 0; i < n_ev_types; i++)
    if (ev_type_len[i] > max_ev_t) max_ev_t = ev_type_len[i];
  return 128 + user_len + page_len + ad_len + max_ad_t + max_ev_t + 21;
}

}  // extern "C"
