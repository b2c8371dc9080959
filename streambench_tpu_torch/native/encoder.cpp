// Native columnar event encoder: the host-side deserialize stage at line rate.
//
// TPU-native peer of the JVM engines' deserialize bolts
// (storm-benchmarks/.../AdvertisingTopology.java:44-70): parses the
// generator's fixed-field-order JSON wire format
// (make-kafka-event-at, data/src/setup/core.clj:175-181) straight into
// int32 column buffers that the XLA window step gathers/scatters on.
// Strings (ad/user/page UUIDs) are interned to dense indices here, in C++,
// so nothing string-shaped crosses into Python or onto the device.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).
// Lines whose layout the fast scan rejects get status=2 and are re-parsed
// by the Python json.loads fallback; hard-bad lines get status=0.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// Transparent (heterogeneous) hashing: lets the hot loop probe the maps
// with a string_view into the input buffer — NO std::string temporary,
// no heap allocation per row (C++20 unordered heterogeneous lookup).
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view sv) const {
    return std::hash<std::string_view>{}(sv);
  }
  size_t operator()(const std::string& s) const {
    return std::hash<std::string_view>{}(std::string_view(s));
  }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(std::string_view a, std::string_view b) const {
    return a == b;
  }
};
#if defined(__cpp_lib_generic_unordered_lookup) && \
    __cpp_lib_generic_unordered_lookup >= 201811L
using SvMap = std::unordered_map<std::string, int32_t, SvHash, SvEq>;
#else
// Pre-C++20-library toolchains (GCC 10's libstdc++ has no heterogeneous
// unordered lookup): emulate find(string_view) with a key copy on the
// probe.  The hit path pays one short-string allocation; semantics are
// identical, and newer toolchains keep the alloc-free path above.
struct SvMap : std::unordered_map<std::string, int32_t, SvHash, SvEq> {
  using Base = std::unordered_map<std::string, int32_t, SvHash, SvEq>;
  using Base::find;
  Base::iterator find(std::string_view k) {
    return Base::find(std::string(k));
  }
  Base::const_iterator find(std::string_view k) const {
    return Base::find(std::string(k));
  }
};
#endif

struct StringInterner {
  SvMap map;
  int32_t next = 0;

  int32_t intern(const char* s, size_t len) {
    std::string_view sv(s, len);
    auto it = map.find(sv);           // no alloc on the hit path
    if (it != map.end()) return it->second;
    auto r = map.emplace(std::string(sv), next);
    ++next;
    return r.first->second;
  }

  // Total key bytes (for sizing a dump buffer).
  int64_t total_bytes() const {
    int64_t n = 0;
    for (const auto& kv : map) n += static_cast<int64_t>(kv.first.size());
    return n;
  }

  // Write keys concatenated in INDEX ORDER into buf; offsets[next+1]
  // gets the cumulative byte offsets.  Index order is what lets a
  // restore re-intern the keys and land on identical indices — the
  // checkpoint/resume contract for sketch state keyed by interned ids.
  void dump(char* buf, int64_t* offsets) const {
    std::vector<const std::string*> by_idx(static_cast<size_t>(next));
    for (const auto& kv : map) by_idx[static_cast<size_t>(kv.second)] =
        &kv.first;
    int64_t off = 0;
    offsets[0] = 0;
    for (int32_t i = 0; i < next; ++i) {
      const std::string& s = *by_idx[static_cast<size_t>(i)];
      std::memcpy(buf + off, s.data(), s.size());
      off += static_cast<int64_t>(s.size());
      offsets[i + 1] = off;
    }
  }
};

// "Unset" sentinel for base_time_ms.  NOT -1 / "< 0": a legitimately
// negative base is routine for small synthetic event times (base =
// t - t%divisor - lateness goes negative whenever t < divisor+lateness),
// and conflating it with "unset" silently re-rebased every batch.
constexpr int64_t kBaseUnset = INT64_MIN;

// Stateless 32-bit id hash: standard CRC-32 (IEEE reflected), chosen to
// be bit-identical to Python's zlib.crc32 — the differential tests pin
// the two implementations against each other.
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
static const Crc32Table kCrc;

static inline int32_t crc32b(const char* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    c = kCrc.t[(c ^ (uint8_t)p[i]) & 0xFF] ^ (c >> 8);
  return (int32_t)(c ^ 0xFFFFFFFFu);
}

struct Encoder {
  SvMap ad_index;
  StringInterner users;
  StringInterner pages;
  // When false, user/page ids are NOT interned (columns get 0): the
  // exact-count kernels never read them, and the two hash probes per
  // row are the single largest per-event cost after tokenization.
  bool intern_ids = true;
  // When true (wins over intern_ids), user/page columns carry crc32 of
  // the id bytes: stateless, so independent encoders (pool workers,
  // micro-batch partitions) and restarted processes agree without any
  // intern-table snapshot.  For hash-consuming kernels (HLL) only.
  bool hash_ids = false;
  int64_t base_time_ms = kBaseUnset;
  int64_t divisor_ms = 10000;
  int64_t lateness_ms = 60000;
  int32_t unknown_ad = 0;
  // Adaptive value-length hints for the skeleton fast path (ids are
  // fixed-width UUIDs in practice; learned from the first line so other
  // id shapes still get the one-probe hit path).
  size_t hint_user = 36, hint_page = 36, hint_ad = 36;
};

// token positions when splitting the generator's line on '"':
//  1:user_id 3:<u> 5:page_id 7:<p> 9:ad_id 11:<ad> 13:ad_type 15:<at>
// 17:event_type 19:<et> 21:event_time 23:<t>
struct Tok {
  const char* p;
  size_t len;
};

inline bool tok_eq(const Tok& t, const char* lit, size_t n) {
  return t.len == n && std::memcmp(t.p, lit, n) == 0;
}

// ad_type table (encode/encoder.py AD_TYPES) and event_type table
// (EVENT_TYPES); event "view" == 0 is the device-side filter constant.
inline int32_t ad_type_code(const Tok& t) {
  switch (t.len) {
    case 6:
      if (tok_eq(t, "banner", 6)) return 0;
      if (tok_eq(t, "mobile", 6)) return 4;
      return -1;
    case 5:  return tok_eq(t, "modal", 5) ? 1 : -1;
    case 16: return tok_eq(t, "sponsored-search", 16) ? 2 : -1;
    case 4:  return tok_eq(t, "mail", 4) ? 3 : -1;
    default: return -1;
  }
}

inline int32_t event_type_code(const Tok& t) {
  if (tok_eq(t, "view", 4)) return 0;
  if (tok_eq(t, "click", 5)) return 1;
  if (tok_eq(t, "purchase", 8)) return 2;
  return -1;
}

}  // namespace

namespace {

// --- skeleton fast path -------------------------------------------------
// The generator renders one fixed skeleton (gen.cpp / EventSource.event_at):
//   {"user_id": "U", "page_id": "P", ..., "event_time": "T", ...
// so instead of tokenizing on quotes we memcmp the literal skeleton and
// probe each value's closing quote at its learned length (one branch per
// value instead of a memchr).  Any mismatch falls back to the quote-token
// parser below, which tolerates arbitrary spacing.

inline bool rel_time_fits(int64_t t, int64_t base) {
  const int64_t rel = t - base;
  return rel >= INT32_MIN && rel <= INT32_MAX;
}

inline bool skel(const char*& p, const char* end, const char* lit,
                 size_t n) {
  if (static_cast<size_t>(end - p) < n || std::memcmp(p, lit, n) != 0)
    return false;
  p += n;
  return true;
}

inline bool skel_value(const char*& p, const char* end, size_t& hint,
                       Tok& out) {
  if (hint > 0 && p + hint < end && p[hint] == '"') {
    out.p = p;
    out.len = hint;
    p += hint + 1;
    return true;
  }
  const char* q = static_cast<const char*>(
      std::memchr(p, '"', static_cast<size_t>(end - p)));
  if (q == nullptr) return false;
  out.p = p;
  out.len = static_cast<size_t>(q - p);
  hint = out.len;
  p = q + 1;
  return true;
}

// Returns 1 on success (row i filled, status 1); 0 = not this layout
// (caller tries the tolerant parser; nothing written).
inline int parse_skeleton(Encoder* enc, const char* p, const char* end,
                          int64_t i, int32_t* ad_idx, int32_t* etype,
                          int32_t* etime, int32_t* user_idx,
                          int32_t* page_idx, int32_t* ad_type,
                          uint8_t* status) {
  Tok user, page, ad, at, et;
  if (!skel(p, end, "{\"user_id\": \"", 13) ||
      !skel_value(p, end, enc->hint_user, user) ||
      !skel(p, end, ", \"page_id\": \"", 14) ||
      !skel_value(p, end, enc->hint_page, page) ||
      !skel(p, end, ", \"ad_id\": \"", 12) ||
      !skel_value(p, end, enc->hint_ad, ad))
    return 0;
  // type values vary per event, so no stable length hint: the throwaway
  // hint makes skel_value a plain closing-quote memchr
  size_t no_hint = 0;
  if (!skel(p, end, ", \"ad_type\": \"", 14) ||
      !skel_value(p, end, (no_hint = 0), at))
    return 0;
  if (!skel(p, end, ", \"event_type\": \"", 17) ||
      !skel_value(p, end, (no_hint = 0), et))
    return 0;
  if (!skel(p, end, ", \"event_time\": \"", 17)) return 0;
  int64_t t = 0;
  size_t nd = 0;
  while (p + nd < end && nd < 15) {  // same 15-digit cap as parse_tokens
    char c = p[nd];
    if (c == '"') break;
    if (c < '0' || c > '9') return 0;
    t = t * 10 + (c - '0');
    ++nd;
  }
  if (nd == 0 || p + nd >= end || p[nd] != '"') return 0;
  p += nd + 1;
  // Tail check: a truncated record must fall through to the tolerant
  // parser (whose 24-token requirement rejects it to the Python
  // fallback), not be silently accepted as a valid event.
  if (!skel(p, end, ", \"ip_address\"", 14)) return 0;

  if (enc->base_time_ms == kBaseUnset) {
    enc->base_time_ms = t - (t % enc->divisor_ms) - enc->lateness_ms;
  }
  if (!rel_time_fits(t, enc->base_time_ms)) {
    status[i] = 2;  // python fallback re-applies the int32-fit rule and
    return 0;       // rejects — never a silent int32 wrap
  }
  auto ad_it = enc->ad_index.find(std::string_view(ad.p, ad.len));
  ad_idx[i] = ad_it == enc->ad_index.end() ? enc->unknown_ad
                                           : ad_it->second;
  etype[i] = event_type_code(et);
  etime[i] = static_cast<int32_t>(t - enc->base_time_ms);
  if (enc->hash_ids) {
    user_idx[i] = crc32b(user.p, user.len);
    page_idx[i] = crc32b(page.p, page.len);
  } else if (enc->intern_ids) {
    user_idx[i] = enc->users.intern(user.p, user.len);
    page_idx[i] = enc->pages.intern(page.p, page.len);
  } else {
    user_idx[i] = 0;
    page_idx[i] = 0;
  }
  ad_type[i] = ad_type_code(at);
  status[i] = 1;
  return 1;
}

// Parse one wire-format line [p, end) into row i of the column buffers.
// status[i]: 1 = parsed, 2 = layout mismatch (python fallback), 0 = bad.
// Returns 1 on success, 0 otherwise.
inline int parse_tokens(Encoder* enc, const char* p, const char* end,
                        int64_t i, int32_t* ad_idx, int32_t* etype,
                        int32_t* etime, int32_t* user_idx, int32_t* page_idx,
                        int32_t* ad_type, uint8_t* status) {
  // split on '"' into the first 24 tokens (memchr: SIMD-accelerated)
  Tok toks[24];
  int nt = 0;
  const char* start = p;
  while (nt < 24) {
    const char* q = static_cast<const char*>(
        std::memchr(start, '"', static_cast<size_t>(end - start)));
    if (q == nullptr) break;
    toks[nt].p = start;
    toks[nt].len = static_cast<size_t>(q - start);
    ++nt;
    start = q + 1;
  }
  if (nt < 24 || !tok_eq(toks[1], "user_id", 7) ||
      !tok_eq(toks[5], "page_id", 7) || !tok_eq(toks[9], "ad_id", 5) ||
      !tok_eq(toks[13], "ad_type", 7) ||
      !tok_eq(toks[17], "event_type", 10) ||
      !tok_eq(toks[21], "event_time", 10)) {
    status[i] = 2;
    return 0;
  }
  // event_time digits
  int64_t t = 0;
  bool tok_ok = toks[23].len > 0 && toks[23].len <= 15;
  if (tok_ok) {
    for (size_t k = 0; k < toks[23].len; ++k) {
      char c = toks[23].p[k];
      if (c < '0' || c > '9') { tok_ok = false; break; }
      t = t * 10 + (c - '0');
    }
  }
  if (!tok_ok) {
    status[i] = 2;
    return 0;
  }
  if (enc->base_time_ms == kBaseUnset) {
    enc->base_time_ms = t - (t % enc->divisor_ms) - enc->lateness_ms;
  }
  if (!rel_time_fits(t, enc->base_time_ms)) {
    status[i] = 2;
    return 0;
  }
  auto ad_it = enc->ad_index.find(std::string_view(toks[11].p,
                                                   toks[11].len));
  ad_idx[i] = ad_it == enc->ad_index.end() ? enc->unknown_ad
                                           : ad_it->second;
  etype[i] = event_type_code(toks[19]);
  etime[i] = static_cast<int32_t>(t - enc->base_time_ms);
  if (enc->hash_ids) {
    user_idx[i] = crc32b(toks[3].p, toks[3].len);
    page_idx[i] = crc32b(toks[7].p, toks[7].len);
  } else if (enc->intern_ids) {
    user_idx[i] = enc->users.intern(toks[3].p, toks[3].len);
    page_idx[i] = enc->pages.intern(toks[7].p, toks[7].len);
  } else {
    user_idx[i] = 0;
    page_idx[i] = 0;
  }
  ad_type[i] = ad_type_code(toks[15]);
  status[i] = 1;
  return 1;
}

inline int parse_one(Encoder* enc, const char* p, const char* end,
                     int64_t i, int32_t* ad_idx, int32_t* etype,
                     int32_t* etime, int32_t* user_idx, int32_t* page_idx,
                     int32_t* ad_type, uint8_t* status) {
  if (parse_skeleton(enc, p, end, i, ad_idx, etype, etime, user_idx,
                     page_idx, ad_type, status))
    return 1;
  return parse_tokens(enc, p, end, i, ad_idx, etype, etime, user_idx,
                      page_idx, ad_type, status);
}

}  // namespace

extern "C" {

void* sb_encoder_new(const char* ads_buf, const int64_t* ad_offsets,
                     int32_t n_ads, int64_t divisor_ms, int64_t lateness_ms) {
  auto* e = new Encoder();
  e->ad_index.reserve(static_cast<size_t>(n_ads) * 2);
  for (int32_t i = 0; i < n_ads; ++i) {
    const char* s = ads_buf + ad_offsets[i];
    size_t len = static_cast<size_t>(ad_offsets[i + 1] - ad_offsets[i]);
    e->ad_index.emplace(std::string(s, len), i);
  }
  e->unknown_ad = n_ads;
  e->divisor_ms = divisor_ms;
  e->lateness_ms = lateness_ms;
  return e;
}

void sb_encoder_free(void* enc) { delete static_cast<Encoder*>(enc); }

int64_t sb_encoder_base_time(void* enc) {
  return static_cast<Encoder*>(enc)->base_time_ms;
}

void sb_encoder_set_base_time(void* enc, int64_t base) {
  static_cast<Encoder*>(enc)->base_time_ms = base;
}

// 0 disables user/page interning (columns become 0) for engines whose
// kernels never read those columns; 1 (default) re-enables it.
void sb_encoder_set_intern_ids(void* enc, int32_t on) {
  static_cast<Encoder*>(enc)->intern_ids = on != 0;
}

// 1 switches user/page columns to stateless crc32 of the id bytes
// (consistent across encoders/restarts; for hash-consuming kernels).
void sb_encoder_set_hash_ids(void* enc, int32_t on) {
  static_cast<Encoder*>(enc)->hash_ids = on != 0;
}

int64_t sb_encoder_n_users(void* enc) {
  return static_cast<Encoder*>(enc)->users.next;
}

int64_t sb_encoder_n_pages(void* enc) {
  return static_cast<Encoder*>(enc)->pages.next;
}

int64_t sb_encoder_users_bytes(void* enc) {
  return static_cast<Encoder*>(enc)->users.total_bytes();
}

int64_t sb_encoder_pages_bytes(void* enc) {
  return static_cast<Encoder*>(enc)->pages.total_bytes();
}

// Dump intern tables in index order (see StringInterner::dump): buf must
// hold *_bytes() bytes, offsets must hold n_*+1 int64s.
void sb_encoder_dump_users(void* enc, char* buf, int64_t* offsets) {
  static_cast<Encoder*>(enc)->users.dump(buf, offsets);
}

void sb_encoder_dump_pages(void* enc, char* buf, int64_t* offsets) {
  static_cast<Encoder*>(enc)->pages.dump(buf, offsets);
}

// Intern one id through the same maps the fast path uses, so Python
// fallback-parsed lines stay index-consistent.
int32_t sb_intern_user(void* enc, const char* s, int64_t len) {
  return static_cast<Encoder*>(enc)->users.intern(
      s, static_cast<size_t>(len));
}

int32_t sb_intern_page(void* enc, const char* s, int64_t len) {
  return static_cast<Encoder*>(enc)->pages.intern(
      s, static_cast<size_t>(len));
}

// Parse n_lines lines (buf + line_offsets, offsets[n] = end) into columns.
// status[i]: 1 = parsed, 2 = layout mismatch (python fallback), 0 = bad.
// Returns the number of status==1 rows.
int64_t sb_encode_json(void* enc_, const char* buf,
                       const int64_t* line_offsets, int32_t n_lines,
                       int32_t* ad_idx, int32_t* etype, int32_t* etime,
                       int32_t* user_idx, int32_t* page_idx,
                       int32_t* ad_type, uint8_t* status) {
  auto* enc = static_cast<Encoder*>(enc_);
  int64_t ok = 0;
  for (int32_t i = 0; i < n_lines; ++i) {
    ok += parse_one(enc, buf + line_offsets[i], buf + line_offsets[i + 1],
                    i, ad_idx, etype, etime, user_idx, page_idx, ad_type,
                    status);
  }
  return ok;
}

// Scan up to max_records NEWLINE-DELIMITED records straight out of a raw
// journal block and parse them in the same pass — no per-line buffers or
// offset arrays cross the FFI (the fork's mmap'd columnar handoff taken
// to its conclusion: bytes in, columns out).  Scanning starts at
// buf[start]; rec_offsets[i] records each record's start (for the rare
// Python fallback on layout-mismatch rows) and rec_offsets[n] the total
// consumed length, excluding any incomplete trailing record.
int64_t sb_encode_block(void* enc_, const char* buf, int64_t len,
                        int64_t start, int64_t max_records,
                        int32_t* ad_idx, int32_t* etype, int32_t* etime,
                        int32_t* user_idx, int32_t* page_idx,
                        int32_t* ad_type, uint8_t* status,
                        int64_t* rec_offsets) {
  auto* enc = static_cast<Encoder*>(enc_);
  int64_t n = 0;
  int64_t pos = start;
  while (n < max_records && pos < len) {
    const char* nl = static_cast<const char*>(
        std::memchr(buf + pos, '\n', static_cast<size_t>(len - pos)));
    if (nl == nullptr) break;  // incomplete trailing record: not consumed
    rec_offsets[n] = pos;
    parse_one(enc, buf + pos, nl, n, ad_idx, etype, etime, user_idx,
              page_idx, ad_type, status);
    pos = (nl - buf) + 1;
    ++n;
  }
  rec_offsets[n] = pos;
  return n;
}

// Device-decode probe (ops/devdecode.py): scan newline-delimited records
// and VALIDATE the generator's fixed byte layout without building any
// columns — the decode itself (field extraction, ad join, window fold)
// happens inside the jitted device step.  A record passes (ok=1) iff
// every byte the device kernel will read sits exactly where the fixed
// schema puts it:
//
//   {"user_id": "<36>", "page_id": "<36>", "ad_id": "<36>",
//    "ad_type": "<1..n, no quotes>", "event_type": "<view|click|purchase>",
//    "event_time": "<exactly 13 digits>", "ip_address": "1.2.3.4"}
//
// head literals are anchored at the record START (uuid fields are
// quote-free, so their 36-byte spans cannot hide early terminators the
// host's token parser would split on), tail literals at the record END.
// Rows that fail go back to the host encoder verbatim, which keeps
// bad-line counting and dead-letter behavior identical to the host
// arms.  times[i] holds the parsed absolute ms stamp for ok rows (the
// span-guard/watermark input the host loop needs before dispatching).
int64_t sb_probe_block(const char* buf, int64_t len, int64_t start,
                       int32_t max_rows, int32_t* starts, int32_t* lens,
                       int64_t* times, uint8_t* ok) {
  static const char kHead[] = "{\"user_id\": \"";          // 13 @ 0
  static const char kPage[] = "\", \"page_id\": \"";       // 15 @ 49
  static const char kAd[] = "\", \"ad_id\": \"";           // 13 @ 100
  static const char kAdType[] = "\", \"ad_type\": \"";     // 15 @ 149
  static const char kTime[] = "\", \"event_time\": \"";    // 18 @ L-58
  static const char kSuffix[] = "\", \"ip_address\": \"1.2.3.4\"}";  // 27
  static const char kView[] = "\", \"event_type\": \"view";        // 22
  static const char kClick[] = "\", \"event_type\": \"click";      // 23
  static const char kPurchase[] = "\", \"event_type\": \"purchase";  // 26
  int64_t n = 0;
  int64_t pos = start;
  while (n < max_rows && pos < len) {
    const char* nl = static_cast<const char*>(
        std::memchr(buf + pos, '\n', static_cast<size_t>(len - pos)));
    if (nl == nullptr) break;  // incomplete trailing record: not consumed
    const char* p = buf + pos;
    const int64_t L = nl - p;
    starts[n] = static_cast<int32_t>(pos);
    lens[n] = static_cast<int32_t>(L);
    int good = 0;
    int64_t t = 0;
    // 245 = 164-byte fixed head + 1-byte ad_type floor + 80-byte fixed
    // tail (event_type "view" is the shortest).
    if (L >= 245 && std::memcmp(p, kHead, 13) == 0 &&
        std::memchr(p + 13, '"', 36) == nullptr &&
        std::memcmp(p + 49, kPage, 15) == 0 &&
        std::memchr(p + 64, '"', 36) == nullptr &&
        std::memcmp(p + 100, kAd, 13) == 0 &&
        std::memchr(p + 113, '"', 36) == nullptr &&
        std::memcmp(p + 149, kAdType, 15) == 0 &&
        std::memcmp(p + L - 27, kSuffix, 27) == 0 &&
        std::memcmp(p + L - 58, kTime, 18) == 0) {
      good = 1;
      for (int k = 0; k < 13; ++k) {
        char c = p[L - 40 + k];
        if (c < '0' || c > '9') { good = 0; break; }
        t = t * 10 + (c - '0');
      }
      if (good) {
        int64_t et_len;
        if (std::memcmp(p + L - 80, kView, 22) == 0) et_len = 4;
        else if (std::memcmp(p + L - 81, kClick, 23) == 0) et_len = 5;
        else if (std::memcmp(p + L - 84, kPurchase, 26) == 0) et_len = 8;
        else et_len = -1;
        // ad_type value: whatever sits between the fixed head and the
        // event_type literal; must be non-empty and quote-free or the
        // host token parser would see a different structure.
        const int64_t at_len = L - 240 - et_len;
        good = (et_len > 0 && at_len >= 1 &&
                std::memchr(p + 164, '"',
                            static_cast<size_t>(at_len)) == nullptr)
                   ? 1
                   : 0;
      }
    }
    ok[n] = static_cast<uint8_t>(good);
    times[n] = good ? t : 0;
    pos = (nl - buf) + 1;
    ++n;
  }
  return n;
}

}  // extern "C"
