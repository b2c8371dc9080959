// Native in-process Redis-compatible store.
//
// The results sink of the reference is a real (C) redis-server
// (stream-bench.sh:180-187); the framework's in-process stand-in was pure
// Python, which put a ~1.4 us/row dict loop on the canonical window
// writeback (AdvertisingSpark.scala:184-208) — the largest host cost left
// in the catchup pipeline after the native encoder.  This store keeps the
// same command surface and RESP reply format (one implementation of reply
// encoding, shared by the in-process adapter and the TCP server), plus a
// bulk window-writeback entry point that performs the whole canonical
// schema update (probe -> create ids -> LPUSH -> HINCRBY/HSET) in native
// code at ~100 ns/row.
//
// Threading: one mutex per store; every entry point takes it.
// Replies: RESP2 bytes into a caller-owned buffer; when the buffer is too
// small the required size is returned as -(needed) and the caller retries.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_set>
#include <random>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

using std::string;
using std::string_view;

struct Reply {
  char* out;
  int64_t cap;
  int64_t len = 0;  // bytes needed (written only while len <= cap)

  void raw(const char* p, size_t n) {
    if (len + (int64_t)n <= cap) std::memcpy(out + len, p, n);
    len += (int64_t)n;
  }
  void lit(const char* s) { raw(s, std::strlen(s)); }
  void num(int64_t v) {
    char tmp[24];
    int n = std::snprintf(tmp, sizeof tmp, "%lld", (long long)v);
    raw(tmp, (size_t)n);
  }
  void integer(int64_t v) { lit(":"); num(v); lit("\r\n"); }
  void simple(const char* s) { lit("+"); lit(s); lit("\r\n"); }
  void nil() { lit("$-1\r\n"); }
  void bulk(string_view s) {
    lit("$");
    num((int64_t)s.size());
    lit("\r\n");
    raw(s.data(), s.size());
    lit("\r\n");
  }
  void error(const char* msg) { lit("-"); lit(msg); lit("\r\n"); }
  void array_header(int64_t n) { lit("*"); num(n); lit("\r\n"); }
};

// Transparent (heterogeneous) hashing: probes take string_view into
// caller buffers with no per-probe std::string allocation (same idiom as
// the encoder's interner).
struct SvHash {
  using is_transparent = void;
  // single overload: std::string and char literals convert to
  // string_view, and two overloads would make literal keys ambiguous
  size_t operator()(string_view sv) const {
    return std::hash<string_view>{}(sv);
  }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(string_view a, string_view b) const { return a == b; }
};
#if defined(__cpp_lib_generic_unordered_lookup) && \
    __cpp_lib_generic_unordered_lookup >= 201811L
template <typename V>
using SvMap = std::unordered_map<string, V, SvHash, SvEq>;
using SvSet = std::unordered_set<string, SvHash, SvEq>;
#else
// Pre-C++20-library toolchains (GCC 10's libstdc++ has no heterogeneous
// unordered lookup): emulate find/count(string_view) with a key copy on
// the probe.  One short-string allocation per probe, identical
// semantics; newer toolchains keep the alloc-free path above.  The
// const char* overloads keep literal keys (e.g. find("windows"))
// unambiguous between the string and string_view conversions.
template <typename V>
struct SvMap : std::unordered_map<string, V, SvHash, SvEq> {
  using Base = std::unordered_map<string, V, SvHash, SvEq>;
  using Base::count;
  using Base::find;
  typename Base::iterator find(string_view k) {
    return Base::find(string(k));
  }
  typename Base::const_iterator find(string_view k) const {
    return Base::find(string(k));
  }
  typename Base::iterator find(const char* k) {
    return Base::find(string(k));
  }
  size_t count(string_view k) const { return Base::count(string(k)); }
};
struct SvSet : std::unordered_set<string, SvHash, SvEq> {
  using Base = std::unordered_set<string, SvHash, SvEq>;
  using Base::count;
  using Base::find;
  Base::iterator find(string_view k) { return Base::find(string(k)); }
  size_t count(string_view k) const { return Base::count(string(k)); }
};
#endif

// Specialized value for window hashes — every row the bulk writeback
// creates is exactly {seen_count: int, time_updated: ms-string}, and the
// generic two-node inner map costs ~3x as much to build.  Any write that
// doesn't fit this shape DEMOTES the entry into the generic `hashes` map
// (see demote_window), so the observable command surface is identical.
struct WinVal {
  int64_t seen;
  string updated;
};

inline bool parse_i64(string_view s, int64_t* out) {
  if (s.empty()) return false;
  int64_t v = 0;
  size_t i = 0;
  bool neg = s[0] == '-';
  if (neg) i = 1;
  if (i >= s.size()) return false;
  for (; i < s.size(); i++) {
    if (s[i] < '0' || s[i] > '9') return false;
    v = v * 10 + (s[i] - '0');
  }
  *out = neg ? -v : v;
  return true;
}

struct Store {
  SvMap<string> strings;
  SvMap<SvMap<string>> hashes;
  SvMap<WinVal> windows;  // hash-kind, specialized (see WinVal)
  SvMap<SvSet> sets;
  SvMap<std::deque<string>> lists;
  std::mutex mu;
  // native id generation for the bulk writeback
  char id_prefix[17];
  uint64_t id_counter = 0;

  Store() {
    // 4 hex chars: with the counter the id stays unique per store, and
    // the whole "%s-%010llx" id fits std::string's 15-char SSO buffer
    // — the bulk writeback otherwise pays two heap allocations per
    // fresh window row just for the id and its map-key copy.
    std::random_device rd;
    std::snprintf(id_prefix, sizeof id_prefix, "%04x", rd() & 0xffff);
  }

  // WRONGTYPE guard identical to the Python impl's _check_type.
  // `windows` is hash-kind: it conflicts with everything except hashes.
  template <typename Owner>
  bool wrongtype(string_view key, const Owner& owner) const {
    bool owner_is_hash = (const void*)&owner == (const void*)&hashes;
    if ((const void*)&owner != (const void*)&strings &&
        strings.count(key))
      return true;
    if (!owner_is_hash && hashes.count(key)) return true;
    if (!owner_is_hash && windows.count(key)) return true;
    if ((const void*)&owner != (const void*)&sets && sets.count(key))
      return true;
    if ((const void*)&owner != (const void*)&lists && lists.count(key))
      return true;
    return false;
  }

  // Move a specialized window entry into the generic hash map (an
  // off-schema write is about to land); returns the generic hash.
  SvMap<string>& demote_window(string_view key) {
    auto wit = windows.find(key);
    auto& h = hashes[string(key)];
    if (wit != windows.end()) {
      char tmp[24];
      int n = std::snprintf(tmp, sizeof tmp, "%lld",
                            (long long)wit->second.seen);
      h.emplace("seen_count", string(tmp, (size_t)n));
      h.emplace("time_updated", std::move(wit->second.updated));
      windows.erase(wit);
    }
    return h;
  }

  string fresh_id() {
    char buf[40];
    std::snprintf(buf, sizeof buf, "%s-%010llx", id_prefix,
                  (unsigned long long)id_counter++);
    return string(buf);
  }

  // One window row's value update, shared by both bulk writers: the
  // specialized WinVal path unless the uuid already lives as a generic
  // hash (created through the per-command path).
  void bump_window(const string& wuuid, int64_t count,
                   const string& stamp_s, bool absolute) {
    auto ghit = hashes.find(string_view(wuuid));
    if (ghit != hashes.end()) {
      auto& wh = ghit->second;
      char tmp[24];
      int tmp_len;
      auto sit = wh.find(string_view("seen_count"));
      if (absolute) {
        tmp_len = std::snprintf(tmp, sizeof tmp, "%lld", (long long)count);
      } else {
        int64_t cur = 0;
        if (sit != wh.end()) parse_i64(sit->second, &cur);
        cur += count;
        tmp_len = std::snprintf(tmp, sizeof tmp, "%lld", (long long)cur);
      }
      if (sit == wh.end())
        wh.emplace("seen_count", string(tmp, (size_t)tmp_len));
      else
        sit->second.assign(tmp, (size_t)tmp_len);
      auto uit = wh.find(string_view("time_updated"));
      if (uit == wh.end())
        wh.emplace("time_updated", stamp_s);
      else
        uit->second = stamp_s;
      return;
    }
    auto wvit = windows.find(string_view(wuuid));
    if (wvit == windows.end()) {
      windows.emplace(wuuid, WinVal{count, stamp_s});
    } else {
      if (absolute)
        wvit->second.seen = count;
      else
        wvit->second.seen += count;
      wvit->second.updated = stamp_s;
    }
  }
};

// FNV-1a over the bytes, and splitmix64's finalizer: the window digest's
// hashes (io/fakeredis.py mirrors both).
inline uint64_t fnv1a64(string_view s) {
  uint64_t h = 0xcbf29ce484222325ULL;
  for (unsigned char c : s) {
    h ^= c;
    h *= 0x100000001b3ULL;
  }
  return h;
}

inline uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

const char* kWrongType =
    "WRONGTYPE Operation against a key holding the wrong kind of value";

inline bool ieq(string_view a, const char* b) {
  size_t n = std::strlen(b);
  if (a.size() != n) return false;
  for (size_t i = 0; i < n; i++) {
    char c = a[i];
    if (c >= 'a' && c <= 'z') c = (char)(c - 32);
    if (c != b[i]) return false;
  }
  return true;
}


void run_cmd(Store& st, int32_t argc, string_view* a, Reply& r) {
  if (argc < 1) {
    r.error("ERR empty command");
    return;
  }
  string_view name = a[0];
  if (ieq(name, "PING")) {
    r.simple("PONG");
  } else if (ieq(name, "FLUSHALL")) {
    st.strings.clear();
    st.hashes.clear();
    st.windows.clear();
    st.sets.clear();
    st.lists.clear();
    r.simple("OK");
  } else if (ieq(name, "SET")) {
    if (argc != 3) return r.error("ERR wrong number of arguments for 'set'");
    string key(a[1]);
    if (st.wrongtype(key, st.strings)) return r.error(kWrongType);
    st.strings[key] = string(a[2]);
    r.simple("OK");
  } else if (ieq(name, "GET")) {
    if (argc != 2) return r.error("ERR wrong number of arguments for 'get'");
    string key(a[1]);
    if (st.wrongtype(key, st.strings)) return r.error(kWrongType);
    auto it = st.strings.find(key);
    if (it == st.strings.end()) return r.nil();
    r.bulk(it->second);
  } else if (ieq(name, "SADD")) {
    if (argc < 3) return r.error("ERR wrong number of arguments for 'sadd'");
    string key(a[1]);
    if (st.wrongtype(key, st.sets)) return r.error(kWrongType);
    auto& s = st.sets[key];
    int64_t added = 0;
    for (int32_t i = 2; i < argc; i++) {
      if (s.emplace(a[i]).second) added++;
    }
    r.integer(added);
  } else if (ieq(name, "SMEMBERS")) {
    if (argc != 2)
      return r.error("ERR wrong number of arguments for 'smembers'");
    string key(a[1]);
    if (st.wrongtype(key, st.sets)) return r.error(kWrongType);
    auto it = st.sets.find(key);
    std::vector<string> members;
    if (it != st.sets.end())
      members.assign(it->second.begin(), it->second.end());
    std::sort(members.begin(), members.end());  // Python impl sorts
    r.array_header((int64_t)members.size());
    for (const auto& m : members) r.bulk(m);
  } else if (ieq(name, "HSET")) {
    if (argc < 4 || (argc - 2) % 2)
      return r.error("ERR wrong number of arguments for 'hset'");
    string key(a[1]);
    if (st.wrongtype(key, st.hashes)) return r.error(kWrongType);
    // generic writes to a specialized window entry demote it first
    auto& h = st.windows.count(a[1]) ? st.demote_window(a[1])
                                     : st.hashes[key];
    int64_t added = 0;
    for (int32_t i = 2; i + 1 < argc; i += 2) {
      string f(a[i]);
      if (!h.count(f)) added++;
      h[std::move(f)] = string(a[i + 1]);
    }
    r.integer(added);
  } else if (ieq(name, "HGET")) {
    if (argc != 3) return r.error("ERR wrong number of arguments for 'hget'");
    string key(a[1]);
    if (st.wrongtype(key, st.hashes)) return r.error(kWrongType);
    auto wv = st.windows.find(a[1]);
    if (wv != st.windows.end()) {
      if (a[2] == string_view("seen_count")) {
        char tmp[24];
        int tl = std::snprintf(tmp, sizeof tmp, "%lld",
                               (long long)wv->second.seen);
        return r.bulk(string_view(tmp, (size_t)tl));
      }
      if (a[2] == string_view("time_updated"))
        return r.bulk(wv->second.updated);
      return r.nil();
    }
    auto it = st.hashes.find(key);
    if (it == st.hashes.end()) return r.nil();
    auto f = it->second.find(string(a[2]));
    if (f == it->second.end()) return r.nil();
    r.bulk(f->second);
  } else if (ieq(name, "HDEL")) {
    if (argc < 3) return r.error("ERR wrong number of arguments for 'hdel'");
    string key(a[1]);
    if (st.wrongtype(key, st.hashes)) return r.error(kWrongType);
    if (st.windows.count(a[1])) {
      bool touches_schema = false;
      for (int32_t i = 2; i < argc; i++)
        if (a[i] == string_view("seen_count") ||
            a[i] == string_view("time_updated"))
          touches_schema = true;
      // deleting only absent fields must not cost the specialization
      if (touches_schema) st.demote_window(a[1]);
    }
    auto it = st.hashes.find(key);
    int64_t removed = 0;
    if (it != st.hashes.end()) {
      for (int32_t i = 2; i < argc; i++) removed += it->second.erase(string(a[i]));
      if (it->second.empty()) st.hashes.erase(it);
    }
    r.integer(removed);
  } else if (ieq(name, "HGETALL")) {
    if (argc != 2)
      return r.error("ERR wrong number of arguments for 'hgetall'");
    string key(a[1]);
    if (st.wrongtype(key, st.hashes)) return r.error(kWrongType);
    auto wv = st.windows.find(a[1]);
    if (wv != st.windows.end()) {
      char tmp[24];
      int tl = std::snprintf(tmp, sizeof tmp, "%lld",
                             (long long)wv->second.seen);
      r.array_header(4);
      r.bulk("seen_count");
      r.bulk(string_view(tmp, (size_t)tl));
      r.bulk("time_updated");
      r.bulk(wv->second.updated);
      return;
    }
    auto it = st.hashes.find(key);
    if (it == st.hashes.end()) return r.array_header(0);
    r.array_header((int64_t)it->second.size() * 2);
    for (const auto& kv : it->second) {
      r.bulk(kv.first);
      r.bulk(kv.second);
    }
  } else if (ieq(name, "HINCRBY")) {
    if (argc != 4)
      return r.error("ERR wrong number of arguments for 'hincrby'");
    string key(a[1]);
    if (st.wrongtype(key, st.hashes)) return r.error(kWrongType);
    int64_t amount;
    if (!parse_i64(a[3], &amount))
      return r.error("ERR value is not an integer or out of range");
    auto wv = st.windows.find(a[1]);
    if (wv != st.windows.end()) {
      if (a[2] == string_view("seen_count")) {
        wv->second.seen += amount;
        return r.integer(wv->second.seen);
      }
      if (a[2] == string_view("time_updated")) {
        int64_t cur;
        if (!parse_i64(wv->second.updated, &cur))
          return r.error("ERR hash value is not an integer");
        cur += amount;
        char tmp[24];
        int tl = std::snprintf(tmp, sizeof tmp, "%lld", (long long)cur);
        wv->second.updated.assign(tmp, (size_t)tl);
        return r.integer(cur);
      }
      // off-schema field: fall back to a generic hash
      st.demote_window(a[1]);
    }
    auto& h = st.hashes[key];
    string f(a[2]);
    int64_t cur = 0;
    auto it = h.find(f);
    if (it != h.end() && !parse_i64(it->second, &cur))
      return r.error("ERR hash value is not an integer");
    cur += amount;
    char tmp[24];
    std::snprintf(tmp, sizeof tmp, "%lld", (long long)cur);
    h[std::move(f)] = tmp;
    r.integer(cur);
  } else if (ieq(name, "LPUSH")) {
    if (argc < 3) return r.error("ERR wrong number of arguments for 'lpush'");
    string key(a[1]);
    if (st.wrongtype(key, st.lists)) return r.error(kWrongType);
    auto& l = st.lists[key];
    for (int32_t i = 2; i < argc; i++) l.push_front(string(a[i]));
    r.integer((int64_t)l.size());
  } else if (ieq(name, "LLEN")) {
    if (argc != 2) return r.error("ERR wrong number of arguments for 'llen'");
    string key(a[1]);
    if (st.wrongtype(key, st.lists)) return r.error(kWrongType);
    auto it = st.lists.find(key);
    r.integer(it == st.lists.end() ? 0 : (int64_t)it->second.size());
  } else if (ieq(name, "LRANGE")) {
    if (argc != 4)
      return r.error("ERR wrong number of arguments for 'lrange'");
    string key(a[1]);
    if (st.wrongtype(key, st.lists)) return r.error(kWrongType);
    int64_t i, j;
    if (!parse_i64(a[2], &i) || !parse_i64(a[3], &j))
      return r.error("ERR value is not an integer or out of range");
    auto it = st.lists.find(key);
    int64_t n = it == st.lists.end() ? 0 : (int64_t)it->second.size();
    if (i < 0) i += n;
    if (j < 0) j += n;
    if (i < 0) i = 0;
    if (j > n - 1) j = n - 1;
    if (i > j || n == 0) return r.array_header(0);
    r.array_header(j - i + 1);
    for (int64_t k = i; k <= j; k++) r.bulk(it->second[(size_t)k]);
  } else {
    string msg = "ERR unknown command '" + string(name) + "'";
    r.error(msg.c_str());
  }
}

}  // namespace

extern "C" {

void* sbr_new() { return new Store(); }
void sbr_free(void* s) { delete static_cast<Store*>(s); }

// Execute one command; returns reply bytes written into out, or
// -(needed) when out_cap is too small.  On overflow the caller re-issues
// the command with a larger buffer — safe because every WRITE command
// has a small fixed-size reply (+OK / :N), so only read-only commands
// (SMEMBERS / HGETALL / LRANGE / GET / HGET) can ever overflow.
//
// That safety is enforced structurally, not assumed: a mutating command
// is refused (without executing) unless the buffer already has at least
// kMinMutatingCap bytes, so the overflow->re-issue path can only ever
// re-run read-only commands.  Any future write command whose reply could
// exceed kMinMutatingCap must raise the constant, and the invariant
// check below makes a violation loud instead of a silent double-apply.
constexpr int64_t kMinMutatingCap = 4096;

inline bool is_mutating(string_view name) {
  return ieq(name, "SET") || ieq(name, "SADD") || ieq(name, "HSET") ||
         ieq(name, "HDEL") || ieq(name, "HINCRBY") ||
         ieq(name, "LPUSH") || ieq(name, "FLUSHALL");
}

int64_t sbr_cmd(void* store, int32_t argc, const char** argv,
                const int64_t* lens, char* out, int64_t out_cap) {
  auto* st = static_cast<Store*>(store);
  std::vector<string_view> a((size_t)argc);
  for (int32_t i = 0; i < argc; i++)
    a[(size_t)i] = string_view(argv[i], (size_t)lens[i]);
  bool mutating = argc > 0 && is_mutating(a[0]);
  if (mutating && out_cap < kMinMutatingCap)
    return -kMinMutatingCap;  // refused BEFORE executing; retry is safe
  Reply r{out, out_cap};
  std::lock_guard<std::mutex> g(st->mu);
  run_cmd(*st, argc, a.data(), r);
  if (mutating && r.len > kMinMutatingCap) std::abort();  // invariant broken
  return r.len <= out_cap ? r.len : -r.len;
}

// Canonical window writeback (AdvertisingSpark.scala:184-208) for n rows
// of (campaign, window_ts, count), entirely in native code:
//   campaign hash probe -> create window/list ids on miss -> LPUSH ts ->
//   HINCRBY seen_count (or HSET when absolute) -> HSET time_updated.
// Blobs are concatenated strings described by offset arrays (n+1 each).
// Returns the number of rows applied.  A WRONGTYPE campaign key skips
// that row (matching the pipelined RESP path, where every command of the
// row errors in-list and the rest of the batch proceeds) — aborting
// mid-batch would make the caller's retained-batch retry double-apply
// the rows before the conflict.
int64_t sbr_write_windows(void* store, int64_t n, const char* camp_blob,
                          const int64_t* camp_off, const char* ts_blob,
                          const int64_t* ts_off, const int64_t* counts,
                          const char* stamp, int64_t stamp_len,
                          int32_t absolute) {
  auto* st = static_cast<Store*>(store);
  string stamp_s(stamp, (size_t)stamp_len);
  std::lock_guard<std::mutex> g(st->mu);
  int64_t applied = 0;
  for (int64_t i = 0; i < n; i++) {
    string camp(camp_blob + camp_off[i],
                (size_t)(camp_off[i + 1] - camp_off[i]));
    string wts(ts_blob + ts_off[i], (size_t)(ts_off[i + 1] - ts_off[i]));
    if (st->wrongtype(camp, st->hashes)) continue;
    // a campaign key sitting in `windows` (possible only if a caller
    // reuses a window uuid as a campaign name) must merge, not shadow
    if (st->windows.count(string_view(camp))) st->demote_window(camp);
    auto& ch = st->hashes[camp];
    auto wit = ch.find(wts);
    string wuuid;
    if (wit == ch.end()) {
      wuuid = st->fresh_id();
      string luuid;
      auto lit_ = ch.find("windows");
      if (lit_ == ch.end()) {
        luuid = st->fresh_id();
        ch["windows"] = luuid;
      } else {
        luuid = lit_->second;
      }
      ch[wts] = wuuid;
      st->lists[luuid].push_front(wts);
    } else {
      wuuid = wit->second;
    }
    st->bump_window(wuuid, counts[i], stamp_s, absolute != 0);
    applied++;
  }
  return applied;
}

// Index-form bulk writeback: campaign NAMES are passed once as a table
// (blob + offsets) and each row is (campaign_index, window_ts_ms, count)
// from plain int arrays — no per-row Python string handling anywhere.
// This is the engine flush path: its pending deltas already live as
// numpy (index, ts, count) triples.  Returns rows applied (WRONGTYPE
// campaign keys skip their rows, like sbr_write_windows), or -2 on an
// out-of-range campaign index (caller bug, not data state — abort).
int64_t sbr_write_windows_idx(void* store, int64_t n,
                              const char* names_blob,
                              const int64_t* names_off, int64_t n_names,
                              const int32_t* ci, const int64_t* ts,
                              const int64_t* counts, const char* stamp,
                              int64_t stamp_len, int32_t absolute) {
  auto* st = static_cast<Store*>(store);
  string stamp_s(stamp, (size_t)stamp_len);
  std::lock_guard<std::mutex> g(st->mu);
  // Mostly-fresh batches (the sliding family writes ~1 row per event at
  // slide granularity) otherwise rehash the window map a dozen times
  // mid-call; bucket reservation is cheap when rows are dup-heavy.
  st->windows.reserve(st->windows.size() + (size_t)n);
  // Per-campaign row counts in one O(n) int pass, so each campaign's
  // hash reserves its growth ONCE instead of rehashing ~15k-node maps
  // mid-stream (rows arrive campaign-grouped; measured ~15% of the
  // bulk write at sliding row volumes).
  std::vector<int64_t> per_campaign((size_t)n_names, 0);
  for (int64_t i = 0; i < n; i++) {
    if (ci[i] >= 0 && ci[i] < n_names) per_campaign[(size_t)ci[i]]++;
  }
  // Resolve each distinct campaign's hash once: rows arrive grouped by
  // drain order (np.nonzero is row-major over the campaign axis), so a
  // one-slot memo removes most outer-map lookups — including the
  // campaign's window LIST deque (deque + mapped-node references are
  // stable across later inserts).  All probes are transparent
  // string_view finds — std::string is constructed only on inserts.
  int32_t last_ci = -1;
  SvMap<string>* ch = nullptr;
  std::deque<string>* clist = nullptr;
  constexpr string_view kWindows = "windows";
  int64_t applied = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t c = ci[i];
    if (c < 0 || c >= n_names) return -2;
    if (c != last_ci) {
      string_view camp(names_blob + names_off[c],
                       (size_t)(names_off[c + 1] - names_off[c]));
      last_ci = c;
      if (st->wrongtype(camp, st->hashes)) {
        ch = nullptr;  // skip this campaign's rows (see sbr_write_windows)
        continue;
      }
      if (st->windows.count(camp)) st->demote_window(camp);
      auto hit = st->hashes.find(camp);
      if (hit == st->hashes.end())
        hit = st->hashes.emplace(string(camp), SvMap<string>()).first;
      ch = &hit->second;
      ch->reserve(ch->size() + (size_t)per_campaign[(size_t)c]);
      clist = nullptr;
    }
    if (ch == nullptr) continue;
    char wts_buf[24];
    int wts_len =
        std::snprintf(wts_buf, sizeof wts_buf, "%lld", (long long)ts[i]);
    string_view wts(wts_buf, (size_t)wts_len);
    auto wit = ch->find(wts);
    if (wit == ch->end()) {
      // Fresh window: register it (list entry + wts->uuid mapping) and
      // write its WinVal DIRECTLY — a just-minted uuid cannot already
      // exist in `hashes` or `windows`, so the two big-map probes
      // bump_window would pay are provably misses.
      if (clist == nullptr) {
        auto lit_ = ch->find(kWindows);
        if (lit_ == ch->end())
          lit_ = ch->emplace(string(kWindows), st->fresh_id()).first;
        clist = &st->lists[lit_->second];
      }
      clist->emplace_front(wts);
      const string& fresh =
          ch->emplace(string(wts), st->fresh_id()).first->second;
      st->windows.emplace(fresh, WinVal{counts[i], stamp_s});
    } else {
      st->bump_window(wit->second, counts[i], stamp_s, absolute != 0);
    }
    applied++;
  }
  return applied;
}

// Whole-store summary of the canonical window rows: over every hash
// field (campaign, window ts) whose value names a window hash, the
// number of windows, the total of their seen_count and an
// order-independent 64-bit digest of (campaign, ts, seen_count) — the
// sum of one mixed hash a row.  Two stores are held to each other in one
// call instead of one command a campaign.  out[0..2] = windows, seen
// total, digest (as int64).
int64_t sbr_window_digest(void* store, int64_t* out) {
  auto* st = static_cast<Store*>(store);
  std::lock_guard<std::mutex> g(st->mu);
  int64_t n = 0, seen = 0;
  uint64_t digest = 0;
  for (const auto& [key, h] : st->hashes) {
    uint64_t hc = fnv1a64(key);
    for (const auto& [field, val] : h) {
      if (field == "windows") continue;
      int64_t count = 0;
      auto wit = st->windows.find(string_view(val));
      if (wit != st->windows.end()) {
        count = wit->second.seen;
      } else {
        auto git = st->hashes.find(string_view(val));
        if (git == st->hashes.end()) continue;
        auto sit = git->second.find(string_view("seen_count"));
        if (sit == git->second.end() || !parse_i64(sit->second, &count))
          continue;
      }
      n++;
      seen += count;
      digest += mix64(hc ^ mix64(fnv1a64(field) ^ mix64((uint64_t)count)));
    }
  }
  out[0] = n;
  out[1] = seen;
  out[2] = (int64_t)digest;
  return 0;
}

}  // extern "C"
