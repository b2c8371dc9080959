"""The canonical YSB Redis schema, plus the fork's latency-hash format.

Schema (codified by the reader at ``data/src/setup/core.clj:130-149`` and the
writer at ``AdvertisingSpark.scala:184-208``):

- ``campaigns`` : SET of campaign ids (seeded by ``do-new-setup``,
  ``core.clj:206-213``)
- ``<ad_id>`` : STRING -> campaign id (join side-table, seeded per
  ``RedisHelper.java:64-78`` / ``gen-ads`` ``core.clj:151-161``)
- ``<campaign>`` : HASH { <window_ts> -> <windowUUID>, "windows" -> <listUUID> }
- ``<listUUID>`` : LIST of window_ts strings
- ``<windowUUID>`` : HASH { "seen_count" -> int, "time_updated" -> ms }

Fork latency hash (``AdvertisingTopologyNative.java:521-532``): one HASH named
by ``redis.hashtable`` holding ``thread_idx``, ``running_time:<idx>`` and
``<event_ts>:<idx> -> latency_ms`` entries.

All functions take either a ``RespClient`` or a ``FakeRedisStore`` (adapted
in-process) so engine code and tests share one code path.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Iterable, Mapping

from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.resp import RespClient, RespError
from streambench_tpu_torch.utils.ids import now_ms


class StoreAdapter:
    """RespClient-shaped convenience API over an in-process FakeRedisStore."""

    def __init__(self, store: FakeRedisStore):
        self._store = store
        # pipeline fast path: command name -> bound store method; callers
        # of pipeline_execute always pass str args, so the dispatch
        # coercions are pure overhead for these
        self._fast = {name: getattr(store, name.lower())
                      for name in ("HGET", "HSET", "HINCRBY", "LPUSH",
                                   "SADD", "GET", "SET")}

    def execute(self, *args: Any) -> Any:
        return self._store.dispatch(list(args))

    def pipeline_execute(self, commands: Iterable[tuple]) -> list[Any]:
        # Match RespClient semantics: per-command errors are returned
        # in-list, not raised, and never abort the rest of the batch.
        # Hot commands bypass `dispatch` (its per-arg string coercion +
        # name lookup is ~10x the actual dict operation; the canonical
        # window writeback pushes 10^5+ commands per flush through here).
        fast = self._fast
        out: list[Any] = []
        for c in commands:
            try:
                h = fast.get(c[0])
                out.append(h(*c[1:]) if h is not None
                           else self._store.dispatch(list(c)))
            except RespError as e:
                out.append(e)
        return out

    def close(self) -> None:
        pass

    def __getattr__(self, name: str):
        # ping/get/set/hget/... share names with FakeRedisStore methods.
        attr = getattr(self._store, name)
        if name == "hgetall":
            def hgetall(key: str) -> dict[str, str]:
                flat = attr(key)
                return dict(zip(flat[0::2], flat[1::2]))
            return hgetall
        return attr


RedisLike = RespClient | StoreAdapter


# Fresh opaque keys for window/list structures.  The reference uses
# UUID.randomUUID (AdvertisingSpark.scala:190,196) but the -g reader treats
# them as opaque strings, so a random-prefix counter is schema-equivalent —
# and ~6x cheaper than uuid.uuid4 (os.urandom per call), which matters at
# catchup flush sizes (10^5 new windows per flush).  The prefix is re-drawn
# per pid so forked workers writing one Redis can't collide.
_ID_STATE: dict = {"pid": None}


def _fresh_id() -> str:
    st = _ID_STATE
    if st["pid"] != os.getpid():
        st.update(pid=os.getpid(), prefix=os.urandom(8).hex(),
                  counter=itertools.count())
    return f"{st['prefix']}-{next(st['counter']):010x}"


def as_redis(obj: RespClient | StoreAdapter | FakeRedisStore) -> RedisLike:
    if isinstance(obj, FakeRedisStore):
        return StoreAdapter(obj)
    return obj


# ----------------------------------------------------------------------
# Seeding (generator -n mode / RedisHelper.prepareRedis)
# ----------------------------------------------------------------------

def seed_campaigns(r: RedisLike, campaigns: Iterable[str],
                   flush: bool = True) -> None:
    """``do-new-setup`` (``core.clj:206-213``): FLUSHALL + SADD campaigns."""
    if flush:
        r.execute("FLUSHALL")
    for c in campaigns:
        r.execute("SADD", "campaigns", c)


def seed_ad_mapping(r: RedisLike, ad_to_campaign: Mapping[str, str]) -> None:
    """Join side-table: ``SET <ad_id> <campaign>`` (``RedisHelper.java:73-77``)."""
    r.pipeline_execute([("SET", ad, camp) for ad, camp in ad_to_campaign.items()])


def load_ad_mapping(r: RedisLike, ad_ids: Iterable[str]) -> dict[str, str]:
    """Bulk ``GET`` of the join table (RedisAdCampaignCache warm-up path)."""
    ads = list(ad_ids)
    vals = r.pipeline_execute([("GET", a) for a in ads])
    return {a: v for a, v in zip(ads, vals) if isinstance(v, str)}


# ----------------------------------------------------------------------
# Writeback fence (exactly-once mode, ROBUSTNESS.md "Exactly-once")
# ----------------------------------------------------------------------
# One HASH per (topic, partition) holding the writeback fence:
#   intent -> flush_seq of the LAST ATTEMPTED flush (written FIRST)
#   epoch  -> writer epoch that attempted it
#   seq    -> flush_seq of the last FULLY LANDED flush (written LAST)
# A flush pipeline is [intent/epoch HSET] + window rows + [seq HSET], so
# any partial application leaves intent > seq — the signature resume
# detection keys on.  The key never enters the ``campaigns`` SET, so the
# canonical schema walk (walk_windows) and every stats reader skip it.

def fence_key(topic: str = "", partition: int = 0) -> str:
    return f"__streambench:fence:{topic}:{int(partition)}"


def read_fence(r: RedisLike, key: str) -> tuple[int, int, int]:
    """``(epoch, seq, intent)`` from the sink, zeros where absent.
    One pipeline round trip (one fault decision under chaos wrappers);
    non-string replies (missing field, WRONGTYPE error) read as 0."""
    vals = r.pipeline_execute([("HGET", key, "epoch"),
                               ("HGET", key, "seq"),
                               ("HGET", key, "intent")])
    out = []
    for v in vals:
        try:
            out.append(int(v) if isinstance(v, str) else 0)
        except ValueError:
            out.append(0)
    return out[0], out[1], out[2]


def claim_epoch(r: RedisLike, key: str, epoch: int) -> None:
    """Advertise a new writer epoch (zombie guard: older epochs abort
    their flushes once they observe it).  Leaves seq/intent untouched —
    seq continuity across epochs is what resume detection compares."""
    r.execute("HSET", key, "epoch", str(int(epoch)))


# ----------------------------------------------------------------------
# Canonical window writeback (AdvertisingSpark.scala:184-208)
# ----------------------------------------------------------------------

def write_window(r: RedisLike, campaign: str, window_ts: int | str,
                 seen_count: int, time_updated: int | None = None) -> None:
    """One window's writeback, exactly the Spark ``writeWindow`` algorithm.

    HINCRBY on ``seen_count`` (not SET) so partial flushes of a still-open
    window accumulate, matching the reference semantics.
    """
    wts = str(window_ts)
    window_uuid = r.execute("HGET", campaign, wts)
    if window_uuid is None:
        window_uuid = _fresh_id()
        r.execute("HSET", campaign, wts, window_uuid)
        window_list_uuid = r.execute("HGET", campaign, "windows")
        if window_list_uuid is None:
            window_list_uuid = _fresh_id()
            r.execute("HSET", campaign, "windows", window_list_uuid)
        r.execute("LPUSH", window_list_uuid, wts)
    r.execute("HINCRBY", window_uuid, "seen_count", int(seen_count))
    r.execute("HSET", window_uuid, "time_updated",
              str(now_ms() if time_updated is None else int(time_updated)))


def write_windows_pipelined(r: RedisLike,
                            entries: Iterable[tuple[str, int, int]],
                            time_updated: int | None = None,
                            absolute: bool = False,
                            cache: dict | None = None,
                            fence: tuple[str, int, int] | None = None) -> int:
    """Flush many ``(campaign, window_ts, count)`` rows efficiently.

    Same observable schema as ``write_window``, but the existence probes for
    all rows ride one pipeline and the mutations another — two round trips
    per flush instead of the reference's 5+ per window
    (``AdvertisingSpark.scala:189-205``).  Returns the number of rows written.

    ``absolute=True`` HSETs ``seen_count`` instead of HINCRBY — for
    aggregators whose flushed value is an absolute snapshot rather than a
    delta (HLL distinct estimates: re-flushing a still-open window must
    replace, not accumulate).

    ``cache`` (caller-owned, initially ``{}``) memoizes window/list UUIDs
    across flushes.  Sound whenever the caller is the only writer of these
    campaigns — the reference makes the same assumption (each campaign's
    windows are written by exactly one keyed CampaignProcessor instance,
    ``AdvertisingTopology.java:232-233``).  Cuts the two existence probes
    per already-seen row, which at catchup flush sizes (10^5 rows) is most
    of the Redis round-trip volume.

    ``fence=(key, epoch, seq)`` brackets the mutation batch with the
    exactly-once fence records: ``HSET key intent seq / epoch epoch`` as
    the FIRST command and ``HSET key seq seq`` as the LAST, so the sink
    states a pipeline can be left in are exactly {nothing, intent-only,
    intent+prefix, fully-landed} — the signature
    ``engine/pipeline._RedisWriter`` and resume detection key on.
    """
    rows = [(c, str(w), int(n)) for c, w, n in entries]
    if not rows and fence is None:
        return 0
    stamp = str(now_ms() if time_updated is None else int(time_updated))

    win_cache = cache.setdefault("win", {}) if cache is not None else {}
    list_cache = cache.setdefault("list", {}) if cache is not None else {}
    if isinstance(r, StoreAdapter):
        store = r._store
        if hasattr(store, "write_windows_bulk"):
            # Native store: the whole probe/create/LPUSH/HINCRBY sequence
            # runs in C (~100 ns/row); it maintains its own existence
            # view, so no client-side id cache is involved.  In-process
            # there is no partial-apply failure mode, so the fence rides
            # as one HSET after the bulk write.
            store.write_windows_bulk(rows, stamp, absolute)
            if fence is not None:
                key, epoch, seq = fence
                r.execute("HSET", key, "intent", str(seq),
                          "epoch", str(epoch), "seq", str(seq))
            return len(rows)
        # In-process Python store: one lock hold, no command tuples — the
        # embedded-state-store fast path (the RESP/TCP path below stays
        # byte-identical for real Redis).
        _bulk_write_windows(store, rows, stamp, absolute,
                            win_cache, list_cache, fence=fence)
        return len(rows)
    # Probe only rows the cache can't resolve.
    need = [i for i, (c, w, _) in enumerate(rows)
            if (c, w) not in win_cache]
    if need:
        probes = r.pipeline_execute(
            [("HGET", rows[i][0], rows[i][1]) for i in need]
            + [("HGET", rows[i][0], "windows") for i in need]
        )
        for j, i in enumerate(need):
            c, w, _ = rows[i]
            # Probe replies can be RespError (e.g. WRONGTYPE on a mistyped
            # campaign key) which is truthy; caching one would permanently
            # aim every later flush at a key derived from str(error).
            if isinstance(probes[j], str):
                win_cache[(c, w)] = probes[j]
            lp = probes[len(need) + j]
            if isinstance(lp, str) and c not in list_cache:
                list_cache[c] = lp

    # Assign UUIDs for missing structures; campaigns and even whole rows may
    # repeat within one flush, so the cache doubles as the local view of
    # what this call just created.
    # Stage this call's new ids locally and commit them to the caller's
    # cache only after the pipeline lands: caching an id whose HSET/LPUSH
    # registration then failed would make every retry write to an orphan
    # hash the campaign never references (permanently missing windows).
    new_win: dict[tuple[str, str], str] = {}
    new_list: dict[str, str] = {}
    # mut index of the HSET that registers each fresh id: an id whose
    # registration errored (e.g. WRONGTYPE campaign key) must NOT enter the
    # cache, else every later flush would cache-hit an orphan hash the
    # campaign never references.
    win_reg: dict[tuple[str, str], int] = {}
    list_reg: dict[str, int] = {}
    muts: list[tuple] = []
    for campaign, wts, count in rows:
        wuuid = win_cache.get((campaign, wts)) or new_win.get(
            (campaign, wts))
        if wuuid is None:
            wuuid = _fresh_id()
            new_win[(campaign, wts)] = wuuid
            luuid = list_cache.get(campaign) or new_list.get(campaign)
            if luuid is None:
                luuid = _fresh_id()
                new_list[campaign] = luuid
                list_reg[campaign] = len(muts)
                muts.append(("HSET", campaign, "windows", luuid))
            # Registration order matters under the partial-apply fault
            # (exactly-once chaos): the ``wts -> wuuid`` HSET is the
            # COMMIT of the window's creation and must come LAST of the
            # trio.  Any torn prefix then leaves either no registration
            # (retry recreates everything) or a list entry without the
            # hash mapping (harmless: the walk skips it, the retry
            # re-registers).  The old order could land the hash mapping
            # WITHOUT the list entry — the retry would cache-hit the
            # uuid and never repair the list, leaving a window invisible
            # to every canonical reader.
            muts.append(("LPUSH", luuid, wts))
            win_reg[(campaign, wts)] = len(muts)
            muts.append(("HSET", campaign, wts, wuuid))
        if absolute:
            muts.append(("HSET", wuuid, "seen_count", str(count),
                         "time_updated", stamp))
        else:
            muts.append(("HINCRBY", wuuid, "seen_count", str(count)))
            muts.append(("HSET", wuuid, "time_updated", stamp))
    off = 0
    if fence is not None:
        fkey, epoch, seq = fence
        # intent+epoch FIRST, commit seq LAST: any partial application
        # leaves intent > seq on the sink
        muts = ([("HSET", fkey, "intent", str(seq), "epoch", str(epoch))]
                + muts + [("HSET", fkey, "seq", str(seq))])
        off = 1
    res = r.pipeline_execute(muts)
    for key, i in win_reg.items():
        if isinstance(res[i + off], RespError):
            del new_win[key]
    for campaign, i in list_reg.items():
        if isinstance(res[i + off], RespError):
            del new_list[campaign]
    win_cache.update(new_win)
    list_cache.update(new_list)
    return len(rows)


def _bulk_write_windows(store: FakeRedisStore, rows, stamp: str,
                        absolute: bool, win_cache: dict,
                        list_cache: dict, fence=None) -> None:
    """Canonical-schema writeback directly against the in-process store's
    dicts, one lock hold for the whole flush.  Observable state is
    IDENTICAL to the pipelined path (same keys, same hash fields, same
    list contents) — asserted by the schema round-trip tests.  A fence
    lands under the same lock hold: rows + fence are truly atomic here
    (the partial-apply failure mode only exists on the command path)."""
    with store._lock:
        hashes = store._hashes
        lists = store._lists
        holders = (store._strings, store._hashes, store._sets, store._lists)

        def clashes(key: str, owner: dict) -> bool:
            return any(key in d for d in holders if d is not owner)

        for campaign, wts, count in rows:
            wuuid = win_cache.get((campaign, wts))
            fresh_wuuid = False
            if wuuid is None:
                probe = hashes.get(campaign)
                if probe is None and clashes(campaign, hashes):
                    # Mirror the per-command pipeline: that path would
                    # WRONGTYPE every command of this row in-list and
                    # carry on with the rest of the batch — so skip the
                    # row, never shadow the key and never raise (a raise
                    # here would double-apply rows 0..k-1 when the
                    # flusher retries the retained batch).
                    continue
                wuuid = probe.get(wts) if probe else None
                if wuuid is None:
                    wuuid = _fresh_id()
                    fresh_wuuid = True
                    ch = hashes.setdefault(campaign, {})
                    ch[wts] = wuuid
                    luuid = list_cache.get(campaign) or ch.get("windows")
                    if luuid is None:
                        luuid = _fresh_id()
                        ch["windows"] = luuid
                        list_cache[campaign] = luuid
                        lists.setdefault(luuid, []).insert(0, wts)
                    elif luuid in lists or not clashes(luuid, lists):
                        list_cache[campaign] = luuid
                        lists.setdefault(luuid, []).insert(0, wts)
                    # else: stored list id points at a non-list key — the
                    # per-command LPUSH would error in-list while the
                    # window hash still gets bumped; mirror that.
                win_cache[(campaign, wts)] = wuuid
            if not fresh_wuuid and wuuid not in hashes \
                    and clashes(wuuid, hashes):
                continue  # cached id now a non-hash key: per-command
                # HINCRBY/HSET would error in-list; skip the row
            wh = hashes.setdefault(wuuid, {})
            if absolute:
                wh["seen_count"] = str(count)
            else:
                wh["seen_count"] = str(int(wh.get("seen_count", "0"))
                                       + count)
            wh["time_updated"] = stamp
        if fence is not None:
            fkey, epoch, seq = fence
            fh = hashes.setdefault(fkey, {})
            fh["intent"] = str(seq)
            fh["epoch"] = str(epoch)
            fh["seq"] = str(seq)


# ----------------------------------------------------------------------
# Stats reader (core.clj:130-149 `get-stats`)
# ----------------------------------------------------------------------

def walk_windows(r: RedisLike):
    """The canonical schema walk (``get-stats``, ``core.clj:130-149``):
    campaigns set → per-campaign "windows" list → per-window UUID hash.
    Yields ``(campaign, window_ts_str, window_key)`` — the single source
    of truth every reader builds on."""
    for campaign in r.execute("SMEMBERS", "campaigns"):
        windows_key = r.execute("HGET", campaign, "windows")
        if windows_key is None:
            continue
        n = r.execute("LLEN", windows_key)
        for window_ts in r.execute("LRANGE", windows_key, 0, n):
            window_key = r.execute("HGET", campaign, window_ts)
            if window_key is not None:
                yield campaign, window_ts, window_key


def read_stats(r: RedisLike) -> list[tuple[int, int]]:
    """All ``(seen_count, latency_ms)`` pairs, latency = time_updated −
    window_ts, one row per (campaign, window) — ``get-stats``'s view."""
    out: list[tuple[int, int]] = []
    for _, window_ts, window_key in walk_windows(r):
        seen = r.execute("HGET", window_key, "seen_count")
        updated = r.execute("HGET", window_key, "time_updated")
        if seen is None or updated is None:
            continue
        out.append((int(seen), int(updated) - int(window_ts)))
    return out


def read_window_latencies(r: RedisLike) -> dict[int, int]:
    """Per UNIQUE window: ``window_ts -> final writeback latency`` (ms).

    The canonical walk yields one row per (campaign, window); percentile
    reports over those rows overweight windows with many campaigns and
    collapse to a handful of distinct values (every campaign in a window
    shares its stamps).  The honest latency distribution — what
    ``README.markdown:36-37`` defines — has one sample per window: the
    LAST ``time_updated`` that touched it, minus the window timestamp.
    """
    out: dict[int, int] = {}
    for _, window_ts, window_key in walk_windows(r):
        updated = r.execute("HGET", window_key, "time_updated")
        if updated is None:
            continue
        ts = int(window_ts)
        lat = int(updated) - ts
        if ts not in out or lat > out[ts]:
            out[ts] = lat
    return out


def read_seen_counts(r: RedisLike) -> dict[str, dict[int, int]]:
    """campaign -> {window_ts -> seen_count}; the oracle's comparison view
    (``check-correct``, ``core.clj:215-237``)."""
    out: dict[str, dict[int, int]] = {}
    for campaign in r.execute("SMEMBERS", "campaigns"):
        out.setdefault(campaign, {})
    for campaign, window_ts, window_key in walk_windows(r):
        seen = r.execute("HGET", window_key, "seen_count")
        if seen is not None:
            out[campaign][int(window_ts)] = int(seen)
    return out


# ----------------------------------------------------------------------
# Fork latency hash (AdvertisingTopologyNative.java:521-532)
# ----------------------------------------------------------------------

def dump_latency_hash(r: RedisLike, hashtable: str,
                      latencies: Mapping[int, int], running_time_ms: int) -> int:
    """Per-worker latency dump; returns this worker's 1-based index."""
    idx = r.execute("HINCRBY", hashtable, "thread_idx", 1)
    cmds: list[tuple] = [("HSET", hashtable, f"running_time:{idx}",
                          str(int(running_time_ms)))]
    cmds += [("HSET", hashtable, f"{ts}:{idx}", str(int(lat)))
             for ts, lat in latencies.items()]
    r.pipeline_execute(cmds)
    return idx


def read_latency_hash(r: RedisLike, hashtable: str
                      ) -> tuple[dict[int, int], dict[int, dict[int, int]]]:
    """Inverse of ``dump_latency_hash``.

    Returns ``(running_time_by_idx, {idx: {event_ts: latency_ms}})``.
    """
    flat = r.hgetall(hashtable) if hasattr(r, "hgetall") else {}
    running: dict[int, int] = {}
    per_idx: dict[int, dict[int, int]] = {}
    for field, value in flat.items():
        if field == "thread_idx":
            continue
        name, _, idx_s = field.rpartition(":")
        idx = int(idx_s)
        if name == "running_time":
            running[idx] = int(value)
        else:
            per_idx.setdefault(idx, {})[int(name)] = int(value)
    return running, per_idx
