"""Load generator + golden-model oracle: the peer of ``data/src/setup/core.clj``.

All five CLI modes of the reference generator are reimplemented
(``core.clj:259-286``): ``-n`` seed Redis, ``-r -t N`` paced real-time
emission, ``-g`` stats collection, ``-s`` catchup-dataset setup, ``-c``
golden-model correctness check.  The event wire format is byte-compatible
with ``make-kafka-event-at`` (``core.clj:163-181``): a JSON object with
``user_id/page_id/ad_id/ad_type/event_type/event_time/ip_address``, where
``event_time`` is a stringified ms timestamp.

Deliberate fixes over the fork (capabilities, not bugs, are ported):

- ``load-ids`` returning nil (``core.clj:36-45`` ends with a ``println``) is
  fixed: ids actually load from the id files.
- pacing emits due events in batches (one C-formatted block per loop pass,
  parking in a tick sleep only when nothing is due) instead of one
  ``Thread/sleep`` per event, so the generator paces hundreds of thousands
  of events/s on one core; the ">100 ms behind" warning is kept
  (``core.clj:200-202``).
"""

from __future__ import annotations

import ctypes as _ctypes
import json
import os
import random
import time

import numpy as _np
from dataclasses import dataclass
from typing import Callable, Iterable

from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.io.journal import FileBroker, JournalWriter
from streambench_tpu_torch.io.redis_schema import (
    RedisLike,
    read_seen_counts,
    read_stats,
    seed_ad_mapping,
    seed_campaigns,
)
from streambench_tpu_torch.utils.ids import make_ids, now_ms

# Wire-format constants are shared with the encoder: generator emission and
# device-side view_type must index the same tuples or counts silently zero.
from streambench_tpu_torch.encode.encoder import AD_TYPES, EVENT_TYPES

# id-file names, exactly as the reference writes them (core.clj:24-33,47-59)
CAMPAIGN_IDS_FILE = "campaign-ids.txt"
AD_IDS_FILE = "ad-ids.txt"
AD_TO_CAMPAIGN_FILE = "ad-to-campaign-ids.txt"
KAFKA_JSON_FILE = "kafka-json.txt"
SEEN_FILE = "seen.txt"
UPDATED_FILE = "updated.txt"


# ----------------------------------------------------------------------
# id management
# ----------------------------------------------------------------------

def write_ids(campaigns: list[str], ads: list[str], workdir: str = ".") -> None:
    """``write-ids`` (``core.clj:24-33``)."""
    with open(os.path.join(workdir, CAMPAIGN_IDS_FILE), "w") as f:
        f.write("".join(c + "\n" for c in campaigns))
    with open(os.path.join(workdir, AD_IDS_FILE), "w") as f:
        f.write("".join(a + "\n" for a in ads))


def load_ids(workdir: str = ".") -> tuple[list[str], list[str]] | None:
    """``load-ids`` with the nil-return bug fixed (``core.clj:36-45``)."""
    try:
        with open(os.path.join(workdir, CAMPAIGN_IDS_FILE)) as f:
            campaigns = [l.strip() for l in f if l.strip()]
        with open(os.path.join(workdir, AD_IDS_FILE)) as f:
            ads = [l.strip() for l in f if l.strip()]
        return campaigns, ads
    except FileNotFoundError:
        return None


def write_ad_mapping_file(campaigns: list[str], ads: list[str],
                          workdir: str = ".") -> dict[str, str]:
    """``write-to-redis``'s journal side (``core.clj:47-59``): one JSON object
    ``{"<ad>": "<campaign>"}`` per line; returns the mapping."""
    per = len(ads) // len(campaigns)
    mapping: dict[str, str] = {}
    # json.dumps({ad: campaign}) is "{" + quoted ad + ": " + quoted
    # campaign + "}", each quoted by json's own encoder
    quote = json.encoder.encode_basestring_ascii
    lines = []
    for i, campaign in enumerate(campaigns):
        c = quote(campaign)
        for ad in ads[i * per : (i + 1) * per]:
            mapping[ad] = campaign
            lines.append("{%s: %s}\n" % (quote(ad), c))
    with open(os.path.join(workdir, AD_TO_CAMPAIGN_FILE), "w") as f:
        f.write("".join(lines))
    return mapping


def load_ad_mapping_file(path: str) -> dict[str, str]:
    """Read ``ad-to-campaign-ids.txt`` (JSON-object-per-line) **or** the fork's
    CSV format ``ad,campaign`` (``getAdCampaignMap``,
    ``AdvertisingTopologyNative.java:47-56``)."""
    mapping: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                mapping.update(json.loads(line))
            else:
                ad, _, campaign = line.partition(",")
                mapping[ad.strip()] = campaign.strip()
    return mapping


# ----------------------------------------------------------------------
# event synthesis
# ----------------------------------------------------------------------

@dataclass
class EventSource:
    """Synthesizes wire-format ad events (``make-kafka-event-at``,
    ``core.clj:163-181``)."""

    ads: list[str]
    user_ids: list[str]
    page_ids: list[str]
    with_skew: bool = False
    rng: random.Random | None = None

    def __post_init__(self) -> None:
        if self.rng is None:
            self.rng = random.Random()

    def event_at(self, t_ms: int) -> str:
        rng = self.rng
        t = t_ms
        if self.with_skew:
            t += 50 - rng.randrange(100)           # ±50 ms skew
            if rng.randrange(100_000) == 0:        # 1/100k late by ≤60 s
                t -= rng.randrange(60_000)
        return (
            '{"user_id": "%s", "page_id": "%s", "ad_id": "%s", '
            '"ad_type": "%s", "event_type": "%s", "event_time": "%d", '
            '"ip_address": "1.2.3.4"}'
            % (
                rng.choice(self.user_ids),
                rng.choice(self.page_ids),
                rng.choice(self.ads),
                rng.choice(AD_TYPES),
                rng.choice(EVENT_TYPES),
                t,
            )
        )

    def events_at(self, ts_ms: Iterable[int]) -> list[str]:
        return [self.event_at(t) for t in ts_ms]

    # -- native fast path -------------------------------------------------
    # The Python formatter costs ~3 us/event; on a single-core host a paced
    # producer at 100k ev/s would then eat a third of the core the engine
    # under test needs.  The C formatter (native/gen.cpp) renders the same
    # wire format at ~50 ns/event.  RNG streams differ (splitmix64 vs
    # Python's) — irrelevant to correctness: the oracle replays the journal,
    # so only the distributions are contractual (core.clj:163-181).

    def _native_ctx(self):
        if getattr(self, "_nat", None) is None:
            from streambench_tpu_torch import native as _native

            lib = _native.load()
            if lib is None or not all(
                    len(x) == len(self.ads[0]) for x in self.ads):
                self._nat = False
                return False
            ulen = len(self.user_ids[0])
            plen = len(self.page_ids[0])
            if (not all(len(u) == ulen for u in self.user_ids)
                    or not all(len(p) == plen for p in self.page_ids)):
                self._nat = False
                return False
            at_lens = _np.asarray([len(t) for t in AD_TYPES], _np.int32)
            et_lens = _np.asarray([len(t) for t in EVENT_TYPES], _np.int32)
            per_event = lib.sb_format_events_cap(
                ulen, plen, len(self.ads[0]),
                at_lens.ctypes.data_as(_ctypes.POINTER(_ctypes.c_int32)),
                len(AD_TYPES),
                et_lens.ctypes.data_as(_ctypes.POINTER(_ctypes.c_int32)),
                len(EVENT_TYPES))
            self._nat = dict(
                lib=lib,
                users="".join(self.user_ids).encode(), ulen=ulen,
                pages="".join(self.page_ids).encode(), plen=plen,
                ads="".join(self.ads).encode(), alen=len(self.ads[0]),
                at="".join(AD_TYPES).encode(), at_lens=at_lens,
                et="".join(EVENT_TYPES).encode(), et_lens=et_lens,
                # pointers cached once: data_as costs ~2 us/call, paid
                # per paced tick otherwise (arrays are kept alive by the
                # at_lens/et_lens entries above)
                at_lens_p=at_lens.ctypes.data_as(
                    _ctypes.POINTER(_ctypes.c_int32)),
                et_lens_p=et_lens.ctypes.data_as(
                    _ctypes.POINTER(_ctypes.c_int32)),
                per_event=int(per_event),
                state=_ctypes.c_uint64(self.rng.getrandbits(64)),
                # persistent output buffer: create_string_buffer would
                # zero-fill (a hidden memset of the whole capacity) on
                # every call
                buf=_np.empty(0, _np.uint8),
            )
        return self._nat

    def events_blob_at(self, ts_ms: "Iterable[int]") -> bytes | None:
        """Render events as ONE newline-terminated byte block via the
        native formatter; None when the native library is unavailable
        (callers fall back to ``events_at``)."""
        mv = self.events_blob_view(ts_ms)
        return None if mv is None else bytes(mv)

    def events_blob_view(self, ts_ms) -> "memoryview | None":
        """Zero-copy variant of ``events_blob_at``: a memoryview over the
        source's internal buffer, valid until the NEXT call.  The paced
        producer writes it straight to the journal — the bytes() copy
        was a measurable share of producer CPU at high rates."""
        ctx = self._native_ctx()
        if not ctx:
            return None
        ts = (ts_ms if isinstance(ts_ms, _np.ndarray)
              else _np.fromiter(ts_ms, dtype=_np.int64))
        ts = _np.ascontiguousarray(ts, dtype=_np.int64)
        if ts.size == 0:
            return memoryview(b"")
        cap = int(ts.size) * ctx["per_event"]
        if ctx["buf"].size < cap:
            ctx["buf"] = _np.empty(cap, _np.uint8)
        out = ctx["buf"]
        n = ctx["lib"].sb_format_events(
            ctx["users"], ctx["ulen"], len(self.user_ids),
            ctx["pages"], ctx["plen"], len(self.page_ids),
            ctx["ads"], ctx["alen"], len(self.ads),
            ctx["at"], ctx["at_lens_p"], len(AD_TYPES),
            ctx["et"], ctx["et_lens_p"], len(EVENT_TYPES),
            ts.ctypes.data_as(_ctypes.POINTER(_ctypes.c_int64)), ts.size,
            _ctypes.byref(ctx["state"]), 1 if self.with_skew else 0,
            _ctypes.cast(out.ctypes.data, _ctypes.c_char_p), cap)
        if n < 0:
            return None
        return out.data[:n]


# ----------------------------------------------------------------------
# modes
# ----------------------------------------------------------------------

def do_new_setup(r: RedisLike, num_campaigns: int = 100,
                 ads_per_campaign: int = 10,
                 rng: random.Random | None = None,
                 workdir: str = ".") -> list[str]:
    """``-n``: flush Redis, seed the campaigns set (``core.clj:206-213``);
    also writes the id files so a following ``-r`` can load them."""
    campaigns = make_ids(num_campaigns, rng)
    seed_campaigns(r, campaigns)
    ads = make_ids(num_campaigns * ads_per_campaign, rng)
    write_ids(campaigns, ads, workdir)
    mapping = write_ad_mapping_file(campaigns, ads, workdir)
    seed_ad_mapping(r, mapping)
    return campaigns


def do_reseed(r: RedisLike, workdir: str = ".") -> list[str] | None:
    """Re-seed Redis from the EXISTING workdir id files — the
    checkpoint-resume path.  A resumed engine's snapshot (window state,
    sketch rows) and the journaled events are keyed to these exact ids;
    regenerating them (``do_new_setup``) would silently unkey both: every
    replayed event's ad would join to campaign -1 and the resumed run
    would fold empty windows.  Returns None when no id files exist (the
    caller falls back to a fresh ``do_new_setup``)."""
    ids = load_ids(workdir)
    if ids is None:
        return None
    campaigns, ads = ids
    seed_campaigns(r, campaigns)
    mapping = write_ad_mapping_file(campaigns, ads, workdir)
    seed_ad_mapping(r, mapping)
    return campaigns


def do_setup(r: RedisLike | None, cfg: BenchmarkConfig,
             broker: FileBroker | None = None,
             events_num: int | None = None,
             num_campaigns: int = 100,
             ads_per_campaign: int = 10,
             rng: random.Random | None = None,
             workdir: str = ".",
             topic: str | None = None,
             partitions: int = 1,
             progress: Callable[[int], None] | None = None) -> int:
    """``-s``: catchup-simulation setup (``do-setup`` + ``write-to-kafka``,
    ``core.clj:60-98,239-248``).

    Generates ``events_num`` events at 10 ms spacing (``core.clj:94``:
    ``event_time = start + 10*n``), journals every event to
    ``kafka-json.txt``, and appends them to the broker topic when one is
    given.  Seeds Redis (campaigns + join table) when ``r`` is given.
    Returns the number of events written.
    """
    rng = rng or random.Random()
    n_events = int(events_num if events_num is not None else cfg.events_num)
    ids = load_ids(workdir)
    if ids is None:
        campaigns = make_ids(num_campaigns, rng)
        ads = make_ids(num_campaigns * ads_per_campaign, rng)
        write_ids(campaigns, ads, workdir)
    else:
        campaigns, ads = ids
    mapping = write_ad_mapping_file(campaigns, ads, workdir)
    if r is not None:
        seed_campaigns(r, campaigns)
        seed_ad_mapping(r, mapping)

    src = EventSource(
        ads=ads,
        user_ids=make_ids(100, rng),
        page_ids=make_ids(100, rng),
        with_skew=False,
        rng=rng,
    )
    start = now_ms()
    topic = topic or cfg.kafka_topic
    # Truncate the topic alongside the journal: -s defines a fresh dataset,
    # and oracle (kafka-json.txt) and topic must stay in lockstep.
    # One writer per topic partition, round-robin by event index — the
    # broker peer of `create_kafka_topic --partitions $PARTITIONS`
    # (stream-bench.sh:107-115); partition counts stay equal whenever
    # n_events divides evenly, which count-windowed consumers rely on.
    sinks = ([broker.writer(topic, p, append=False)
              for p in range(partitions)] if broker is not None else [])
    written = 0
    # Single-partition fast path: the native formatter renders each batch
    # as one byte block shared by journal and topic (multi-partition keeps
    # the line path — round-robin slicing needs per-event boundaries).
    blob_ok = len(sinks) <= 1 and all(
        hasattr(s, "append_bytes") for s in sinks)
    with open(os.path.join(workdir, KAFKA_JSON_FILE), "wb") as journal:
        batch = 100_000
        for base in range(0, n_events, batch):
            hi = min(base + batch, n_events)
            ts = start + 10 * _np.arange(base, hi, dtype=_np.int64)
            blob = src.events_blob_at(ts) if blob_ok else None
            if blob is not None:
                journal.write(blob)
                if sinks:
                    sinks[0].append_bytes(blob)
            else:
                lines = src.events_at(
                    start + 10 * n for n in range(base, hi))
                journal.write(b"".join(
                    l.encode() + b"\n" for l in lines))
                if sinks:
                    if len(sinks) == 1:
                        sinks[0].append_many(lines)
                    else:
                        for p, sink in enumerate(sinks):
                            off = (p - base) % len(sinks)
                            sink.append_many(lines[off::len(sinks)])
            written = hi
            if progress:
                progress(written)
    for sink in sinks:
        sink.close()
    return written


def run_paced(sink: JournalWriter, throughput: int,
              duration_s: float | None = None,
              max_events: int | None = None,
              with_skew: bool = False,
              workdir: str = ".",
              rng: random.Random | None = None,
              tick_s: float = 0.01,
              num_users: int = 100,
              on_behind: Callable[[float], None] | None = None,
              stop: Callable[[], bool] | None = None) -> int:
    """``-r -t N``: paced emission at ``throughput`` events/s (``run``,
    ``core.clj:183-204``).

    Event ``n`` is scheduled at ``start + n/throughput`` and carries that
    scheduled time as its ``event_time`` — exactly the reference's pacing
    contract (``times`` lazy seq, ``core.clj:190-191``).  Events due in the
    same ~10 ms tick are emitted as one batch, which is what lets a single
    Python process sustain rates the per-event-sleep Clojure loop cannot.
    Returns events emitted.  Stops after ``duration_s`` or ``max_events``,
    or once ``stop()`` is true.  ``stop`` is checked between batches only,
    so the count returned is exactly what reached the sink: a signal that
    raised ``SystemExit`` inside a batch would leave records written but
    not counted.
    """
    ids = load_ids(workdir)
    if ids is None:
        raise FileNotFoundError(
            f"id files not found in {workdir!r}; run -n (new setup) first")
    _, ads = ids
    rng = rng or random.Random()
    src = EventSource(ads=ads, user_ids=make_ids(num_users, rng),
                      page_ids=make_ids(100, rng), with_skew=with_skew,
                      rng=rng)

    period_ns = int(1e9 / throughput)
    # Blob mode: native formatter renders the tick's batch as one byte
    # block straight into the journal (no per-event Python objects) —
    # essential when producer and engine share one core.
    blob_ok = hasattr(sink, "append_bytes")
    last_path = None
    start_ns = time.time_ns()
    sent = 0
    # Stall forensics: the longest single emit and the longest gap
    # between loop iterations (scheduler starvation / oversleep) tell a
    # failing sweep rung WHERE its producer lag came from.
    max_emit_ms = 0.0
    max_gap_ms = 0.0
    last_loop_ns = start_ns
    sub_max = {"ts": 0.0, "fmt": 0.0, "write": 0.0, "flush": 0.0}
    slept = True
    try:
        while True:
            if max_events is not None and sent >= max_events:
                break
            if stop is not None and stop():
                break
            now_ns = time.time_ns()
            if not slept:
                # gap across an intentional sleep is nominal; only a gap
                # between BUSY iterations indicates starvation/oversleep
                max_gap_ms = max(max_gap_ms, (now_ns - last_loop_ns) / 1e6)
            last_loop_ns = now_ns
            slept = False
            if duration_s is not None and now_ns - start_ns >= duration_s * 1e9:
                break
            # Events 0..due-1 are due strictly by schedule (floor, no
            # emit-ahead): with a "+1" here at least one event is always
            # due, the sleep branch never runs, and the loop degenerates
            # into ~8 kHz micro-batches whose per-call overhead IS the
            # producer's throughput ceiling (observed: ~160k ev/s).  The
            # floor form emits each event at most one period late and
            # keeps the intended ~tick_s cadence.
            due = min(
                int((now_ns - start_ns) / period_ns),
                max_events if max_events is not None else 1 << 62,
            )
            # Cap one iteration's emission at 1 s of schedule: after a
            # long scheduler stall the backlog must drain in chunks so the
            # duration/SIGTERM checks keep running (an uncapped burst once
            # held a producer 17 s past its deadline inside one emit).
            due = min(due, sent + throughput)
            if due > sent:
                behind_ms = (now_ns - (start_ns + sent * period_ns)) / 1e6
                if behind_ms > 100 and on_behind:
                    on_behind(behind_ms)  # "Falling behind by: N ms"
                t1 = time.time_ns()
                ts = (start_ns + _np.arange(sent, due, dtype=_np.int64)
                      * period_ns) // 1_000_000
                t2 = time.time_ns()
                blob = src.events_blob_view(ts) if blob_ok else None
                t3 = time.time_ns()
                if blob is not None:
                    # zero-copy: the view targets the source's buffer,
                    # consumed fully by this write before the next format
                    sink.append_bytes(blob)
                else:
                    sink.append_many(src.events_at(ts.tolist()))
                t4 = time.time_ns()
                sub_max["ts"] = max(sub_max["ts"], (t2 - t1) / 1e6)
                sub_max["fmt"] = max(sub_max["fmt"], (t3 - t2) / 1e6)
                sub_max["write"] = max(sub_max["write"], (t4 - t3) / 1e6)
                path_now = "native" if blob is not None else "python"
                if path_now != last_path:
                    # Report every path CHANGE, not just the first batch:
                    # a mid-run fallback to the ~60x slower Python
                    # formatter would otherwise be indistinguishable from
                    # an engine problem in the sweep's numbers.
                    last_path = path_now
                    print(f"formatter: {path_now}", flush=True)
                # Make the batch visible to tailing consumers immediately:
                # producer buffering must not pollute end-to-end latency.
                sink.flush()
                sub_max["flush"] = max(sub_max["flush"],
                                       (time.time_ns() - t4) / 1e6)
                max_emit_ms = max(max_emit_ms,
                                  (time.time_ns() - now_ns) / 1e6)
                sent = due
                # NO rest after an emit: at high rates the next event is
                # due within microseconds, and on a contended single core
                # a sleeping producer pays wake latency + unaccounted
                # emit time every tick — a built-in rate deficit that
                # spirals (measured: 225k/s collapsed to ~50k/s).  The
                # hot loop stays cheap because the emit path is
                # zero-copy C; it parks in the branch below whenever the
                # schedule truly has nothing due.
            else:
                time.sleep(tick_s)
                slept = True
    except SystemExit:
        # STOP_LOAD's SIGTERM (stream-bench.sh:231) raised mid-loop: stop
        # cleanly so the caller still reports/flushes the true count.
        pass
    final_behind = (time.time_ns() - (start_ns + sent * period_ns)) / 1e6
    if on_behind is not None and final_behind > 100:
        on_behind(final_behind)
    print(f"pacing: max_emit={max_emit_ms:.0f}ms max_gap={max_gap_ms:.0f}ms "
          + " ".join(f"max_{k}={v:.0f}ms" for k, v in sub_max.items()),
          flush=True)
    sink.flush()
    return sent


def get_stats(r: RedisLike, workdir: str = ".") -> list[tuple[int, int]]:
    """``-g``: collect (seen, latency) to ``seen.txt``/``updated.txt``
    (``get-stats``, ``core.clj:130-149``)."""
    stats = read_stats(r)
    with open(os.path.join(workdir, SEEN_FILE), "w") as f:
        f.write("".join(f"{seen}\n" for seen, _ in stats))
    with open(os.path.join(workdir, UPDATED_FILE), "w") as f:
        f.write("".join(f"{lat}\n" for _, lat in stats))
    return stats


#: lines parsed together (``_json_values``): the caller's events in
#: chunks of lines, the workdir's journal in blocks of whole lines
_STATS_CHUNK = 1 << 16
_STATS_BLOCK = 1 << 24
#: one value at an offset, as ``json.loads`` scans it; the whitespace
#: ``json.loads`` skips around a value
_scan_json = json.JSONDecoder().scan_once
_JSON_WS = " \t\n\r"


def _json_values(lines: list) -> list:
    """``[json.loads(ln) for ln in lines]``, one C scan a line over the
    lines joined into one text.  A scan's value must end at its own
    line's end (JSON whitespace may follow it there); where one does not,
    or a line is not ASCII, or the lines mix ``str`` and ``bytes``, line
    by line, so that a line the reference rejects raises here too."""
    kind = type(lines[0]) if lines else None
    if kind in (bytes, str) and all(type(ln) is kind for ln in lines):
        joined = (b"\n" if kind is bytes else "\n").join(lines)
        if joined.isascii():
            text = joined.decode("ascii") if kind is bytes else joined
            values = []
            pos = 0
            try:
                for n in map(len, lines):
                    value, end = _scan_json(text, pos)
                    pos += n
                    if end != pos and (end > pos
                                       or text[end:pos].strip(_JSON_WS)):
                        break
                    values.append(value)
                    pos += 1
                else:
                    return values
            except (StopIteration, ValueError):
                pass
    return [json.loads(ln) for ln in lines]


def dostats(workdir: str = ".", time_divisor_ms: int = 10_000,
            events: Iterable[bytes | str] | None = None,
            mapping_path: str | None = None,
            mapping: dict[str, str] | None = None
            ) -> dict[str, dict[int, int]]:
    """The golden model (``dostats``, ``core.clj:101-128``): replay the
    journal in pure Python, count "view" events per (campaign, bucket).

    Returns ``campaign -> {time_bucket -> count}`` with *bucket indices*
    (event_time // divisor), as the Clojure original does.  ``mapping``
    supplies the ad->campaign join directly (tests); else it loads from
    ``mapping_path`` / the workdir file.  The non-blank lines are parsed
    a chunk at a time by ``_json_values``.
    """
    if mapping is None:
        mapping = load_ad_mapping_file(
            mapping_path or os.path.join(workdir, AD_TO_CAMPAIGN_FILE))
    acc: dict[str, dict[int, int]] = {}

    def fold(lines: list) -> None:
        for ev in _json_values([ln for ln in lines if ln.strip()]):
            if ev["event_type"] != "view":
                continue
            campaign = mapping.get(ev["ad_id"])
            if campaign is None:
                continue
            bucket = int(ev["event_time"]) // time_divisor_ms
            per = acc.setdefault(campaign, {})
            per[bucket] = per.get(bucket, 0) + 1

    if events is None:
        with open(os.path.join(workdir, KAFKA_JSON_FILE), "rb") as f:
            rest = b""
            while block := f.read(_STATS_BLOCK):
                block = rest + block
                cut = block.rfind(b"\n") + 1
                fold(block[:cut].split(b"\n"))
                rest = block[cut:]
            fold([rest])
        return acc
    chunk: list = []
    for line in events:
        chunk.append(line)
        if len(chunk) >= _STATS_CHUNK:
            fold(chunk)
            chunk = []
    fold(chunk)
    return acc


def check_correct(r: RedisLike, workdir: str = ".",
                  time_divisor_ms: int = 10_000,
                  log: Callable[[str], None] = print
                  ) -> tuple[int, int, int]:
    """``-c``: diff the golden model against what the engine wrote to Redis
    (``check-correct``, ``core.clj:215-237``).

    Returns ``(correct, differ, missing)`` window counts; prints per-window
    CORRECT/DIFFER lines like the original.
    """
    expected = dostats(workdir, time_divisor_ms)
    actual = read_seen_counts(r)
    correct = differ = missing = 0
    for campaign, per_bucket in expected.items():
        got = actual.get(campaign, {})
        for bucket, want in per_bucket.items():
            window_ts = bucket * time_divisor_ms
            have = got.get(window_ts)
            if have is None:
                missing += 1
                log(f"Campaign: {campaign!r} has no entry for Timestamp: "
                    f"{window_ts}, was expecting {want}")
            elif have != want:
                differ += 1
                log(f"Campaign: {campaign!r} Timestamp: {window_ts} DIFFER "
                    f"in seen count: ({have}, {want})")
            else:
                correct += 1
    return correct, differ, missing
