"""Benchmark configuration: one YAML loader honoring the reference keys.

The reference reads a single YAML file three different ways (Java
``Utils.findAndReadConfigFile`` at ``streaming-benchmark-common/.../Utils.java:29-63``,
Scala manual casts at ``AdvertisingSpark.scala:33-59``, Clojure keywords at
``data/src/setup/core.clj:250-257``).  Here there is exactly one loader and one
frozen dataclass; every key of ``conf/benchmarkConf.yaml:1-39`` is honored with
the reference's defaults, and engine-specific knobs for the TPU engine live
under the ``jax.*`` prefix (same style as ``storm.*`` / ``spark.*`` knobs).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import yaml


class ConfigError(ValueError):
    """Raised on a missing/duplicated/ill-typed configuration source."""


def _as_list(v: Any) -> list[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [str(x) for x in v]
    return [str(v)]


@dataclasses.dataclass(frozen=True)
class BenchmarkConfig:
    """Typed view of ``benchmarkConf.yaml``.

    Field-by-field provenance is the reference config
    (``conf/benchmarkConf.yaml``, line cited per field).  ``raw`` preserves
    the full key->value map so harness code can read any ad-hoc key the same
    way Flink's ``getFlinkConfs`` flattens YAML into a parameter map
    (``AdvertisingTopologyNative.java:535-550``).
    """

    # --- fork keys (file-driven micro-batch experiments) ---
    ad_to_campaign_path: str = ""          # :4
    events_path: str = ""                  # :6
    events_num: int = 10_000_000           # :30  (events.num)
    redis_hashtable: str = "t1"            # :32  (redis.hashtable)
    window_size: int = 5000                # :34  (window.size, count-based)
    shared_file: str = "/"                 # :36
    map_partitions: int = 3                # :38  (map.partitions)
    reduce_partitions: int = 1             # :39  (reduce.partitions)

    # --- pristine-YSB keys ---
    kafka_brokers: tuple[str, ...] = ("localhost",)   # :8-9
    zookeeper_servers: tuple[str, ...] = ("localhost",)  # :11-12
    kafka_port: int = 9092                 # :14
    zookeeper_port: int = 2181             # :15
    redis_host: str = "localhost"          # :16
    redis_port: int = 6379                 # (Jedis default, AdvertisingSpark.scala:177)
    kafka_topic: str = "test1"             # :17
    kafka_partitions: int = 1              # :18
    # Real-cluster opt-in (new key): a non-empty bootstrap string selects
    # the confluent-kafka adapter (io.kafka.make_broker); empty keeps the
    # hermetic file-journal broker.  The harness maps the KAFKA_BROKERS
    # env var here (the reference's firehose IS Kafka,
    # stream-bench.sh:107-115).
    kafka_bootstrap: str = ""              # kafka.bootstrap
    # Hermetic-broker opt-in (new key): route make_broker to the fake
    # Kafka cluster (io.fakekafka) instead of the file journal — with an
    # empty bootstrap the in-process cluster, with host:port a
    # FakeKafkaServer process (START_KAFKA).  Default-off: the file
    # journal stays byte-identical.
    kafka_fake: bool = False               # kafka.fake
    process_hosts: int = 1                 # :20
    process_cores: int = 4                 # :21
    storm_workers: int = 1                 # :24
    storm_ackers: int = 2                  # :25
    spark_batchtime: int = 2000            # :28

    # --- TPU-engine knobs (new; same namespacing style as storm.*/spark.*) ---
    jax_batch_size: int = 8192             # events per device micro-batch
    jax_encode_workers: int = 1            # parallel encode threads (>1 =
    #   per-thread native encoders; ctypes releases the GIL, so this
    #   scales on multi-core hosts.  Exact-count engines only — sketch
    #   engines need one consistent intern table.  Default off: the CI
    #   host is single-core)
    jax_scan_batches: int = 8              # batches folded per device dispatch
    #   (catchup mode stacks this many micro-batches and folds them in one
    #   lax.scan call, amortizing per-dispatch latency; streaming mode and
    #   engines without a scanned kernel ignore it)
    jax_buffer_timeout_ms: int = 100       # Flink bufferTimeout analog
    #   (AdvertisingTopologyNative.java:77-79: latency/throughput tradeoff)
    jax_num_campaigns: int = 100           # key cardinality (core.clj:15)
    jax_ads_per_campaign: int = 10         # core.clj:56 / JsonGenerator.java:50-51
    jax_window_slots: int = 16             # open tumbling windows kept on device
    #   (CampaignProcessorCommon.java:37 keeps a 10-window LRU)
    jax_time_divisor_ms: int = 10_000      # window length (CampaignProcessorCommon.java:28)
    jax_flush_interval_ms: int = 1000      # flusher cadence (CampaignProcessorCommon.java:41-54)
    jax_allowed_lateness_ms: int = 60_000  # generator's max late-by (core.clj:170-173)
    # Snapshot cadence: 0 = after every flush (the default; snapshots are
    # ~10 KB so this is cheap and keeps the crash-replay window to a single
    # flush).  >0 trades a longer at-least-once replay window for fewer
    # writes.
    jax_checkpoint_interval_ms: int = 0
    jax_mesh_shape: tuple[int, ...] = (1,)  # device mesh (batch axis first)
    jax_mesh_axes: tuple[str, ...] = ("data",)
    # --- staged ingest pipeline (engine.ingest) ---
    # "off" (default) keeps the serial read->encode->dispatch loop
    # byte-identical; "on" always overlaps the three stages on threads
    # with bounded queues; "auto" enables the overlap only where it can
    # pay — block-mode ingest (native encoder + poll_block reader) on a
    # multi-core host (one core just timeslices the stages).
    jax_ingest_pipeline: str = "off"
    jax_ingest_block_queue: int = 4    # bounded read-ahead: raw journal
    #   blocks the reader thread may buffer ahead of the encode stage
    #   (backpressure bound; each block is <= one scan chunk of bytes)
    jax_ingest_batch_queue: int = 4    # encoded-batch groups the encode
    #   stage may buffer ahead of device dispatch
    jax_use_native_encoder: bool = True    # C++ fast-path when the .so is built
    # --- on-device event decode (ops.devdecode) ---
    # "off" (default) keeps host encoding byte-identical; "on" ships raw
    # journal blocks to the device and does bytes->columns + view filter
    # + ad->campaign hash join + window fold inside the jitted step
    # (exact-count engines with the generator's uuid wire format only —
    # unsupported engines fall back to host encode with a warning);
    # "auto" enables it only where the measured A/B says the device arm
    # wins (bench.py records it; accelerator backends default on).
    jax_decode_device: str = "off"
    # --- production-cardinality sketch memory (ops.salsa / ops.cms) ---
    # "fixed" (default) keeps the [D, Wd] int32 count-min plane
    # byte-identical; "salsa" swaps in the SALSA merge-on-overflow
    # sketch — uint8 cells + packed merge bitmaps, ~1.09 bytes/cell vs
    # 4, counters widen to 16/32 bits only where traffic lands; "auto"
    # follows the measured cms-family winner (ops.methodbench,
    # backend/cms/W<Wd>) where one exists, else stays fixed.
    jax_cms_mode: str = "fixed"
    # SALSA starting counter width: 8 (default; pairs/quads form on
    # overflow) or 16 (every pair pre-merged — fewer settles on
    # heavy-uniform streams at 2x the bytes/cell).
    jax_cms_cell_bits: int = 8
    # 1 (default) = single-stage; 2 = SF-style two-stage: a small
    # query-side sketch (width Wd/8) refreshed with post-update fat
    # estimates — heavy-hitter queries gather from the small plane;
    # the fat stage keeps update linearity for sharded psum merges
    # (single-device engines only; the sharded session engine refuses
    # stages=2 because small-stage maxima do not merge soundly).
    jax_cms_stages: int = 1
    # --- sliced sliding windows (ops.sliding) ---
    # "off" keeps the unrolled per-k sliding fold (S ring-claim passes
    # per batch); "on" forces the sliced fold — one claim + one scatter
    # into a [C, S, W] slide-bucket plane, window counts summed from S
    # live buckets only at drain time, flushed rows bit-identical;
    # "auto" (default) uses the sliced fold wherever the plane fits and
    # the measured sliding-family winner (ops.methodbench) agrees.
    jax_sliding_sliced: str = "auto"
    # --- robustness knobs (ROBUSTNESS.md; the reference has none of these:
    # a Redis outage is a Jedis stack trace and enableCheckpointing is
    # commented out, AdvertisingTopologyNative.java:81-84) ---
    jax_sink_exactly_once: bool = False    # epoch-fenced idempotent sink
    #   writeback (ROBUSTNESS.md "Exactly-once"): every flush carries a
    #   (writer_epoch, flush_seq) fence record in the same pipeline
    #   batch, resume detects unfenced post-snapshot flushes via the
    #   sink fence, and affected windows are reconciled with absolute
    #   writes from a cumulative per-window ledger.  Default off: the
    #   serial hot path stays byte-identical (no ledger, no fence reads,
    #   native array writeback intact)
    jax_sink_retry_base_ms: int = 100      # first writer backoff after a
    #   failed window writeback; doubles per consecutive failure
    jax_sink_retry_cap_ms: int = 5000      # backoff ceiling (keeps the retry
    #   cadence near the 1 Hz flush once an outage persists)
    jax_sink_dirty_cap_rows: int = 1 << 18  # retained-row high-water mark:
    #   past this the failed-write buffer is coalesced by (campaign, window)
    #   and a warning is logged; rows are NEVER dropped (dropping = silent
    #   undercount, the failure mode the retained-batch design exists to
    #   prevent)
    jax_supervisor_restarts: int = 3       # consecutive NO-PROGRESS restarts
    #   (checkpoint offset did not advance) before the supervisor gives up;
    #   restarts that advance the offset reset the count
    jax_supervisor_backoff_base_ms: int = 50   # restart backoff, doubled per
    #   consecutive crash, with jitter
    jax_supervisor_backoff_cap_ms: int = 2000  # restart backoff ceiling
    jax_deadletter_enabled: bool = False   # journal malformed events to a
    #   <topic>-deadletter topic instead of only counting them (bad_lines);
    #   off by default: the reference drops bad tuples silently
    # --- live telemetry (obs/; default-off: the hot path must stay
    # byte-identical when observability is not asked for) ---
    jax_metrics_interval_ms: int = 0       # >0 starts the MetricsSampler at
    #   this cadence, journaling snapshot records to <workdir>/metrics.jsonl
    jax_metrics_port: int = -1             # >=0 serves a localhost Prometheus
    #   text-exposition endpoint (0 = OS-assigned ephemeral port, printed
    #   at startup); <0 = no endpoint
    jax_metrics_max_bytes: int = 0         # >0 caps metrics.jsonl: a record
    #   that would push past it rotates the file to metrics.jsonl.1 first,
    #   so a week-long chaos sweep holds <= ~2x this on disk (0 = unbounded)
    # --- window-lifecycle attribution + crash flight recorder (obs/ —
    # both default-off: the serial hot path stays byte-identical
    # when neither is asked for) ---
    jax_obs_lifecycle: bool = False        # stamp each window's journey
    #   (first read, last encode, fold, flush submit, sink ack) and
    #   decompose its YSB latency into ingest/encode/fold/flush/sink
    #   segment histograms ("attribution" in metrics.jsonl;
    #   `python -m streambench_tpu.obs attribution` renders them)
    jax_obs_flightrec: bool = False        # feed a bounded postmortem ring
    #   (runner ticks, checkpoint offsets, ingest stalls, supervisor
    #   annotations) dumped to <workdir>/flight_<reason>.jsonl on crash,
    #   give_up, fatal exception, or SIGTERM
    jax_obs_flightrec_capacity: int = 512  # flight-ring record capacity
    # --- span tracing + measured occupancy + SLO gates (obs/ —
    # all default-off: the serial hot path stays byte-identical) ---
    jax_obs_spans: bool = False            # bounded thread-aware span ring
    #   (every Tracer stage span + ingest read spans), dumped as Chrome
    #   trace-event JSON <workdir>/trace_<pid>.json at exit — loadable
    #   in perfetto; flight-recorder dumps embed the last closed spans
    jax_obs_spans_capacity: int = 4096     # span-ring capacity (evictions
    #   are counted, never silent)
    jax_obs_occupancy: bool = False        # MEASURED device occupancy:
    #   1-in-N dispatches are timed to block_until_ready completion and
    #   extrapolated into streambench_device_busy_ratio + a per-dispatch
    #   device-time histogram; also arms the recompile detector
    #   (streambench_compiles_total, steady-state-zero after warmup)
    jax_obs_occupancy_sample: int = 32     # the N in 1-in-N dispatch
    #   sampling (1 = time every dispatch; bench probes only)
    jax_slo_p99_ms: int = 0                # >0: window-latency objective —
    #   a written window whose e2e latency exceeds this is "bad"; burn
    #   rate of the error budget is tracked over fast+slow windows and
    #   breaches are journaled + gauged (streambench_slo_*), with a
    #   pass/fail verdict in the RunStats close line
    jax_slo_rate_evps: int = 0             # >0: ingest-rate objective —
    #   a sample interval below this rate (while events flow) is "bad"
    jax_slo_budget: float = 0.01           # error budget: fraction of
    #   windows/intervals allowed to be bad before the burn rate hits 1
    jax_slo_fast_s: int = 30               # fast burn window (onset)
    jax_slo_slow_s: int = 180              # slow burn window (confirmation)
    # --- data-path observability (obs/ — transfer + device
    # memory ledgers, shard skew, triggered profiler capture; all
    # default-off: the hot path stays byte-identical) ---
    jax_obs_xfer: bool = False             # host->device transfer ledger:
    #   exact payload bytes per dispatch keyed by wire format (packed/
    #   unpacked/devdecode) -> streambench_xfer_* + measured bytes/event
    jax_obs_xfer_sample: int = 32          # the N in 1-in-N timed
    #   device_put+block_until_ready transfer samples (0 = bytes only)
    jax_obs_devmem: bool = False           # device-memory ledger: compiled
    #   kernel memory_analysis footprints (once, post-warmup) + a sampled
    #   jax.live_arrays census -> "devmem" block + streambench_devmem_*
    jax_obs_shard: bool = False            # per-shard routed-row/drop skew
    #   gauges for the sharded engines (streambench_shard_rows{shard=},
    #   imbalance ratio); needs --sharded
    jax_obs_capture: bool = False          # bounded TRIGGERED profiler
    #   capture: SLO breach transition / SIGUSR2 / one-shot fires a short
    #   jax.profiler window into <workdir>/xprof_<ms>_<reason>/
    jax_obs_capture_cooldown_s: float = 60.0  # min seconds between captures
    jax_obs_capture_max: int = 3           # hard cap on captures per run
    jax_obs_capture_window_s: float = 3.0  # seconds each capture records
    jax_obs_capture_oneshot: bool = False  # fire one capture at startup
    #   (smoke tests / "trace the warm ramp" runs)
    # --- live reach-query serving (reach/ — the MinHash∪HLL
    # audience-overlap engine behind the pubsub/store surface) ---
    jax_reach_k: int = 256                 # MinHash signature slots per
    #   campaign ([C, k] running minima); the overlap estimate's
    #   relative-to-union error is ~1/sqrt(k) (6.25% at the default)
    jax_reach_queue_depth: int = 512       # bounded reach-query queue:
    #   beyond this depth the OLDEST pending query is shed (answered
    #   {"shed": true}, streambench_reach_shed_total counts it)
    jax_reach_slo_p99_ms: int = 0          # >0: reach-serving latency
    #   objective — a served query slower than this (submit -> reply)
    #   is "bad"; judged by the same two-window burn-rate machinery as
    #   jax.slo.p99.ms, surfaced under objective="reach"
    # --- reach scale-out (reach/{cache,replica} — the
    # (epoch, campaign-set) result cache + snapshot-shipped read
    # replicas) ---
    jax_reach_cache_capacity: int = 4096   # bounded LRU of query
    #   answers keyed (epoch, canonical campaign-set, kind); epoch
    #   bumps invalidate wholesale; 0 disables
    jax_reach_ship_dir: str = ""           # non-empty: ship (epoch,
    #   planes, watermark) records into <dir>/dimensions.log at the
    #   interval below — the log replica processes tail
    #   (python -m streambench_tpu_torch.reach.replica --ship <dir>)
    jax_reach_ship_interval_ms: int = 1000  # replica shipping cadence:
    #   the replica staleness bound is cadence + poll when healthy
    jax_reach_ship_delta: str = "off"      # O(ΔC) dirty-row delta
    #   shipping (reach/deltaship): "on" ships chain-stamped
    #   delta records between periodic full bases, "auto" enables it
    #   at >= 4096 campaigns (below that the full gather is trivially
    #   cheap), "off" keeps the full-plane path
    # --- query-path observability (obs/queryattr — the
    # serving-tier mirror of jax.obs.lifecycle; default-off: reply
    # payloads stay byte-identical) ---
    jax_obs_query: bool = False            # stamp each reach query's
    #   journey (admission, queue-exit, dispatch submit/complete, reply
    #   write) and decompose its submit->reply latency into
    #   queue/batch/dispatch/reply segment histograms
    #   (streambench_reach_segment_ms) + the ingest-contention ratio
    #   when jax.obs.spans is also on; replies gain a "server" block
    jax_obs_query_slowlog: int = 128       # slow-query log capacity:
    #   full decompositions of queries over jax.reach.slo.p99.ms,
    #   oldest-first eviction (counted, never silent)
    jax_obs_query_sample: int = 1          # 1-in-N reach dispatches
    #   additionally timed to block_until_ready for the pure device
    #   histogram (the worker materializes results synchronously, so
    #   even 1 costs only a split stamp)
    # --- fleet observability (obs/fleet + obs/clock —
    # default-off: replica replies stay byte-identical) ---
    jax_obs_fleet: bool = False            # freshness ledger: shipped
    #   records carry fold/ship-submit wall stamps + the writer's
    #   pub/sub origin, writer-attached replies gain the freshness hop
    #   decomposition, and the metrics journal is role-stamped
    #   "writer" for the FleetCollector; replicas opt in with --fleet
    #   (replies then decompose their evidence age into
    #   fold_lag/ship_wait/tail_lag/serve hops summing to staleness_ms,
    #   with the writer clock offset estimated over the pub/sub ping
    #   verb and never applied past the jitter threshold)
    # --- multi-tenant host + admission control (engine/tenants +
    # obs/tenancy + obs/admission — default-off: without
    # jax.tenants the single-engine path is byte-identical) ---
    jax_tenants: str = ""                  # "name:kind,..." tenant spec
    #   (kinds: exact/hll/sliding/session/reach/hllx).  Non-empty runs
    #   the MultiTenantHost: every tenant gets its own engine + a
    #   tenant= labeled view over one shared registry, and the
    #   DeviceTimeLedger attributes device time per tenant
    jax_admission_enabled: bool = False    # measurement-actuated
    #   admission control: defer/shed an aggressor tenant's ingest
    #   when the blame matrix says its dispatches burn a victim
    #   tenant's SLO budget (priming + hysteresis + cooldowns;
    #   decisions journaled with evidence)
    jax_admission_breach_ticks: int = 2    # consecutive breaching
    #   controller steps before a gate goes up (hysteresis)
    jax_admission_healthy_ticks: int = 4   # consecutive healthy steps
    #   before every gate is released
    jax_admission_escalate_ticks: int = 6  # defer-gate steps without
    #   recovery before escalating defer -> shed
    jax_admission_cooldown_s: float = 3.0  # min seconds between gate
    #   changes (breaches inside it count as holds, never actions)

    raw: Mapping[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    @property
    def kafka_bootstrap_servers(self) -> str | None:
        """Bootstrap string when a real cluster is opted in, else None
        (the ``io.kafka.make_broker`` switch input)."""
        return self.kafka_bootstrap or None

    @property
    def kafka_host_list(self) -> str:
        """``host:port,host:port`` string, as built at ``core.clj:252-254``."""
        return ",".join(f"{b}:{self.kafka_port}" for b in self.kafka_brokers)

    @property
    def num_ads(self) -> int:
        return self.jax_num_campaigns * self.jax_ads_per_campaign

    def get(self, key: str, default: Any = None) -> Any:
        """Raw-key access (``spark.batchtime`` style), like the JVM readers."""
        return self.raw.get(key, default)

    # ------------------------------------------------------------------
    @staticmethod
    def from_mapping(conf: Mapping[str, Any]) -> "BenchmarkConfig":
        def geti(key: str, default: int) -> int:
            v = conf.get(key, default)
            try:
                return int(v)
            except (TypeError, ValueError) as e:
                raise ConfigError(f"config key {key!r} is not an int: {v!r}") from e

        def gets(key: str, default: str) -> str:
            v = conf.get(key, default)
            return default if v is None else str(v)

        def getf(key: str, default: float) -> float:
            v = conf.get(key, default)
            try:
                return float(v)
            except (TypeError, ValueError) as e:
                raise ConfigError(
                    f"config key {key!r} is not a number: {v!r}") from e

        def getb(key: str, default: bool) -> bool:
            v = conf.get(key, default)
            if isinstance(v, bool):
                return v
            if isinstance(v, str):
                if v.lower() in ("true", "yes", "1"):
                    return True
                if v.lower() in ("false", "no", "0"):
                    return False
            if isinstance(v, int):
                return bool(v)
            raise ConfigError(f"config key {key!r} is not a bool: {v!r}")

        ingest_mode = gets("jax.ingest.pipeline", "off").strip().lower()
        if ingest_mode not in ("off", "on", "auto"):
            raise ConfigError(
                f"config key 'jax.ingest.pipeline' must be one of "
                f"off/on/auto: {ingest_mode!r}")
        decode_mode = gets("jax.decode.device", "off").strip().lower()
        if decode_mode not in ("off", "on", "auto"):
            raise ConfigError(
                f"config key 'jax.decode.device' must be one of "
                f"off/on/auto: {decode_mode!r}")
        ship_delta = gets("jax.reach.ship.delta", "off").strip().lower()
        if ship_delta not in ("off", "on", "auto"):
            raise ConfigError(
                f"config key 'jax.reach.ship.delta' must be one of "
                f"off/on/auto: {ship_delta!r}")
        sliced_mode = gets("jax.sliding.sliced", "auto").strip().lower()
        if sliced_mode not in ("off", "on", "auto"):
            raise ConfigError(
                f"config key 'jax.sliding.sliced' must be one of "
                f"off/on/auto: {sliced_mode!r}")
        cms_mode = gets("jax.cms.mode", "fixed").strip().lower()
        if cms_mode not in ("fixed", "salsa", "auto"):
            raise ConfigError(
                f"config key 'jax.cms.mode' must be one of "
                f"fixed/salsa/auto: {cms_mode!r}")
        cms_bits = geti("jax.cms.cell.bits", 8)
        if cms_bits not in (8, 16):
            raise ConfigError(
                f"config key 'jax.cms.cell.bits' must be 8 or 16: "
                f"{cms_bits!r}")
        cms_stages = geti("jax.cms.stages", 1)
        if cms_stages not in (1, 2):
            raise ConfigError(
                f"config key 'jax.cms.stages' must be 1 or 2: "
                f"{cms_stages!r}")
        mesh_shape = conf.get("jax.mesh.shape", (1,))
        mesh_axes = conf.get("jax.mesh.axes", ("data",))
        try:
            mesh_shape_t = tuple(int(x) for x in _as_list(mesh_shape)) or (1,)
        except (TypeError, ValueError) as e:
            raise ConfigError(
                f"config key 'jax.mesh.shape' is not a list of ints: {mesh_shape!r}"
            ) from e
        return BenchmarkConfig(
            ad_to_campaign_path=gets("ad_to_campaign_path", ""),
            events_path=gets("events_path", ""),
            events_num=geti("events.num", 10_000_000),
            redis_hashtable=gets("redis.hashtable", "t1"),
            window_size=geti("window.size", 5000),
            shared_file=gets("shared_file", "/"),
            map_partitions=geti("map.partitions", 3),
            reduce_partitions=geti("reduce.partitions", 1),
            kafka_brokers=tuple(_as_list(conf.get("kafka.brokers", ["localhost"]))),
            zookeeper_servers=tuple(_as_list(conf.get("zookeeper.servers", ["localhost"]))),
            kafka_port=geti("kafka.port", 9092),
            zookeeper_port=geti("zookeeper.port", 2181),
            redis_host=gets("redis.host", "localhost"),
            redis_port=geti("redis.port", 6379),
            kafka_topic=gets("kafka.topic", "test1"),
            kafka_partitions=geti("kafka.partitions", 1),
            kafka_bootstrap=gets("kafka.bootstrap", ""),
            kafka_fake=getb("kafka.fake", False),
            process_hosts=geti("process.hosts", 1),
            process_cores=geti("process.cores", 4),
            storm_workers=geti("storm.workers", 1),
            storm_ackers=geti("storm.ackers", 2),
            spark_batchtime=geti("spark.batchtime", 2000),
            jax_batch_size=geti("jax.batch.size", 8192),
            jax_encode_workers=geti("jax.encode.workers", 1),
            jax_scan_batches=geti("jax.scan.batches", 8),
            jax_buffer_timeout_ms=geti("jax.buffer.timeout.ms", 100),
            jax_num_campaigns=geti("jax.num.campaigns", 100),
            jax_ads_per_campaign=geti("jax.ads.per.campaign", 10),
            jax_window_slots=geti("jax.window.slots", 16),
            jax_time_divisor_ms=geti("jax.time.divisor.ms", 10_000),
            jax_flush_interval_ms=geti("jax.flush.interval.ms", 1000),
            jax_allowed_lateness_ms=geti("jax.allowed.lateness.ms", 60_000),
            jax_checkpoint_interval_ms=geti("jax.checkpoint.interval.ms", 0),
            jax_mesh_shape=mesh_shape_t,
            jax_mesh_axes=tuple(_as_list(mesh_axes)) or ("data",),
            jax_ingest_pipeline=ingest_mode,
            jax_ingest_block_queue=max(geti("jax.ingest.block.queue", 4), 1),
            jax_ingest_batch_queue=max(geti("jax.ingest.batch.queue", 4), 1),
            jax_use_native_encoder=getb("jax.use.native.encoder", True),
            jax_decode_device=decode_mode,
            jax_cms_mode=cms_mode,
            jax_cms_cell_bits=cms_bits,
            jax_cms_stages=cms_stages,
            jax_sliding_sliced=sliced_mode,
            jax_sink_exactly_once=getb("jax.sink.exactly_once", False),
            jax_sink_retry_base_ms=geti("jax.sink.retry.base.ms", 100),
            jax_sink_retry_cap_ms=geti("jax.sink.retry.cap.ms", 5000),
            jax_sink_dirty_cap_rows=geti("jax.sink.dirty.cap.rows", 1 << 18),
            jax_supervisor_restarts=geti("jax.supervisor.restarts", 3),
            jax_supervisor_backoff_base_ms=geti(
                "jax.supervisor.backoff.base.ms", 50),
            jax_supervisor_backoff_cap_ms=geti(
                "jax.supervisor.backoff.cap.ms", 2000),
            jax_deadletter_enabled=getb("jax.deadletter.enabled", False),
            jax_metrics_interval_ms=geti("jax.metrics.interval.ms", 0),
            jax_metrics_port=geti("jax.metrics.port", -1),
            jax_metrics_max_bytes=geti("jax.metrics.max.bytes", 0),
            jax_obs_lifecycle=getb("jax.obs.lifecycle", False),
            jax_obs_flightrec=getb("jax.obs.flightrec.enabled", False),
            jax_obs_flightrec_capacity=max(
                geti("jax.obs.flightrec.capacity", 512), 8),
            jax_obs_spans=getb("jax.obs.spans", False),
            jax_obs_spans_capacity=max(
                geti("jax.obs.spans.capacity", 4096), 16),
            jax_obs_occupancy=getb("jax.obs.occupancy", False),
            jax_obs_occupancy_sample=max(
                geti("jax.obs.occupancy.sample", 32), 1),
            jax_slo_p99_ms=max(geti("jax.slo.p99.ms", 0), 0),
            jax_slo_rate_evps=max(geti("jax.slo.rate.evps", 0), 0),
            jax_slo_budget=getf("jax.slo.budget", 0.01),
            jax_slo_fast_s=max(geti("jax.slo.window.fast.s", 30), 1),
            jax_slo_slow_s=max(geti("jax.slo.window.slow.s", 180), 1),
            jax_obs_xfer=getb("jax.obs.xfer", False),
            jax_obs_xfer_sample=max(geti("jax.obs.xfer.sample", 32), 0),
            jax_obs_devmem=getb("jax.obs.devmem", False),
            jax_obs_shard=getb("jax.obs.shard", False),
            jax_obs_capture=getb("jax.obs.capture.enabled", False),
            jax_obs_capture_cooldown_s=max(
                getf("jax.obs.capture.cooldown.s", 60.0), 0.0),
            jax_obs_capture_max=max(geti("jax.obs.capture.max", 3), 1),
            jax_obs_capture_window_s=max(
                getf("jax.obs.capture.window.s", 3.0), 0.1),
            jax_obs_capture_oneshot=getb("jax.obs.capture.oneshot", False),
            jax_reach_k=max(geti("jax.reach.k", 256), 1),
            jax_reach_queue_depth=max(
                geti("jax.reach.queue.depth", 512), 1),
            jax_reach_slo_p99_ms=max(geti("jax.reach.slo.p99.ms", 0), 0),
            jax_reach_cache_capacity=max(
                geti("jax.reach.cache.capacity", 4096), 0),
            jax_reach_ship_dir=gets("jax.reach.ship.dir", ""),
            jax_reach_ship_interval_ms=max(
                geti("jax.reach.ship.interval.ms", 1000), 1),
            jax_reach_ship_delta=ship_delta,
            jax_obs_query=getb("jax.obs.query", False),
            jax_obs_fleet=getb("jax.obs.fleet", False),
            jax_obs_query_slowlog=max(
                geti("jax.obs.query.slowlog", 128), 1),
            jax_obs_query_sample=max(geti("jax.obs.query.sample", 1), 1),
            jax_tenants=gets("jax.tenants", ""),
            jax_admission_enabled=getb("jax.admission.enabled", False),
            jax_admission_breach_ticks=max(
                geti("jax.admission.breach.ticks", 2), 1),
            jax_admission_healthy_ticks=max(
                geti("jax.admission.healthy.ticks", 4), 1),
            jax_admission_escalate_ticks=max(
                geti("jax.admission.escalate.ticks", 6), 1),
            jax_admission_cooldown_s=max(
                getf("jax.admission.cooldown.s", 3.0), 0.0),
            raw=dict(conf),
        )


def find_and_read_config_file(path: str | os.PathLike[str]) -> BenchmarkConfig:
    """Load a YAML config from the filesystem.

    Mirrors ``Utils.findAndReadConfigFile`` (``Utils.java:29-63``): the file
    must exist, parse as a YAML mapping, and be non-empty; any failure raises
    rather than silently proceeding.
    """
    path = os.fspath(path)
    if not os.path.exists(path):
        raise ConfigError(f"config file not found: {path}")
    with open(path, "r", encoding="utf-8") as f:
        try:
            data = yaml.safe_load(f)
        except yaml.YAMLError as e:
            raise ConfigError(f"config file is not valid YAML: {path}: {e}") from e
    if data is None:
        raise ConfigError(f"config file is empty: {path}")
    if not isinstance(data, dict):
        raise ConfigError(f"config file is not a YAML mapping: {path}")
    return BenchmarkConfig.from_mapping(data)


def load_config_or_default(path: str | os.PathLike[str], *,
                           is_default_path: bool) -> "BenchmarkConfig":
    """CLI convention shared by the datagen/handoff entry points: a
    MISSING file at the parser's DEFAULT path falls back to built-in
    defaults (hermetic runs need no config file), while an explicitly
    given path must exist.  Parse errors always raise ``ConfigError``."""
    import sys

    path = os.fspath(path)
    if is_default_path and not os.path.exists(path):
        print(f"note: config file not found: {path}; using built-in "
              "defaults", file=sys.stderr)
        return default_config()
    return find_and_read_config_file(path)


def default_config(**overrides: Any) -> BenchmarkConfig:
    """A config with the checked-in ``benchmarkConf.yaml`` defaults.

    ``overrides`` use dataclass field names (``redis_port=...``), mainly for
    tests and embedded runs.
    """
    base = BenchmarkConfig.from_mapping({})
    return dataclasses.replace(base, **overrides) if overrides else base


def write_local_conf(path: str | os.PathLike[str], conf: Mapping[str, Any]) -> None:
    """Generate a ``localConf.yaml``, as SETUP does (``stream-bench.sh:123-138``)."""
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(dict(conf), f, default_flow_style=False, sort_keys=True)
