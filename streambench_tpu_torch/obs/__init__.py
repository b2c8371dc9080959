"""Live telemetry of the PyTorch port: the port of ``streambench_tpu/obs/``.

All default-off; importing the package builds nothing and does not
initialise CUDA (the device modules import torch inside the calls that
need it):

- ``registry``  — counters/gauges + O(1) log-bucketed streaming
  histograms (live p50/p95/p99 while the run is going)
- ``sampler``   — background thread journaling one snapshot record per
  ``jax.metrics.interval.ms`` to ``metrics.jsonl`` in the workdir
- ``httpd``     — localhost Prometheus text-exposition endpoint
  (``jax.metrics.port``)
- ``report``    — ``python -m streambench_tpu_torch.obs`` renders a run
  report from ``metrics.jsonl`` and diffs two runs
- ``lifecycle`` — per-window latency attribution: the YSB latency
  decomposed into ingest/encode/fold/flush/sink segments
  (``jax.obs.lifecycle``; ``python -m streambench_tpu_torch.obs
  attribution``)
- ``flightrec`` — bounded crash flight recorder dumping
  ``flight_<reason>.jsonl`` on crash/SIGTERM
  (``jax.obs.flightrec.enabled``)
- ``spans``     — bounded thread-aware span tracer exporting Chrome
  trace-event JSON (``jax.obs.spans``; ``python -m
  streambench_tpu_torch.obs trace`` validates)
- ``occupancy`` — MEASURED device occupancy: sampled CUDA-event-timed
  dispatches -> ``device_busy_ratio``, and the kernel-library build
  detector ``streambench_compiles_*`` (``jax.obs.occupancy``)
- ``slo``       — objectives (``jax.slo.p99.ms``, ``jax.slo.rate.evps``)
  with multi-window burn-rate breach gates and a pass/fail verdict in
  the RunStats close line
- ``regress``   — tolerance-driven A/B comparator over run artifacts or
  metrics journals (``python -m streambench_tpu_torch.obs regress``)
- ``xfer``      — host->device transfer ledger (exact payload bytes per
  dispatch by wire format + sampled CUDA-event-timed copies;
  ``jax.obs.xfer``)
- ``devmem``    — device-memory ledger: K1's launch footprints + the
  CUDA caching allocator's live-block census (``jax.obs.devmem``)
- ``capture``   — bounded TRIGGERED ``torch.profiler`` capture (SLO
  breach / SIGUSR2 / config one-shot, with cooldown + cap;
  ``jax.obs.capture.*``); also owns the one profiler start/stop path
  ``trace.device_trace`` delegates to
- ``queryattr`` — per-query latency attribution for the reach serving
  tier (``jax.obs.query``): submit->reply decomposed into
  queue/batch/dispatch/reply segments that sum to it, a bounded
  slow-query log, and the ingest-contention ratio
  (``streambench_reach_contention_ratio``); ``python -m
  streambench_tpu_torch.obs serve`` renders it
- ``fleet``     — fleet observability (``jax.obs.fleet``): every role's
  ``metrics.jsonl`` merged into one attributed ``fleet.jsonl``
  (``python -m streambench_tpu_torch.obs fleet``), cross-process trace
  stitching (``obs trace --merge``), and the end-to-end reply-freshness
  ledger (``streambench_fleet_freshness_ms{hop=}``)
- ``clock``     — cross-process clock-offset estimation (midpoint method
  over the pub/sub ``ping`` verb, bounded uncertainty, never silently
  applied past a jitter threshold)
- ``diagnose``  — fleet evidence -> ranked bottleneck verdicts, each
  with its knob (pure)
- ``autoscale`` — the controller that turns those verdicts into replica
  count, ship cadence and poll interval actuations

- ``tenancy``   — tenant-scoped views over one shared registry (every
  instrument labeled ``tenant=``) and the device-time ledger: per-tenant
  attributed busy time, the N×N blame matrix of victim waits against
  aggressor busy windows, and its partition check
- ``admission`` — the measurement-actuated admission controller: a
  victim's burn plus the blame matrix's aggressor -> defer, then shed,
  the aggressor's ingest; released on sustained health

Enable on the engine CLI via config keys (``jax.metrics.interval.ms``
> 0 and/or ``jax.metrics.port`` >= 0); embed via::

    registry = MetricsRegistry()
    engine.attach_obs(registry)
    sampler = MetricsSampler(path, interval_ms=1000, registry=registry)
    sampler.add_collector(engine_collector(engine, reader=reader,
                                           runner=runner,
                                           registry=registry))
    sampler.start()
    server = MetricsServer(registry, port=0, refresh=sampler.collect_now)
"""

from streambench_tpu_torch.obs.admission import (  # noqa: F401
    AdmissionController,
)
from streambench_tpu_torch.obs.autoscale import (  # noqa: F401
    AutoscaleController,
)
from streambench_tpu_torch.obs.capture import (  # noqa: F401
    CaptureManager,
    profiler_window,
)
from streambench_tpu_torch.obs.clock import (  # noqa: F401
    offset_from_samples,
    sync_pubsub,
)
from streambench_tpu_torch.obs.devmem import DeviceMemoryLedger  # noqa: F401
from streambench_tpu_torch.obs.diagnose import (  # noqa: F401
    diagnose,
    evidence_window,
)
from streambench_tpu_torch.obs.fleet import (  # noqa: F401
    FleetCollector,
    merge_traces,
    summarize_fleet,
)
from streambench_tpu_torch.obs.flightrec import FlightRecorder  # noqa: F401
from streambench_tpu_torch.obs.httpd import MetricsServer  # noqa: F401
from streambench_tpu_torch.obs.lifecycle import WindowLifecycle  # noqa: F401
from streambench_tpu_torch.obs.occupancy import (  # noqa: F401
    CompileWatcher,
    OccupancySampler,
)
from streambench_tpu_torch.obs.queryattr import QueryLifecycle  # noqa: F401
from streambench_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    MetricsRegistry,
    StreamingHistogram,
)
from streambench_tpu_torch.obs.sampler import (  # noqa: F401
    MetricsSampler,
    engine_collector,
    kafka_collector,
    rss_bytes,
    rss_sample,
)
from streambench_tpu_torch.obs.slo import SloTracker  # noqa: F401
from streambench_tpu_torch.obs.spans import SpanTracer  # noqa: F401
from streambench_tpu_torch.obs.tenancy import (  # noqa: F401
    DeviceTimeLedger,
    TenantRegistry,
)
from streambench_tpu_torch.obs.xfer import (  # noqa: F401
    ShardSkew,
    TransferLedger,
)
