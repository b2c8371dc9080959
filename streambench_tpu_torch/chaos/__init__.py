"""Chaos layer of the PyTorch port: deterministic fault injection and
supervised recovery, copied from ``streambench_tpu/chaos/`` (never
imported from it).  See ROBUSTNESS.md for the failure model.

- ``plan``       -- seeded :class:`FaultPlan`, :class:`CrashScheduler`,
  the simulated :class:`EngineCrash`
- ``inject``     -- :class:`FaultInjector` and its surface wrappers
  (:class:`ChaosRedis`, :class:`ChaosJournalReader`,
  :class:`ShipChaosFilter`); the fake Kafka cluster draws its broker
  faults from the same injector
- ``netchaos``   -- :class:`ChaosPubSub`, the fault-injecting TCP proxy
  over the pub/sub query plane (drops, delays, dups, torn frames,
  partitions)
- ``supervisor`` -- :class:`Supervisor`, the restart loop with capped
  exponential backoff and no-progress give-up
- ``fleet_supervisor`` -- :class:`FleetSupervisor`, the same semantics
  at the replica-process level (crash-kill, backoff restart, give-up)
- ``verify``     -- the at-least-once bound (:func:`check_at_least_once`),
  the exactly-once check (:func:`check_exactly_once`), the fleet
  invariants (:func:`check_fleet_accounting`,
  :func:`check_staleness_bound`, :func:`check_fleet_convergence`) and
  the broker-edge delivery ledger (:func:`check_kafka_edge`)

The supervisor, the crash scheduler and the sink faults also drive the
reach engine with its query server and replica shipper attached (the
reach storm under a sink outage and crashes).
Importing the package builds nothing and does not initialise CUDA.
"""

from streambench_tpu_torch.chaos.fleet_supervisor import (  # noqa: F401
    FleetSupervisor,
    ReplicaSlot,
)
from streambench_tpu_torch.chaos.inject import (  # noqa: F401
    ChaosJournalReader,
    ChaosRedis,
    FaultInjector,
    ShipChaosFilter,
)
from streambench_tpu_torch.chaos.netchaos import ChaosPubSub  # noqa: F401
from streambench_tpu_torch.chaos.plan import (  # noqa: F401
    CrashScheduler,
    EngineCrash,
    FaultPlan,
)
from streambench_tpu_torch.chaos.supervisor import (  # noqa: F401
    Supervisor,
    SupervisorStats,
)
from streambench_tpu_torch.chaos.verify import (  # noqa: F401
    ChaosVerdict,
    FleetVerdict,
    KafkaEdgeVerdict,
    check_at_least_once,
    check_exactly_once,
    check_fleet_accounting,
    check_fleet_convergence,
    check_kafka_edge,
    check_staleness_bound,
    durable_epoch_at,
    final_reach_record,
    replay_note,
    segment_view_counts,
    ship_epoch_timeline,
)
