"""Chaos layer of the PyTorch port: deterministic fault injection and
supervised recovery, copied from ``streambench_tpu/chaos/`` (never
imported from it).  See ROBUSTNESS.md for the failure model.

- ``plan``       -- seeded :class:`FaultPlan`, :class:`CrashScheduler`,
  the simulated :class:`EngineCrash`
- ``inject``     -- :class:`FaultInjector` and its surface wrappers
  (:class:`ChaosRedis`, :class:`ChaosJournalReader`); the fake Kafka
  cluster draws its broker faults from the same injector
- ``supervisor`` -- :class:`Supervisor`, the restart loop with capped
  exponential backoff and no-progress give-up
- ``verify``     -- the at-least-once bound (:func:`check_at_least_once`),
  the exactly-once check (:func:`check_exactly_once`) and the broker-edge
  delivery ledger (:func:`check_kafka_edge`)

The supervisor, the crash scheduler and the sink faults also drive the
reach engine with its query server and replica shipper attached (the
reach storm under a sink outage and crashes).  Not ported yet, each
waiting for the replica fleet and its router: ``netchaos``
(``ChaosPubSub``, faults on the pub/sub query plane),
``fleet_supervisor`` (replica processes), ``ShipChaosFilter`` /
``ship_fault`` / ``attach_ship_chaos`` (faults on the reach ship log)
and the fleet checks of ``verify``.
Importing the package builds nothing and does not initialise CUDA.
"""

from streambench_tpu_torch.chaos.inject import (  # noqa: F401
    ChaosJournalReader,
    ChaosRedis,
    FaultInjector,
)
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
    KafkaEdgeVerdict,
    check_at_least_once,
    check_exactly_once,
    check_kafka_edge,
    replay_note,
    segment_view_counts,
)
