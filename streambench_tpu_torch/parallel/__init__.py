"""The mesh-sharded engines over ``torch.distributed``.

The port of ``streambench_tpu/parallel``: the ``(data, campaign)`` mesh
of ranks (``mesh``), the sharded exact fold and its engine
(``sharded``), the sharded sketch engines (``sketches``: HLL, sliding +
t-digest, session + count-min), sharded reach with its queries evaluated
next to the shards (``reach``), the single controller they share
(``controller``), the collective-cost counter (``collectives``) and the
multi-process engine with its lockstep catchup (``distributed``).
Importing the package starts no process group and touches no card.
"""

from streambench_tpu_torch.parallel.distributed import (
    DistContext,
    DistributedWindowEngine,
    cross_host_barrier,
    global_mesh,
    init_distributed,
    run_distributed_catchup,
)
from streambench_tpu_torch.parallel.mesh import (
    Mesh,
    build_mesh,
    mesh_from_config,
)
from streambench_tpu_torch.parallel.reach import (
    ShardedReachEngine,
    sharded_reach_init,
)
from streambench_tpu_torch.parallel.sharded import (
    ShardedWindowEngine,
    sharded_init_state,
    sharded_step,
)
from streambench_tpu_torch.parallel.sketches import (
    ShardedHLLEngine,
    ShardedSessionCMSEngine,
    ShardedSlidingTDigestEngine,
    sharded_hll_init,
    sharded_hll_step,
)

__all__ = [
    "DistContext",
    "DistributedWindowEngine",
    "Mesh",
    "ShardedHLLEngine",
    "ShardedReachEngine",
    "ShardedSessionCMSEngine",
    "ShardedSlidingTDigestEngine",
    "ShardedWindowEngine",
    "build_mesh",
    "cross_host_barrier",
    "global_mesh",
    "init_distributed",
    "mesh_from_config",
    "run_distributed_catchup",
    "sharded_hll_init",
    "sharded_hll_step",
    "sharded_init_state",
    "sharded_reach_init",
    "sharded_step",
]
