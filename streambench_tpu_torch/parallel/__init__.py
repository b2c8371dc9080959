"""The mesh-sharded exact engine over ``torch.distributed``.

The port of ``streambench_tpu/parallel``'s exact-count half: the
``(data, campaign)`` mesh of ranks (``mesh``), the sharded fold and its
engine (``sharded``), the collective-cost counter (``collectives``) and
the multi-process engine with its lockstep catchup (``distributed``).
The sharded sketch engines and sharded reach are not ported yet.
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
from streambench_tpu_torch.parallel.sharded import (
    ShardedWindowEngine,
    sharded_init_state,
    sharded_step,
)

__all__ = [
    "DistContext",
    "DistributedWindowEngine",
    "Mesh",
    "ShardedWindowEngine",
    "build_mesh",
    "cross_host_barrier",
    "global_mesh",
    "init_distributed",
    "mesh_from_config",
    "run_distributed_catchup",
    "sharded_init_state",
    "sharded_step",
]
