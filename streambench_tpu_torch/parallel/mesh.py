"""The ``(data, campaign)`` mesh of the sharded engine, over ``torch.distributed``.

The port of ``streambench_tpu/parallel/mesh.py``.  JAX lays devices out on
a 2-D ``jax.sharding.Mesh`` and one controller drives them all; here each
device is one process (a rank), and the mesh is the rank grid plus the
process groups its collectives run over:

- ``data`` axis: the stream partition axis.  Each rank holds its slice of
  the micro-batch; the fold all-gathers the slices over this rank's data
  group (its column of the grid), which replaces the reference's network
  shuffle.
- ``campaign`` axis: the keyed-state partition axis.  Each rank holds its
  ``[C / campaign, W]`` shard of the window counts; per-shard sums merge
  over this rank's campaign group (its row of the grid).

Ranks are laid out row-major, ``rank = data_index * campaign +
campaign_index``, as ``np.asarray(devices).reshape(data, campaign)`` lays
out JAX's devices.  Every rank creates every group, in the same order.

Backends follow the device: NCCL for ``cuda``, gloo for ``cpu``; the
host-side votes and commands run on a gloo group over all ranks beside
them.  Nothing picks a backend behind the caller's back.  Each group has
a timeout, so ranks that fall out of step raise instead of hanging.

Rank k folds on card k (``cuda:k``); a host with fewer cards than ranks
is refused by name, before NCCL would fail on two ranks sharing a card.

With no launcher environment (``STREAMBENCH_NUM_PROCESSES`` unset or 1)
the process starts its own world-size-1 group on an in-memory store; the
collectives still run, on groups of one rank, as the reference's ``psum``
runs on a size-1 axis.  Importing this module starts nothing.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
CAMPAIGN_AXIS = "campaign"
# seconds a collective may wait for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0


def backend_for(device: torch.device) -> str:
    """The collective backend of ``device``: NCCL on CUDA, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device rank ``rank`` folds on: ``device`` itself on the CPU or
    when it names a card, else card ``rank`` (``cuda:<rank>``).  A rank
    without a card of its own raises: two ranks on one card would fail
    inside NCCL's own start."""
    if device.type != "cuda" or device.index is not None:
        return device
    check_cards(rank + 1)
    return torch.device("cuda", rank)


def check_cards(ranks: int) -> None:
    """Raise ``ValueError`` unless this host has a card for each of
    ``ranks`` ranks."""
    cards = torch.cuda.device_count()
    if ranks > cards:
        raise ValueError(f"{ranks} ranks on cuda need {ranks} cards, one "
                         f"a rank; this host has {cards}")


def init_process_group(device: torch.device | str | None = None, *,
                       coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S
                       ) -> tuple[int, int, torch.device]:
    """Join the default process group for ``device`` (default ``"cuda"``);
    returns ``(rank, world_size, this rank's device)``.

    Arguments default to ``STREAMBENCH_COORDINATOR`` (``host:port`` of the
    TCP store), ``STREAMBENCH_NUM_PROCESSES`` and
    ``STREAMBENCH_PROCESS_ID``, as the JAX package's ``init_distributed``
    reads them.  One process starts a world-size-1 group on a
    ``HashStore``.  A group that already exists is joined as it is, and
    raises if its backend is not ``device``'s."""
    dev = resolve_device(device)
    backend = backend_for(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise ValueError(f"the process group runs {have!r}; a {dev.type} "
                             f"mesh needs {backend!r}")
        rank = dist.get_rank()
        return rank, dist.get_world_size(), rank_device(dev, rank)
    coordinator_address = (coordinator_address
                           or os.environ.get("STREAMBENCH_COORDINATOR"))
    if num_processes is None:
        num_processes = int(os.environ.get("STREAMBENCH_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("STREAMBENCH_PROCESS_ID", "0"))
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}")
    if dev.type == "cuda" and dev.index is None:
        check_cards(num_processes)
    dev = rank_device(dev, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if num_processes == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        if not coordinator_address:
            raise ValueError(f"{num_processes} processes need a coordinator "
                             "address (STREAMBENCH_COORDINATOR=host:port)")
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                rank=process_id, world_size=num_processes,
                                timeout=timeout)
    return process_id, num_processes, dev


class Mesh:
    """This rank's view of the ``(data, campaign)`` grid: the grid of
    ranks, its own coordinates, and the process groups of its column
    (``data_group``), its row (``campaign_group``), all ranks on the
    fold's backend (``world_group``) and all ranks on gloo
    (``host_group``)."""

    def __init__(self, grid: np.ndarray, rank: int, device: torch.device,
                 backend: str, data_group, campaign_group, world_group,
                 host_group):
        self.grid = grid
        self.rank = rank
        self.device = device
        self.backend = backend
        self.shape = {DATA_AXIS: grid.shape[0], CAMPAIGN_AXIS: grid.shape[1]}
        (d,), (c,) = np.nonzero(grid == rank)
        self.data_index, self.campaign_index = int(d), int(c)
        self.data_group = data_group
        self.campaign_group = campaign_group
        self.world_group = world_group
        self.host_group = host_group

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, campaign="
                f"{self.shape[CAMPAIGN_AXIS]}, rank={self.rank}, "
                f"{self.backend} on {self.device})")


def build_mesh(data: int = 0, campaign: int = 1,
               device: torch.device | str | None = None, *,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Build a ``(data, campaign)`` mesh over every rank of the process
    group (joined or started by ``init_process_group``).  ``data=0`` means
    "all remaining ranks": with 8 ranks and ``campaign=2`` the mesh is
    4x2.  A shape whose product is not the world size raises."""
    if campaign < 1:
        raise ValueError(f"campaign axis must be >= 1, got {campaign}")
    # the start waits for every rank's process to come up: the longer of
    # the two timeouts; the groups below take the caller's
    rank, world, dev = init_process_group(
        device, timeout_s=max(timeout_s, DEFAULT_TIMEOUT_S))
    if data <= 0:
        if world % campaign:
            raise ValueError(f"{world} ranks not divisible by "
                             f"campaign={campaign}")
        data = world // campaign
    if data * campaign != world:
        raise ValueError(f"mesh {data}x{campaign} needs {data * campaign} "
                         f"ranks; the process group has {world}")
    grid = np.arange(world).reshape(data, campaign)
    backend = backend_for(dev)
    timeout = datetime.timedelta(seconds=timeout_s)

    def group(ranks, backend=backend):
        return dist.new_group([int(r) for r in ranks], backend=backend,
                              timeout=timeout)

    # every rank creates every group, in this order
    data_groups = [group(grid[:, c]) for c in range(campaign)]
    campaign_groups = [group(grid[d, :]) for d in range(data)]
    world_group = group(range(world))
    host_group = group(range(world), "gloo")
    d, c = divmod(rank, campaign)
    return Mesh(grid, rank, dev, backend, data_groups[c], campaign_groups[d],
                world_group, host_group)


def mesh_from_config(cfg: BenchmarkConfig,
                     device: torch.device | str | None = None, *,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Mesh from the ``jax.mesh.shape`` config key; a 1-D shape is pure
    data parallelism."""
    shape = tuple(cfg.jax_mesh_shape)
    if len(shape) == 1:
        return build_mesh(data=shape[0], campaign=1, device=device,
                          timeout_s=timeout_s)
    if len(shape) == 2:
        return build_mesh(data=shape[0], campaign=shape[1], device=device,
                          timeout_s=timeout_s)
    raise ValueError(f"jax.mesh.shape must be 1-D or 2-D, got {shape}")
