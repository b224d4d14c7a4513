"""The ("chan", "vis") mesh over :mod:`torch.distributed`.

Counterpart of :mod:`katsdpimager_tpu.parallel.mesh`.  One process (a
rank) drives one card.  The ranks form a mesh of ``chan_size`` x
``vis_size``, in the JAX layout (``make_mesh`` reshapes the devices to
``(n // vis_shards, vis_shards)``): rank ``r`` is chan group ``r //
vis_size`` and vis shard ``r % vis_size``, so the ``vis_size`` ranks of a
chan group are consecutive.

- ``chan``: frequency channels, pure data parallelism (no collective).
- ``vis``: the chunks of one channel split over the group's ranks; their
  grids are summed with :func:`psum` (``all_reduce`` over the group).

Without a process group every function here sees the 1 x 1 mesh and
:func:`psum` is the identity: the single-card code runs unchanged.

Backends: ``nccl`` on CUDA where every rank of a host has a card of its
own; ``gloo`` on the CPU, and on CUDA where a host's ranks outnumber its
cards and so share them (NCCL refuses two ranks on one device; ``gloo``
reduces CUDA tensors through host memory).  Every collective has the
process group's finite timeout, so a rank that waits forever fails
instead.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from .. import device as device_mod

logger = logging.getLogger(__name__)

#: Seconds a collective may wait before it fails the run.
TIMEOUT_S = 90


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``("chan", "vis")`` mesh."""

    rank: int
    world: int
    chan_index: int
    chan_size: int
    vis_index: int
    vis_size: int
    #: the process group of this rank's chan group (None when vis_size 1)
    vis_group: object
    #: the device this rank drives
    device: torch.device

    @property
    def shape(self) -> dict:
        """``{"chan": chan_size, "vis": vis_size}``, as the JAX mesh's."""
        return {"chan": self.chan_size, "vis": self.vis_size}


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None) -> None:
    """Join the process group (call before any device use).

    With no arguments the rank, world size and rendezvous come from the
    environment that ``torchrun`` sets (``env://``); otherwise from
    ``tcp://{coordinator}`` with ``num_processes`` and ``process_id``, as
    ``jax.distributed.initialize`` takes them.  ``backend`` None is
    :func:`default_backend`'s choice.  Where the group exists already
    this does nothing."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = default_backend(num_processes)
    kwargs = dict(backend=backend,
                  timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if coordinator is None:
        kwargs["init_method"] = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        kwargs.update(init_method=f"tcp://{coordinator}",
                      world_size=num_processes, rank=process_id)
    if backend == "nccl":
        # NCCL binds a rank to its card when the group forms.
        torch.cuda.set_device(rank_device(
            process_id if coordinator is not None
            else int(os.environ.get("RANK", "0")), backend))
    dist.init_process_group(**kwargs)
    logger.info("distributed: rank %d of %d, backend %s", dist.get_rank(),
                dist.get_world_size(), backend)


def default_backend(num_processes: Optional[int] = None) -> str:
    """``nccl`` where CUDA is available and this host's ranks
    (``LOCAL_WORLD_SIZE`` from ``torchrun``, else ``num_processes``, else
    ``WORLD_SIZE``) are at most its cards; otherwise ``gloo``, which lets
    ranks share a card."""
    if not torch.cuda.is_available():
        return "gloo"
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None:
        local = (num_processes if num_processes is not None
                 else os.environ.get("WORLD_SIZE", 1))
    return "nccl" if int(local) <= torch.cuda.device_count() else "gloo"


def rank_device(rank: int, backend: str) -> torch.device:
    """The card of a rank: ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` from
    ``torchrun``, else the rank).  More ranks than cards raise, unless
    the backend is ``gloo``: then the ranks share the cards round-robin."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a rank drives a card (the CPU "
                           "only where the caller asks for it)")
    local = int(os.environ.get("LOCAL_RANK", rank))
    cards = torch.cuda.device_count()
    if local >= cards:
        if backend != "gloo":
            raise RuntimeError(
                f"local rank {local} but {cards} CUDA device(s): backend "
                f"{backend} takes one rank per card (gloo may share them)")
        local %= cards
    return torch.device("cuda", local)


def world_size() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def default_device(device=None) -> torch.device:
    """``device``, or where it is None this rank's card under a process
    group (:func:`rank_device`), else the CUDA device, which must exist.
    A CUDA device becomes the process's current device, where its
    kernels launch."""
    if device is None and dist.is_initialized():
        device = rank_device(dist.get_rank(), dist.get_backend())
    device = device_mod.resolve(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device


def make_mesh(vis_shards: int = 1, *, device=None) -> Mesh:
    """This rank's ``("chan", "vis")`` mesh: ``vis_shards`` consecutive
    ranks cooperate on each channel, the rest spread over channels.
    Every rank must call it, in the same order (it forms the vis groups).
    ``device``: :func:`default_device` (None is this rank's card, which
    must exist; tests pass ``"cpu"``).  Without a process group it is the
    1 x 1 mesh."""
    if vis_shards < 1:
        raise ValueError(f"vis_shards must be >= 1, not {vis_shards}")
    if not dist.is_initialized():
        if vis_shards != 1:
            raise ValueError(f"1 process not divisible by vis_shards="
                             f"{vis_shards}")
        return Mesh(0, 1, 0, 1, 0, 1, None, default_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % vis_shards != 0:
        raise ValueError(f"{world} processes not divisible by "
                         f"vis_shards={vis_shards}")
    group = None
    if vis_shards > 1:
        # new_group is collective over all ranks: each forms every group.
        for g in range(world // vis_shards):
            ranks = list(range(g * vis_shards, (g + 1) * vis_shards))
            made = dist.new_group(ranks, timeout=datetime.timedelta(
                seconds=TIMEOUT_S))
            if rank in ranks:
                group = made
    return Mesh(rank, world, rank // vis_shards, world // vis_shards,
                rank % vis_shards, vis_shards, group, default_device(device))


def _comm_device(mesh: Mesh) -> torch.device:
    """Where a small control tensor lives for a collective: the card
    under ``nccl``, the host under ``gloo``."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return mesh.device
    return torch.device("cpu")


def psum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over this rank's vis group (``all_reduce``, in
    place; ``x`` contiguous); the identity where ``vis_size`` is 1.
    ``psum.calls`` counts the reductions and ``psum.seconds`` the host
    seconds spent in them.  Under ``gloo`` a CUDA ``x`` is synchronised
    first (the reduction waits for the stream's work anyway), so the
    seconds are the reduction's and the wait for the group's other ranks,
    not this rank's own kernels; under ``nccl`` the call only enqueues."""
    if mesh is None or mesh.vis_size == 1:
        return x
    if x.is_cuda and dist.get_backend(mesh.vis_group) == "gloo":
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.vis_group)
    psum.seconds += time.perf_counter() - t0
    psum.calls += 1
    return x


psum.seconds = 0.0
psum.calls = 0


def pmax_ints(values, mesh: Optional[Mesh]) -> list:
    """The elementwise maximum of a list of host ints over this rank's
    vis group (the occupied-chunk counts per slice); the list itself
    where ``vis_size`` is 1."""
    values = [int(v) for v in values]
    if mesh is None or mesh.vis_size == 1 or not values:
        return values
    t = torch.tensor(values, dtype=torch.int64, device=_comm_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.vis_group)
    return t.tolist()


def all_max_int(value: int, mesh: Optional[Mesh]) -> int:
    """The maximum of a host int over every rank (the value itself
    without a process group)."""
    if mesh is None or mesh.world == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_comm_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def broadcast(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if mesh is None or mesh.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_comm_device(mesh))
    return box[0]


def gather_to_rank0(obj, mesh: Optional[Mesh]):
    """Every rank's ``obj`` (picklable) as a list by rank on rank 0, None
    elsewhere."""
    if mesh is None or mesh.world == 1:
        return [obj]
    out = [None] * mesh.world if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out
