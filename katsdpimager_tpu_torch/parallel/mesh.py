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

import collections
import dataclasses
import datetime
import json
import logging
import os
import socket
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import device as device_mod
from ..profiling import profile

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


class HostLayout(NamedTuple):
    """Where a rank sits among the ranks of its host, and the backend."""

    #: this rank's index among its host's ranks, in rank order
    local_rank: int
    #: the number of ranks on this rank's host
    local_world: int
    #: ``nccl`` or ``gloo``, the same on every rank
    backend: str
    #: the number of hosts of the group
    hosts: int


def host_layout(hostnames, cards, rank: int) -> HostLayout:
    """Rank ``rank``'s :class:`HostLayout` from every rank's hostname and
    CUDA card count (lists indexed by global rank; 0 cards: no CUDA).
    The backend is ``nccl`` only where every host has CUDA and no more
    ranks than cards, else ``gloo``; every rank computes it from the
    same lists, so all agree (a mismatch would hang the group)."""
    counts = collections.Counter(hostnames)
    nccl = all(c > 0 and counts[h] <= c for h, c in zip(hostnames, cards))
    host = hostnames[rank]
    local_rank = sum(1 for h in hostnames[:rank] if h == host)
    return HostLayout(local_rank, counts[host], "nccl" if nccl else "gloo",
                      len(counts))


def _cards() -> int:
    """This host's CUDA cards (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


#: This process's layout once :func:`initialize_distributed` has joined.
_layout: Optional[HostLayout] = None


def local_layout() -> Optional[HostLayout]:
    """The :class:`HostLayout` :func:`initialize_distributed` found for
    this process (None before it joined, or where it did not form the
    group)."""
    return _layout


def _gather_layout(store, world: int, rank: int) -> HostLayout:
    """Publish this rank's hostname and card count in ``store``, wait for
    every rank's and compute this rank's layout."""
    store.set(f"ktpu_host/{rank}",
              json.dumps([socket.gethostname(), _cards()]))
    entries = [json.loads(store.get(f"ktpu_host/{r}")) for r in range(world)]
    return host_layout([e[0] for e in entries], [e[1] for e in entries],
                       rank)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None) -> None:
    """Join the process group (call before any device use).

    ``num_processes`` counts the ranks over every host, one per card, and
    ``process_id`` is this rank among them (a JAX ``num_processes``
    counts hosts instead).  Under ``torchrun`` (``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` set) the group forms from its environment
    (``env://``) and the local rank is ``LOCAL_RANK``.  Otherwise the
    rendezvous is ``tcp://{coordinator}`` with ``num_processes`` and
    ``process_id``, or without a coordinator ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``: there each rank first
    publishes its hostname and card count in the rendezvous store, and
    :func:`host_layout` gives its local rank and the backend.  ``backend``
    None is that choice (under ``torchrun``, :func:`default_backend`'s).
    Under ``nccl`` the rank's card becomes the current device before the
    group forms.  Where the group exists already this does nothing."""
    global _layout
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    env = os.environ
    torchrun = {"LOCAL_RANK", "LOCAL_WORLD_SIZE"} <= env.keys()
    if coordinator is None and torchrun:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        layout = HostLayout(int(env["LOCAL_RANK"]),
                            int(env["LOCAL_WORLD_SIZE"]),
                            backend or default_backend(),
                            int(env.get("GROUP_WORLD_SIZE", 1)))
        kwargs = dict(init_method="env://")
    else:
        if coordinator is not None:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator needs num_processes and "
                                 "process_id")
            host, port = coordinator.rsplit(":", 1)
            world, rank = num_processes, process_id
        else:
            host, port = env["MASTER_ADDR"], env["MASTER_PORT"]
            world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=timeout)
        layout = _gather_layout(store, world, rank)
        if backend is not None:
            layout = layout._replace(backend=backend)
        kwargs = dict(store=store, rank=rank, world_size=world)
    if layout.backend == "nccl":
        # NCCL binds a rank to its card when the group forms.
        torch.cuda.set_device(rank_device(layout.local_rank, "nccl"))
    dist.init_process_group(layout.backend, timeout=timeout, **kwargs)
    _layout = layout
    logger.info("distributed: rank %d of %d, %d host(s), local rank %d of "
                "%d, backend %s, device %s", rank, world, layout.hosts,
                layout.local_rank, layout.local_world, layout.backend,
                rank_device(layout.local_rank, layout.backend)
                if torch.cuda.is_available() else "cpu")


def default_backend(num_processes: Optional[int] = None) -> str:
    """The backend of ranks on one host (``LOCAL_WORLD_SIZE`` from
    ``torchrun``, else ``num_processes``, else ``WORLD_SIZE``):
    :func:`host_layout`'s choice, ``nccl`` where CUDA is available and
    they are at most its cards, otherwise ``gloo``, which lets ranks
    share a card."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None:
        local = (num_processes if num_processes is not None
                 else os.environ.get("WORLD_SIZE", 1))
    local = int(local)
    return host_layout([""] * local, [_cards()] * local, 0).backend


def rank_device(local_rank: int, backend: str) -> torch.device:
    """The card of a rank, ``cuda:{local_rank}`` (its index among its
    host's ranks).  More local ranks than cards raise, unless the backend
    is ``gloo``: then the ranks share the cards round-robin."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a rank drives a card (the CPU "
                           "only where the caller asks for it)")
    cards = torch.cuda.device_count()
    if local_rank >= cards:
        if backend != "gloo":
            raise RuntimeError(
                f"local rank {local_rank} but {cards} CUDA device(s): "
                f"backend {backend} takes one rank per card (gloo may share "
                f"them)")
        local_rank %= cards
    return torch.device("cuda", local_rank)


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
        local = (_layout.local_rank if _layout is not None
                 else int(os.environ.get("LOCAL_RANK", dist.get_rank())))
        device = rank_device(local, dist.get_backend())
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
    ``psum.calls`` counts the reductions; each is a ``mesh.psum`` span
    (:func:`..profiling.profile`).  Under ``gloo`` a CUDA ``x`` is
    synchronised first (the reduction waits for the stream's work
    anyway), so the span holds the reduction and the wait for the group's
    other ranks, not this rank's own kernels; under ``nccl`` the call
    only enqueues."""
    if mesh is None or mesh.vis_size == 1:
        return x
    if x.is_cuda and dist.get_backend(mesh.vis_group) == "gloo":
        torch.cuda.synchronize(x.device)
    with profile("mesh.psum"):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.vis_group)
    psum.calls += 1
    return x


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
