"""Run a function of the port on several local ranks at once.

:func:`run_ranks` starts ``world`` processes with :mod:`torch.multiprocessing`
(``spawn``), each in the process group of :mod:`.mesh` over a free
``localhost`` port (``torchrun``'s environment: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``; or ``--coordinator``'s arguments), calls the
named function there and returns each rank's result.  The function is
named as ``"module:function"`` and must live in the port: a child imports
nothing else.  A rank that raises, dies or outlives ``timeout`` fails the
whole call; the collectives inside have the group's own timeout.

:func:`image_shards` is such a function: this rank's part of sharded
steps or cube waves over host-built batches; :func:`mesh_report` and
:func:`overflow_drill` check the mesh's layout and collectives, and the
cube's capacity agreement, on any number of ranks.
"""

from __future__ import annotations

import importlib
import os
import queue as queue_mod
import socket
import traceback

import numpy as np
import torch

from .. import profiling
from . import mesh as mesh_mod


def free_port() -> int:
    """A TCP port on ``localhost`` that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend, coordinator: bool,
               target: str, args: tuple, kwargs: dict, results) -> None:
    torch.set_num_threads(1)
    try:
        if coordinator:
            mesh_mod.initialize_distributed(f"localhost:{port}", world, rank,
                                            backend=backend)
        else:
            os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                              RANK=str(rank), WORLD_SIZE=str(world),
                              LOCAL_RANK=str(rank),
                              LOCAL_WORLD_SIZE=str(world))
            mesh_mod.initialize_distributed(backend=backend)
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        results.put((rank, True, fn(*args, **kwargs)))
        torch.distributed.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(world: int, target: str, *args, backend="gloo",
              coordinator: bool = False, timeout: float = 300.0,
              **kwargs) -> list:
    """``target(*args, **kwargs)`` on ``world`` ranks of a new process
    group; returns the results by rank.  ``target`` is
    ``"package.module:function"`` in the port; arguments and results are
    pickled.  ``coordinator`` joins as ``--coordinator localhost:PORT
    --num-processes world --process-id rank`` does, with no ``torchrun``
    variables (the hosts' layout then comes through the rendezvous
    store); ``backend`` None is the group's own choice."""
    if not target.startswith("katsdpimager_tpu_torch."):
        raise ValueError(f"{target}: the ranks run functions of the port")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend, coordinator,
                               target, args, kwargs, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        while len(out) + len(errors) < world:
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue_mod.Empty:
                raise RuntimeError(f"{target}: no result within {timeout} s "
                                   f"from ranks {sorted(set(range(world)) - set(out))}") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError(f"{target} failed on " + "\n".join(errors))
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"{target}: ranks exited with codes {failed}")
    return [out[r] for r in range(world)]


def image_shards(jobs, *, device=None) -> list:
    """This rank's part of each job, in order: a job is a dict with
    ``kind`` (``"step"``, :func:`.multichannel.make_imaging_step`, or
    ``"wave"``, :func:`.cube.wave_image`), ``cfg``, ``batch`` (the global
    host batch) and ``vis_shards``.  Each result holds the mesh indices,
    this rank's channels' outputs as numpy (the step's ``(residual,
    model)``, the wave's :class:`.cube.WaveResult` fields) and the job's
    all-reduce count and host seconds (its ``mesh.psum`` spans)."""
    from . import cube, multichannel

    out = []
    for job in jobs:
        mesh = mesh_mod.make_mesh(job["vis_shards"], device=device)
        local = multichannel.local_batch(mesh, job["batch"])
        calls = mesh_mod.psum.calls
        with profiling.installed(profiling.CollectProfiler()) as prof:
            if job["kind"] == "step":
                outs = multichannel.make_imaging_step(mesh, job["cfg"])(local)
            else:
                outs = cube.wave_image(job["cfg"], local, mesh=mesh)
        out.append({"chan_index": mesh.chan_index,
                    "vis_index": mesh.vis_index,
                    "outputs": [np.asarray(x.cpu()) for x in outs],
                    "psum_calls": mesh_mod.psum.calls - calls,
                    "psum_s": prof.seconds("mesh.psum")})
    return out


def mesh_report(vis_shards_list, *, device="cpu") -> list:
    """For each ``vis_shards``: this rank's mesh indices, host layout
    (:func:`.mesh.local_layout`) and device, and what the collectives
    give on values that depend on the rank: :func:`.mesh.psum` of
    ``[rank, 1]``, :func:`.mesh.pmax_ints` of ``[rank, -rank]``,
    :func:`.mesh.all_max_int` of the rank, :func:`.mesh.broadcast` of
    ``"from <rank>"`` and :func:`.mesh.gather_to_rank0` of the rank."""
    out = []
    for vis_shards in vis_shards_list:
        mesh = mesh_mod.make_mesh(vis_shards, device=device)
        r = mesh.rank
        out.append({
            "rank": r, "world": mesh.world, "chan_index": mesh.chan_index,
            "layout": mesh_mod.local_layout(), "device": str(mesh.device),
            "chan_size": mesh.chan_size, "vis_index": mesh.vis_index,
            "vis_size": mesh.vis_size,
            "psum": mesh_mod.psum(torch.tensor([float(r), 1.0],
                                               device=mesh.device),
                                  mesh).tolist(),
            "pmax": mesh_mod.pmax_ints([r, -r], mesh),
            "all_max": mesh_mod.all_max_int(r, mesh),
            "broadcast": mesh_mod.broadcast(f"from {r}", mesh),
            "gathered": mesh_mod.gather_to_rank0(r, mesh)})
    return out


def overflow_drill(needs, capacity: int) -> dict:
    """The cube's capacity agreement (:func:`..cube_frontend.pack_agreed`)
    where this rank's packing overflows below ``needs[rank]`` chunks per
    slice, from ``capacity``: the capacity every rank ends with and
    whether this rank's own packing overflowed."""
    import dataclasses

    from .. import cube_frontend
    from .multichannel import ChunkOverflowError

    mesh = mesh_mod.make_mesh(1, device="cpu")

    def pack(cfg):
        if cfg.chunks_per_slice < needs[mesh.rank]:
            raise ChunkOverflowError("drill")
        return cfg.chunks_per_slice

    @dataclasses.dataclass(frozen=True)
    class Layout:
        chunks_per_slice: int

    packed, cfg, overflowed = cube_frontend.pack_agreed(
        pack, Layout(capacity), mesh)
    return {"packed": packed, "capacity": cfg.chunks_per_slice,
            "overflowed": overflowed}
