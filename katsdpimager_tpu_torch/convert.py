"""Conversion between the JAX package's types and the port's.

Both packages grid the same chunk layout, so one batch feeds both: the
tests build it once and hand it to each.  Likewise the cube
configuration, the wave results and the CLEAN state cross both ways.
Arrays cross as numpy; nothing here imports JAX (a JAX array converts
with ``np.asarray``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .parallel.multichannel import ChannelBatch

#: The JAX ``ChannelBatch`` fields, in order.
JAX_FIELDS = ("kernel", "taper1d", "pixel_size", "mid_w", "uv", "sub_uv",
              "w_plane", "anchor", "valid", "weights", "vis")


def batch_from_jax(batch, device="cpu") -> ChannelBatch:
    """The port's :class:`ChannelBatch` on ``device`` from a JAX
    ``ChannelBatch`` (or any object with its fields as arrays).  The
    occupied-chunk counts are taken from ``valid`` on the host."""
    arrays = {name: np.asarray(getattr(batch, name)) for name in JAX_FIELDS}
    n_chunks = arrays["valid"].any(axis=-1).sum(axis=-1).astype(np.int64)
    # np.array copies: JAX's host views are read-only
    return ChannelBatch(
        **{name: torch.from_numpy(np.array(a)).to(device)
           for name, a in arrays.items()},
        n_chunks=torch.from_numpy(n_chunks))


def batch_to_numpy(batch: ChannelBatch) -> dict:
    """The JAX ``ChannelBatch`` fields of a port batch as numpy arrays
    (``katsdpimager_tpu.parallel.multichannel.ChannelBatch(**d)`` rebuilds
    the JAX batch)."""
    return {name: getattr(batch, name).cpu().numpy() for name in JAX_FIELDS}


def config_from(cls, cfg):
    """The port's frozen config dataclass ``cls`` (for example
    :class:`~.parallel.cube.CubeConfig`) with the field values of a JAX
    config of the same name; ``dataclasses.asdict`` goes the other way."""
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


def tuple_from_jax(cls, obj, device="cpu"):
    """The port's NamedTuple ``cls`` (``WaveResult``, ``PsfWaveResult``,
    ``CleanState``) on ``device`` from a JAX one with the same fields."""
    # np.array copies: JAX's host views are read-only
    return cls(*(torch.from_numpy(np.array(getattr(obj, name))).to(device)
                 for name in cls._fields))


def tuple_to_numpy(obj) -> dict:
    """A port NamedTuple's fields as numpy arrays, by name (``cls(**d)``
    with the JAX class of the same name rebuilds it there)."""
    return {name: getattr(obj, name).cpu().numpy() for name in obj._fields}
