"""Conversion between the JAX package's types and the port's.

Both packages grid the same chunk layout, so one batch feeds both: the
tests build it once and hand it to each.  Likewise the cube
configuration, the wave results, the CLEAN state and the per-channel
``Imaging`` state cross both ways.
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


#: The per-channel ``Imaging`` images that cross between the packages.
IMAGING_IMAGES = ("dirty", "model", "psf")


def imaging_from_jax(jax_imaging, imaging) -> None:
    """Give the port's :class:`~.imaging.Imaging` the state of a JAX
    ``Imaging`` of the same parameters, in place: the density-weight grid,
    the running grid (complex there, re/im planes here), the dirty, model
    and PSF images, the PSF patch and, once CLEAN has been reset, its
    configuration and state."""
    from .ops import clean as clean_ops

    dev = imaging.device

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    imaging.weights.grid = tensor(jax_imaging.weights.grid)
    grid = np.asarray(jax_imaging.grid)
    imaging.grid = (tensor(grid.real.astype(np.float32)),
                    tensor(grid.imag.astype(np.float32)))
    for name in IMAGING_IMAGES:
        setattr(imaging, name, tensor(getattr(jax_imaging, name)))
    if jax_imaging._psf_patch_arr is not None:
        imaging._psf_patch_arr = tensor(jax_imaging._psf_patch_arr)
    if jax_imaging._clean_cfg is not None:
        imaging._clean_cfg = config_from(clean_ops.CleanConfig,
                                         jax_imaging._clean_cfg)
        imaging._clean_state = tuple_from_jax(
            clean_ops.CleanState, jax_imaging._clean_state, dev)
        imaging.model = imaging._clean_state.model


def imaging_to_numpy(imaging) -> dict:
    """The port ``Imaging`` state that :func:`imaging_from_jax` carries, as
    numpy arrays by name (``weights``, ``grid`` complex64, the images, and
    ``clean_state`` as a dict when CLEAN has been reset)."""
    out = {name: imaging.get_buffer(name) for name in IMAGING_IMAGES}
    out["weights"] = imaging.get_buffer("weights_grid")
    out["grid"] = imaging.get_buffer("grid")
    if imaging._clean_state is not None:
        out["clean_state"] = tuple_to_numpy(imaging._clean_state)
    return out
