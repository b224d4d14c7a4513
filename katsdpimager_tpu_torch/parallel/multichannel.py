"""The multi-channel imaging step.

Counterpart of :mod:`katsdpimager_tpu.parallel.multichannel` for one
device: imaging density weights, then per W slice the fused gridder (K1,
K2) and the fused grid -> image transform (K3, K4) accumulating into the
transposed dirty image; with ``minor_cycles > 0``, a PSF from the weights
and that many CLEAN minor cycles on the PSF-normalised dirty image.
Channels of a batch share their geometry; the per-channel physics (kernel
tables, taper, pixel size, mid-w values) are tensor inputs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..ops import clean as clean_ops
from ..ops import mxu_gridder
from ..ops.fused_fft import grid_to_image_fused_parts
from .slices import scan_slices


@dataclasses.dataclass(frozen=True)
class MultiChannelConfig:
    """Static geometry shared by all channels of a batch."""

    pixels: int
    num_pols: int
    kernel_width: int
    oversample: int
    w_planes: int
    w_slices: int
    chunks_per_slice: int   # NC (padded)
    chunk_size: int         # Mc
    rv: int = 64
    ru: int = 64
    # CLEAN stage (0 minor cycles disables it)
    minor_cycles: int = 0
    patch: int = 33
    border_pixels: int = 0
    loop_gain: float = 0.1
    clean_mode: int = clean_ops.CLEAN_I
    #: imaging density weights: "natural" (no density grid) or "uniform"
    weight_type: str = "uniform"

    @property
    def clean_cfg(self) -> clean_ops.CleanConfig:
        return clean_ops.CleanConfig(
            pixels=self.pixels, num_pols=self.num_pols,
            border_pixels=self.border_pixels, patch_y=self.patch,
            patch_x=self.patch, mode=self.clean_mode,
            loop_gain=self.loop_gain)


class ChannelBatch(NamedTuple):
    """Stacked per-channel inputs, as tensors.

    Leading axes: C channels, S w-slices, NC chunks, Mc vis per chunk.
    ``n_chunks`` stays on the host: the step reads it to skip empty
    slices and bound the gridder without a device sync.
    """

    kernel: torch.Tensor      # (C, W, O, K) complex64
    taper1d: torch.Tensor     # (C, N) float32
    pixel_size: torch.Tensor  # (C,) float32
    mid_w: torch.Tensor       # (C, S) float32
    uv: torch.Tensor          # (C, S, NC, Mc, 2) int32 (centred)
    sub_uv: torch.Tensor      # (C, S, NC, Mc, 2) int32
    w_plane: torch.Tensor     # (C, S, NC, Mc) int32
    anchor: torch.Tensor      # (C, S, NC, 2) int32
    valid: torch.Tensor       # (C, S, NC, Mc) bool
    weights: torch.Tensor     # (C, S, NC, Mc, P) float32
    vis: torch.Tensor         # (C, S, NC, Mc, P) complex64
    n_chunks: torch.Tensor    # (C, S) int64, host: occupied chunks


def weight_grid(num_pols: int, pixels: int, uv, valid, weights):
    """The (P, N, N) grid of summed imaging weights per uv cell; cells
    outside the grid are dropped."""
    N, Pp = pixels, num_pols
    half = N // 2
    flat_uv = uv.reshape(-1, 2).long()
    flat_w = (weights * valid[..., None]).reshape(-1, Pp)
    rows = flat_uv[:, 1] + half
    cols = flat_uv[:, 0] + half
    keep = (rows >= 0) & (rows < N) & (cols >= 0) & (cols < N)
    vals = torch.where(keep[:, None], flat_w, 0.0)
    rows = rows.clamp(0, N - 1)
    cols = cols.clamp(0, N - 1)
    wgrid = torch.zeros((Pp, N, N), dtype=torch.float32, device=uv.device)
    for p in range(Pp):
        wgrid[p].index_put_((rows, cols), vals[:, p], accumulate=True)
    return wgrid


def _density(cfg: MultiChannelConfig, uv, valid, weights):
    """Uniform density weights ``1 / W`` per occupied cell of the
    (P, N, N) weight grid."""
    wgrid = weight_grid(cfg.num_pols, cfg.pixels, uv, valid, weights)
    return torch.where(wgrid > 0,
                       1.0 / torch.where(wgrid > 0, wgrid, 1.0), 0.0)


def image_slices(kernel, density, taper1d, pixel_size, mid_w, uv, sub_uv,
                 w_plane, anchor, valid, vis, nc_slices, *, pixels: int,
                 ts: int, plain: bool = False):
    """The W-stacked (P, N, N) image of one channel's chunked ``vis``:
    per W slice the fused gridder (K1, K2) with the ``density`` weights
    (None: natural), then K3 and K4 accumulating into the transposed
    image.  Slices whose host count in ``nc_slices`` is 0 skip the
    gridder and the transform (a zero grid adds exactly zero).  ``plain``
    runs every kernel's plain version whatever the device."""

    def slice_body(imageT, xs):
        uv_s, sub_s, wp_s, anc_s, val_s, vis_s, w_mid, nc_s = xs
        if nc_s == 0:
            return imageT
        gr, gi = mxu_gridder.grid_chunks_parts(
            kernel, density, uv_s, sub_s, wp_s, vis_s, anc_s, val_s, None,
            int(nc_s), pixels=pixels, ts=ts, plain=plain)
        return grid_to_image_fused_parts(gr, gi, imageT, taper1d, w_mid,
                                         pixel_size, plain=plain)

    imageT = torch.zeros((vis.shape[-1], pixels, pixels),
                         dtype=torch.float32, device=vis.device)
    imageT = scan_slices(slice_body, imageT,
                         (uv, sub_uv, w_plane, anchor, valid, vis, mid_w,
                          list(nc_slices)))
    return imageT.transpose(-1, -2).contiguous()


def check_float32(vis, taper1d) -> None:
    """Raise unless ``vis`` is complex64 and ``taper1d`` float32: the
    port's kernels are float32 only (the JAX package keeps a complex
    path for --precision double)."""
    if vis.dtype != torch.complex64 or taper1d.dtype != torch.float32:
        raise TypeError("the port's step is float32 only: vis complex64 "
                        f"and taper float32, not {vis.dtype} and "
                        f"{taper1d.dtype}")


def _channel_pipeline(cfg: MultiChannelConfig, kernel, taper1d, pixel_size,
                      mid_w, uv, sub_uv, w_plane, anchor, valid, weights,
                      vis, nc_slices=None, plain: bool = False):
    """One channel's ``(residual, model)``: the dirty image and a zero
    model, or with ``minor_cycles > 0`` the CLEANed residual and model.

    ``nc_slices`` (S host ints) gives each slice's occupied-chunk count;
    None counts them with one device sync.  Slices with no occupied
    chunk skip the gridder and the transform (a zero grid adds exactly
    zero).  ``plain`` runs every kernel's plain version whatever the
    device: the reference the kernels are held to on the card."""
    check_float32(vis, taper1d)
    N, Pp = cfg.pixels, cfg.num_pols
    if cfg.weight_type == "natural":
        density = None
    elif cfg.weight_type == "uniform":
        density = _density(cfg, uv, valid, weights)
    else:
        raise ValueError(f"unknown weight_type {cfg.weight_type!r}")
    if nc_slices is None:
        nc_slices = valid.any(dim=-1).sum(dim=-1).tolist()

    def image_of(vis_like):
        return image_slices(kernel, density, taper1d, pixel_size, mid_w, uv,
                            sub_uv, w_plane, anchor, valid, vis_like,
                            nc_slices, pixels=N, ts=cfg.rv, plain=plain)

    dirty = image_of(vis)
    if cfg.minor_cycles == 0:
        return dirty, torch.zeros_like(dirty)

    # ---- CLEAN minor cycles: the PSF grids the weights as visibilities;
    # the dirty image is normalised by the PSF peak (Jy/beam).
    ccfg = cfg.clean_cfg
    psf = image_of(weights.to(vis.dtype) * valid[..., None])
    pk = psf[:, N // 2, N // 2]
    scale = torch.where(pk != 0, 1.0 / torch.where(pk != 0, pk, 1.0), 0.0)
    dirty = dirty * scale[:, None, None]
    h = cfg.patch // 2
    patch = (psf * scale[:, None, None])[:, N // 2 - h:N // 2 - h + cfg.patch,
                                         N // 2 - h:N // 2 - h + cfg.patch]
    state = clean_ops.make_state(ccfg, dirty, torch.zeros_like(dirty))
    state, _k, _first, _last = clean_ops.minor_cycles(
        ccfg, state, patch, 0.0, cfg.minor_cycles)
    return clean_ops.residual_image(ccfg, state), state.model


def single_channel_step(cfg: MultiChannelConfig, plain: bool = False):
    """Unsharded single-channel step.

    Returns ``fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane,
    anchor, valid, weights, vis, nc_slices=None) -> (residual, model)``,
    the JAX function's signature plus the host occupied-chunk counts."""

    def fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane, anchor,
           valid, weights, vis, nc_slices=None):
        return _channel_pipeline(cfg, kernel, taper1d, pixel_size, mid_w,
                                 uv, sub_uv, w_plane, anchor, valid,
                                 weights, vis, nc_slices, plain=plain)

    return fn


def channel_args(batch: ChannelBatch, c: int) -> tuple:
    """Channel ``c``'s arguments of a :func:`single_channel_step` fn."""
    return tuple(x[c] for x in batch[:11]) + (batch.n_chunks[c].tolist(),)


class ChunkOverflowError(ValueError):
    """A (channel, slice) needs more chunks than the configured capacity."""


def chunk_channel(cfg: MultiChannelConfig, uv, sub_uv, w_plane, vis,
                  weights):
    """Plan one (channel, slice) into the padded chunk layout of the batch.

    Returns the padded (uv, sub_uv, w_plane, anchor, valid, weights, vis)
    numpy arrays and the occupied-chunk count."""
    plan = mxu_gridder.plan_chunks_tiled(
        np.asarray(uv, np.int16), np.asarray(sub_uv, np.int16),
        np.asarray(w_plane, np.int16), np.asarray(vis, np.complex64),
        np.asarray(weights, np.float32), pixels=cfg.pixels,
        kernel_width=cfg.kernel_width, ts=cfg.rv, mc=cfg.chunk_size)
    NC = cfg.chunks_per_slice
    nc = int(plan.valid.any(axis=1).sum())
    if nc > NC:
        raise ChunkOverflowError(
            f"slice needs {nc} chunks > configured {NC}")

    def padnc(a):
        out = np.zeros((NC,) + a.shape[1:], a.dtype)
        out[:nc] = a[:nc]
        return out

    return (padnc(plan.uv), padnc(plan.sub_uv), padnc(plan.w_plane),
            padnc(plan.anchor), padnc(plan.valid), padnc(plan.weights),
            padnc(plan.vis)), nc


def make_example_batch(cfg: MultiChannelConfig, num_channels: int,
                       seed: int = 0, base_frequency: float = 1.0e9,
                       vis_per_slice: int | None = None,
                       device=None) -> ChannelBatch:
    """Synthesize a ChannelBatch, bit-identical to the JAX package's
    ``make_example_batch`` for the same arguments (same random draws,
    same planner), with its tensors on ``device`` (None: the CUDA device,
    which must exist)."""
    from .. import parameters, polarization
    from ..ops import wkernel
    from ..units import C_M_PER_S

    device = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    C, S = num_channels, cfg.w_slices
    N, K, O, Pp = cfg.pixels, cfg.kernel_width, cfg.oversample, cfg.num_pols
    NC, Mc = cfg.chunks_per_slice, cfg.chunk_size
    if vis_per_slice is None:
        # Leave headroom: clustered data packs densely but not perfectly,
        # and small windows fragment sparse outskirts into partial chunks.
        vis_per_slice = NC * Mc // 4

    kernels = np.empty((C, cfg.w_planes, O, K), np.complex64)
    tapers = np.empty((C, N), np.float32)
    pixel_sizes = np.empty((C,), np.float32)
    mid_ws = np.empty((C, S), np.float32)
    fixed = parameters.FixedImageParameters((polarization.STOKES_I,) * Pp)
    fgp = parameters.FixedGridParameters(
        antialias_width=7.0, oversample=O, image_oversample=4,
        max_w=1000.0, kernel_width=K)
    gp = parameters.GridParameters(fgp, S, cfg.w_planes)
    for c in range(C):
        freq = base_frequency * (1 + 0.01 * c)
        wavelength = C_M_PER_S / freq
        ip = parameters.ImageParameters(fixed, wavelength,
                                        pixel_size=1.0 / (N * 16), pixels=N)
        kernels[c] = wkernel.make_convolution_kernel(ip, gp)
        tapers[c] = wkernel.taper(N, 7.0, O).astype(np.float32)
        pixel_sizes[c] = ip.pixel_size
        mid_ws[c] = wkernel.mid_w_values(ip, gp).astype(np.float32)

    lim = N // 2 - K - 1
    shape5 = (C, S, NC, Mc)
    out = {name: np.zeros(shape5 + tail, dt) for name, tail, dt in [
        ("uv", (2,), np.int32), ("sub_uv", (2,), np.int32),
        ("w_plane", (), np.int32), ("weights", (Pp,), np.float32),
        ("vis", (Pp,), np.complex64)]}
    anchors = np.zeros((C, S, NC, 2), np.int32)
    valids = np.zeros(shape5, bool)
    n_chunks = np.zeros((C, S), np.int64)
    M = vis_per_slice
    for c in range(C):
        for s in range(S):
            while True:
                # clustered UV (realistic dense centre)
                uv = np.clip(rng.normal(scale=lim / 3, size=(M, 2)),
                             -lim, lim).astype(np.int16)
                sub = rng.integers(0, O, size=(M, 2)).astype(np.int16)
                wp = rng.integers(0, cfg.w_planes, size=M).astype(np.int16)
                vis = (rng.normal(size=(M, Pp))
                       + 1j * rng.normal(size=(M, Pp))).astype(np.complex64)
                wt = rng.uniform(0.5, 2.0, size=(M, Pp)).astype(np.float32)
                try:
                    (out["uv"][c, s], out["sub_uv"][c, s],
                     out["w_plane"][c, s], anchors[c, s], valids[c, s],
                     out["weights"][c, s], out["vis"][c, s]), \
                        n_chunks[c, s] = chunk_channel(
                            cfg, uv, sub, wp, vis, wt)
                    break
                except ValueError:
                    # Fragmentation exceeded the layout; thin the data.
                    M //= 2
                    if M == 0:
                        raise

    def dev(a):
        return torch.from_numpy(a).to(device)

    return ChannelBatch(
        kernel=dev(kernels), taper1d=dev(tapers), pixel_size=dev(pixel_sizes),
        mid_w=dev(mid_ws), uv=dev(out["uv"]), sub_uv=dev(out["sub_uv"]),
        w_plane=dev(out["w_plane"]), anchor=dev(anchors), valid=dev(valids),
        weights=dev(out["weights"]), vis=dev(out["vis"]),
        n_chunks=torch.from_numpy(n_chunks))
