"""The multi-channel imaging step.

Counterpart of :mod:`katsdpimager_tpu.parallel.multichannel` for one
device: imaging density weights, then per W slice the fused gridder (K1,
K2) and the grid -> image transform accumulating into the dirty image
(K3, K4 on the transposed image, or ``torch.fft`` at sizes the kernels
do not take, by :func:`~..ops.fourier.use_fused_fft`; where K3 runs with
no vis group to sum the grid first, K23 takes the colour planes in place
of K2 then K3, and K4 takes all of a channel's slices in one launch);
with ``minor_cycles > 0``, a PSF from the weights and that many CLEAN
minor cycles on the PSF-normalised dirty image.
Channels of a batch share their geometry; the per-channel physics (kernel
tables, taper, pixel size, mid-w values) are tensor inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..ops import _build
from ..ops import clean as clean_ops
from ..ops import fourier, fused_fft, fused_gridder, mxu_gridder
from ..ops import weights as weights_ops
from ..profiling import profile, profile_function
from .mesh import pmax_ints, psum
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


#: The polarizations the weight grid's kernel takes (it holds P planes of
#: a 64 x 64 region in shared memory), its largest tile size and its
#: largest chunk (a thread a slot).
WEIGHT_GRID_MAX_POLS = 4
WEIGHT_GRID_MAX_TILE = 256
WEIGHT_GRID_MAX_CHUNK = 256


def weight_grid_plain(num_pols: int, pixels: int, uv, valid, weights):
    """Plain PyTorch version of :func:`weight_grid`: the valid slots'
    weights summed into their cells by :func:`..ops.weights.grid_weights`
    (``index_put_`` with accumulation); cells outside the grid are
    dropped.  Reads no anchor and takes any leading shape (``uv`` (...,
    2), ``valid`` (...), ``weights`` (..., P))."""
    keep = valid.reshape(-1)
    wgrid = torch.zeros((num_pols, pixels, pixels), dtype=torch.float32,
                        device=uv.device)
    return weights_ops.grid_weights(wgrid, uv.reshape(-1, 2)[keep],
                                    weights.reshape(-1, num_pols)[keep])


def weight_grid(num_pols: int, pixels: int, uv, valid, weights, *, anchor,
                ts: int, kernel_width: int):
    """The (P, N, N) grid of summed imaging weights per uv cell of one
    channel's chunks; cells outside the grid are dropped.

    uv (S, NC, Mc, 2) int32, valid (S, NC, Mc) bool, weights (S, NC, Mc,
    P) f32 and anchor (S, NC, 2) int32 in the layout of the tile-aligned
    planner (:func:`..ops.mxu_gridder.plan_chunks_tiled`) at tile size
    ``ts`` for ``kernel_width``.  Runs :func:`weight_grid_plain` where
    :func:`..device.runs_plain` holds; otherwise launches
    ``ktt_weight_grid`` (``csrc/weights.cu``) or raises.

    The kernel reads the uv and weights of valid slots only, never a
    padding slot's, and relies on the planner's layout: each chunk's
    valid slots a prefix, each slice's occupied chunks first, sorted by
    tile, every valid cell inside its chunk's window
    ``anchor + (K - 1) // 2`` (the window
    :func:`..ops.fused_gridder.samples` reads the density from).  A CTA
    owns a tile's window (or a 64 x 64 part of it), finds the tile's run
    of chunks in each slice on the device and writes each of its cells
    once; each cell's sum is the float32 fold of its slots in slot order,
    with no atomics, so two launches are bitwise equal.  Bound by bytes:
    the valid slots' uv and weights read once, the grid written once (see
    the CUDA source)."""
    if device_mod.runs_plain(uv):
        return weight_grid_plain(num_pols, pixels, uv, valid, weights)
    dev = uv.device
    N, Pp = pixels, num_pols
    kb = (kernel_width - 1) // 2
    if Pp > WEIGHT_GRID_MAX_POLS:
        raise NotImplementedError(f"the weight grid's kernel takes at most "
                                  f"{WEIGHT_GRID_MAX_POLS} polarizations, "
                                  f"not {Pp}")
    if not 1 <= ts <= WEIGHT_GRID_MAX_TILE or not 0 <= kb < ts:
        raise NotImplementedError(f"the weight grid's kernel takes ts in [1, "
                                  f"{WEIGHT_GRID_MAX_TILE}] with (K - 1) // 2 "
                                  f"< ts, not ts {ts}, K {kernel_width}")
    S, NC, Mc = valid.shape
    if Mc > WEIGHT_GRID_MAX_CHUNK:
        raise NotImplementedError(f"the weight grid's kernel takes chunks of "
                                  f"at most {WEIGHT_GRID_MAX_CHUNK} slots, "
                                  f"not {Mc}")
    uv, valid, weights, anchor = (
        x.contiguous() for x in (uv, valid, weights, anchor))
    _build.expect(uv, "uv", torch.int32, (S, NC, Mc, 2), dev)
    _build.expect(valid, "valid", torch.bool, (S, NC, Mc), dev)
    _build.expect(weights, "weights", torch.float32, (S, NC, Mc, Pp), dev)
    _build.expect(anchor, "anchor", torch.int32, (S, NC, 2), dev)
    wgrid = torch.empty((Pp, N, N), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.ktt_weight_grid(
        uv.data_ptr(), weights.data_ptr(), anchor.data_ptr(),
        valid.data_ptr(), wgrid.data_ptr(), S, NC, Mc, Pp, N, ts, kb,
        _build.stream_of(wgrid))
    _build.check(err, "ktt_weight_grid")
    # Counted on the function itself: a caller may wrap the module's name.
    _weight_grid.launches += 1
    return wgrid


weight_grid.launches = 0
_weight_grid = weight_grid


@profile_function("multichannel.weights")
def _density(cfg: MultiChannelConfig, uv, anchor, valid, weights,
             mesh=None):
    """Uniform density weights ``1 / W`` per occupied cell of the
    (P, N, N) weight grid, summed over the vis group under a mesh.  It
    calls :func:`weight_grid` through this module, where a caller may
    wrap it."""
    wgrid = psum(weight_grid(cfg.num_pols, cfg.pixels, uv, valid, weights,
                             anchor=anchor, ts=cfg.rv,
                             kernel_width=cfg.kernel_width), mesh)
    return torch.where(wgrid > 0,
                       1.0 / torch.where(wgrid > 0, wgrid, 1.0), 0.0)


def image_slices(kernel, density, taper1d, pixel_size, mid_w, uv, sub_uv,
                 w_plane, anchor, valid, vis, nc_slices, *, pixels: int,
                 ts: int, mesh=None, take=None):
    """The W-stacked (P, N, N) image of one channel's chunked ``vis``:
    per W slice the fused gridder (K1, K2) with the ``density`` weights
    (None: natural), then the grid -> image transform accumulating into
    the image.  ``nc_slices`` (S host ints) bounds each slice's gridder;
    slices whose count in ``take`` (default ``nc_slices``) is 0 skip the
    gridder and the transform (a zero grid adds exactly zero).

    Under a ``mesh`` with ``vis_size > 1`` each rank grids its own chunks
    and the slice's grid planes are summed over the vis group
    (:func:`.mesh.psum`) before the transform; ``take`` must then be the
    group's maximum of the counts (:func:`.mesh.pmax_ints`), so that every
    rank of the group takes the same slices and joins each sum.

    The precision follows the dtypes (:func:`precision_of`): at float64
    (``--precision double``) K1 still fills float32 colour planes, added
    onto a float64 grid by K2's plain version
    (:func:`..ops.fused_gridder.grid_slice` with ``out``), and the
    transform is
    :func:`fourier.grid_to_image_plain` at complex128, the JAX package's
    complex path.  At float32 the transform's route is chosen once, by
    the rule of :func:`fourier.grid_to_image_parts`: where
    :func:`fourier.use_fused_fft` holds, K3 and K4 accumulate into the
    transposed image, transposed back once at the end; elsewhere each
    slice takes :func:`fourier.grid_to_image_plain` (``torch.fft``), the
    counterpart of the JAX package's XLA branch.  CPU tensors take K3's
    and K4's plain versions wherever the kernels take the size.

    On the K3 route with no vis group to sum the grid (``mesh`` None or
    ``vis_size`` 1), each slice's colour planes
    (:func:`..ops.fused_gridder.slice_planes`) go straight into K23,
    which sums them as K2 does inside K3's load, and K4 takes the
    channel's slices in one launch once the last is added
    (:class:`fused_fft.SliceStack`): bitwise the same image, the grid is
    never written, and the image is read and written once.  Under a vis
    split K2 makes the grid that the group sums, then K3 and K4, once a
    slice."""
    dev = vis.device
    rdtype = precision_of(vis, taper1d)
    double = rdtype == torch.float64
    fused = not double and (
        fused_fft.kernel_size_ok(pixels) if dev.type == "cpu"
        else fourier.use_fused_fft(pixels, dev, vis.dtype, taper1d.dtype))
    planes_fft = fused and (mesh is None or mesh.vis_size == 1)
    Pp = vis.shape[-1]
    take = list(nc_slices if take is None else take)
    image = torch.zeros((Pp, pixels, pixels), dtype=rdtype, device=dev)
    stack = fused_fft.SliceStack(
        image, taper1d, pixel_size, slices=sum(int(t) > 0 for t in take),
        pixels=pixels, ts=ts) if planes_fft else None

    def slice_body(image, xs):
        uv_s, sub_s, wp_s, anc_s, val_s, vis_s, w_mid, nc_s, take_s = xs
        if take_s == 0:
            return image
        with profile("multichannel.slice"):
            if planes_fft:
                stack.add(fused_gridder.slice_planes(
                    kernel, density, uv_s, sub_s, wp_s, vis_s, anc_s, val_s,
                    int(nc_s), pixels=pixels, ts=ts), w_mid)
                return image
            out = None
            if double:
                gr = torch.zeros((Pp, pixels, pixels), dtype=rdtype,
                                 device=dev)
                out = (gr, torch.zeros_like(gr))
            gr, gi = fused_gridder.grid_slice(
                kernel, density, uv_s, sub_s, wp_s, vis_s, anc_s, val_s,
                int(nc_s), pixels=pixels, ts=ts, out=out)
            gr, gi = psum(gr, mesh), psum(gi, mesh)
            if fused:
                return fused_fft.grid_to_image_fused_parts(
                    gr, gi, image, taper1d, w_mid, pixel_size)
            return fourier.grid_to_image_plain(torch.complex(gr, gi), image,
                                               taper1d, w_mid, pixel_size)

    image = scan_slices(slice_body, image,
                        (uv, sub_uv, w_plane, anchor, valid, vis, mid_w,
                         list(nc_slices), take))
    if planes_fft:
        image = stack.flush()
        del stack           # its pairs, before the transposed copy is made
    return image.transpose(-1, -2).contiguous() if fused else image


#: The dtype pairs the step and the wave take: (vis, taper) -> the real
#: dtype of their grids and images.  float32 runs every kernel; float64
#: (``--precision double``) is the JAX package's complex path, with K1 and
#: K5 at float32 and the rest in torch at float64.
PRECISIONS = {(torch.complex64, torch.float32): torch.float32,
              (torch.complex128, torch.float64): torch.float64}


def precision_of(vis, taper1d) -> torch.dtype:
    """The real dtype of a channel's grids and images from its ``vis``
    and ``taper1d`` dtypes (:data:`PRECISIONS`); any other pair raises."""
    try:
        return PRECISIONS[(vis.dtype, taper1d.dtype)]
    except KeyError:
        raise TypeError(
            "vis and taper must be complex64 and float32 (single) or "
            f"complex128 and float64 (double), not {vis.dtype} and "
            f"{taper1d.dtype}") from None


@profile_function("multichannel.channel")
def _channel_pipeline(cfg: MultiChannelConfig, kernel, taper1d, pixel_size,
                      mid_w, uv, sub_uv, w_plane, anchor, valid, weights,
                      vis, nc_slices=None, mesh=None, take=None):
    """One channel's ``(residual, model)``: the dirty image and a zero
    model, or with ``minor_cycles > 0`` the CLEANed residual and model.

    ``nc_slices`` (S host ints) gives each slice's occupied-chunk count;
    None counts them with one device sync.  Slices with no occupied
    chunk skip the gridder and the transform (a zero grid adds exactly
    zero).  Under a ``mesh`` this rank holds a block of the channel's
    chunks: the weight grid and each slice's grid are summed over the vis
    group, and ``take`` (the group's maximum of the counts) decides the
    skip (:func:`image_slices`).  The precision follows the dtypes of
    ``vis`` and ``taper1d`` (:func:`precision_of`)."""
    precision_of(vis, taper1d)
    N, Pp = cfg.pixels, cfg.num_pols
    if cfg.weight_type == "natural":
        density = None
    elif cfg.weight_type == "uniform":
        density = _density(cfg, uv, anchor, valid, weights, mesh)
    else:
        raise ValueError(f"unknown weight_type {cfg.weight_type!r}")
    if nc_slices is None:
        nc_slices = valid.any(dim=-1).sum(dim=-1).tolist()

    def image_of(vis_like):
        return image_slices(kernel, density, taper1d, pixel_size, mid_w, uv,
                            sub_uv, w_plane, anchor, valid, vis_like,
                            nc_slices, pixels=N, ts=cfg.rv, mesh=mesh,
                            take=take)

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


def single_channel_step(cfg: MultiChannelConfig, all_plain: bool = False,
                        /):
    """Unsharded single-channel step.

    Returns ``fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane,
    anchor, valid, weights, vis, nc_slices=None) -> (residual, model)``,
    the JAX function's signature plus the host occupied-chunk counts.
    ``all_plain`` true runs each call inside
    :func:`..device.plain_versions`; it keeps the two-argument form of
    this entry point (``single_channel_step(cfg, False)``, as the
    benchmark's tests call it) working."""

    def fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane, anchor,
           valid, weights, vis, nc_slices=None):
        with (device_mod.plain_versions() if all_plain
              else contextlib.nullcontext()):
            return _channel_pipeline(cfg, kernel, taper1d, pixel_size,
                                     mid_w, uv, sub_uv, w_plane, anchor,
                                     valid, weights, vis, nc_slices)

    return fn


def make_imaging_step(mesh, cfg: MultiChannelConfig):
    """The sharded multi-channel imaging step of this rank.

    Counterpart of the JAX ``make_imaging_step``.  Returns ``step(batch)
    -> (residual, model)``, each stacked over the batch's channels, where
    ``batch`` is this rank's shard of the global batch
    (:func:`local_batch`): its chan group's channels and its vis block of
    every slice's chunks.  Channels run one after another with no
    collective; within a channel the weight grid and each slice's grid
    planes are summed over the vis group, and each slice's occupied-chunk
    count is maxed over the group (the JAX ``pmax``), so every rank of
    the group skips the same empty slices and joins every sum."""

    def step(batch: ChannelBatch):
        outs = []
        for c in range(batch.kernel.shape[0]):
            *args, nc = channel_args(batch, c)
            outs.append(_channel_pipeline(
                cfg, *args, nc, mesh=mesh, take=pmax_ints(nc, mesh)))
        return tuple(torch.stack(x) for x in zip(*outs))

    return step


def local_batch(mesh, batch: ChannelBatch) -> ChannelBatch:
    """This rank's shard of a host-built global batch, on its device:
    channels ``[chan_index C / chan_size, (chan_index + 1) C / chan_size)``
    and, of every slice, the contiguous block ``vis_index`` of its NC
    chunks cut in ``vis_size`` (the JAX ``PartitionSpec("chan", None,
    "vis")``); its occupied-chunk counts are the occupied chunks inside
    that block (the planner puts them first).

    The block is contiguous as in the JAX layout, so the padded tail can
    leave a shard few or no real chunks: the work of a group is as
    unbalanced as the JAX package's.  C must divide by ``chan_size`` and
    NC by ``vis_size``.  The counterpart of ``make_global_batch``: each
    rank takes its own shard, and there is no global array."""
    C, NC = batch.kernel.shape[0], batch.uv.shape[2]
    if C % mesh.chan_size or NC % mesh.vis_size:
        raise ValueError(f"{C} channels and {NC} chunks do not divide over "
                         f"a {mesh.chan_size} x {mesh.vis_size} mesh")
    cl, ncl = C // mesh.chan_size, NC // mesh.vis_size
    cs = slice(mesh.chan_index * cl, (mesh.chan_index + 1) * cl)
    nc0 = mesh.vis_index * ncl
    out = [x[cs].to(mesh.device) for x in batch[:4]]
    out += [x[cs, :, nc0:nc0 + ncl].contiguous().to(mesh.device)
            for x in batch[4:11]]
    n_chunks = (batch.n_chunks[cs] - nc0).clamp(0, ncl)
    return ChannelBatch(*out, n_chunks=n_chunks)


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
