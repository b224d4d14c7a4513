"""Cube-mode orchestration: image a spectral cube in waves of channels.

Counterpart of :mod:`katsdpimager_tpu.cube_frontend`.  The per-channel
frontend (:mod:`.frontend`) drives one channel at a time with host-side
control between stages; this module runs each wave of channels through
the whole Cotton-Schwab pipeline of :mod:`.parallel.cube` on one device,
with beam fitting as the only host work between its device stages.

A wave holds ``mesh.shape["chan"]`` channels, as in the JAX module: each
process (rank) of a ``torch.distributed`` group drives one card, and
the ranks form the ``("chan", "vis")`` mesh of :mod:`.parallel.mesh`
(``--vis-shards`` ranks per channel).  Chan group ``i`` images channel
``wave_start + i``; a partial last wave pads with its last channel, and
the padded results are dropped.  Each rank's prefetch worker
preprocesses and packs its own channel only; a vis rank packs the whole
channel and keeps its contiguous block of chunks.  What the ranks must
agree on takes one collective over all of them: the chunk capacity (the
largest any rank measured, and a ``ChunkOverflowError`` on any rank
makes every rank grow it and repack), the auto PSF patch (the largest
need over the wave), and which waves a rerun skips (decided on rank 0).
Rank 0 writes everything, as the JAX single controller does: the other
chan groups' restored images, beams and statistics are gathered to it
per wave.  Without a process group the mesh is 1 x 1: one channel per
wave on one card.

Differences from the JAX module:

- the packed wave arrays are pinned host tensors.  Each upload is an
  asynchronous copy followed by a CUDA event, and the prefetch worker
  waits on that arena's event before it refills the arena two waves
  later (:func:`_wave_buffers`, :func:`batch_from_arrays`);
- each slice's occupied-chunk count is the packer's own host count
  (:attr:`..parallel.multichannel.ChannelBatch.n_chunks`), so no wave
  reads its validity mask back from the device.

As in the JAX module, the CLEAN PSF patch is sized per wave from the
measured PSF (phase A :func:`..parallel.cube.wave_psf`, then phase B
:func:`..parallel.cube.wave_clean` at the bucketed size), or fixed by
``--cube-psf-patch N`` (:func:`..parallel.cube.wave_image`); model
prediction degrids (K6, K7, K5); ``--subtract`` subtracts the sky model's
DFT inside the wave and ``--primary-beam`` divides the power beam out in
the restore.  Natural, uniform and robust weights are supported.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import time
from typing import List

import numpy as np
import torch

from . import device as device_mod
from . import frontend, native, parameters, polarization, sky_model
from .parallel import mesh as mesh_mod
from .ops import clean as clean_ops
from .ops import mxu_gridder, predict, wkernel
from .parallel import cube
from .parallel.multichannel import ChannelBatch, ChunkOverflowError

logger = logging.getLogger(__name__)

def _plan_layout(reader, num_channels: int, cfg_template: dict) -> dict:
    """Measure the chunk requirements over the wave and size NC with 25%
    headroom, rounded up to a multiple of 128.

    Reads coordinates only (``slice_coords``): the probe never touches
    the visibility and weight payloads."""
    ts = cfg_template["rv"]
    max_nc = 1
    for c in range(num_channels):
        for s in range(reader.num_w_slices(c)):
            cu, _cs, _cw = reader.slice_coords(c, s)
            if len(cu) == 0:
                continue
            max_nc = max(max_nc, mxu_gridder.plan_chunks_tiled_count(
                cu, pixels=cfg_template["pixels"],
                kernel_width=cfg_template["kernel_width"], ts=ts,
                mc=cfg_template["chunk_size"]))
    # Gridding cost follows the chunk capacity, so the headroom is tight;
    # a later wave that overflows grows the layout in run_cube.
    cfg_template["chunks_per_slice"] = max(128, -(-int(max_nc * 1.25)
                                                  // 128) * 128)
    return cfg_template


def _tile_for(kernel_width: int) -> int:
    """Smallest power-of-two tile >= 64 covering the kernel."""
    ts = 64
    while ts < kernel_width:
        ts *= 2
    return ts


#: Auto-sized PSF patches snap to these sizes.
_PATCH_BUCKETS = (17, 33, 65, 129, 257, 513)


def _patch_bucket(need: int, pixels: int) -> int:
    cap = pixels - 1 if pixels % 2 == 0 else pixels
    for b in _PATCH_BUCKETS:
        if b >= need and b <= cap:
            return b
    return min(cap, _PATCH_BUCKETS[-1])


#: The packed arrays' real and complex dtypes by ``--precision``: the
#: taper, pixel size and mid-w values take the real one, the
#: visibilities the complex one; the kernel tables (K1's and K5's
#: complex64 rows) and the weights stay single at both.
PRECISION_DTYPES = {"single": (torch.float32, torch.complex64),
                    "double": (torch.float64, torch.complex128)}


def _wave_buffers(arena: dict, cfg: cube.CubeConfig, C: int,
                  pin: bool = False, precision: str = "single") -> tuple:
    """Zeroed batch arrays for one wave, reused across waves, in the
    dtypes of ``precision`` (:data:`PRECISION_DTYPES`).

    The arrays are numpy views of host tensors, pinned with ``pin`` (the
    CUDA device's asynchronous uploads need pinned memory).  Before the
    arena is refilled, the host waits for the event of its last upload
    (:func:`batch_from_arrays`): the copy may still be reading it.  The
    last array is the (C, S) int64 occupied-chunk count per slice."""
    event = arena.pop("event", None)
    if event is not None:
        event.synchronize()
    S, N = cfg.w_slices, cfg.pixels
    NC, Mc, Pp = cfg.chunks_per_slice, cfg.chunk_size, cfg.num_pols
    real, cplx = PRECISION_DTYPES[precision]
    key = (C, S, N, NC, Mc, Pp, cfg.w_planes, cfg.oversample,
           cfg.kernel_width, pin, precision)
    if arena.get("key") != key:
        arena.clear()
        arena["key"] = key
        shapes = (
            ((C, cfg.w_planes, cfg.oversample, cfg.kernel_width),
             torch.complex64),                                 # kernels
            ((C, N), real),                                    # tapers
            ((C,), real),                                      # psizes
            ((C, S), real),                                    # midws
            ((C, S, NC, Mc, 2), torch.int32),                  # uv
            ((C, S, NC, Mc, 2), torch.int32),                  # sub
            ((C, S, NC, Mc), torch.int32),                     # wp
            ((C, S, NC, 2), torch.int32),                      # anc
            ((C, S, NC, Mc), torch.bool),                      # val
            ((C, S, NC, Mc, Pp), torch.float32),               # wts
            ((C, S, NC, Mc, Pp), cplx),                        # vis
        )
        arena["tensors"] = tuple(
            torch.zeros(shape, dtype=dtype, pin_memory=pin)
            for shape, dtype in shapes)
        arena["arrs"] = tuple(t.numpy() for t in arena["tensors"]) + (
            np.zeros((C, S), np.int64),)
    else:
        for a in arena["arrs"][4:]:
            a.fill(0)   # scatter targets must start zeroed
    return arena["arrs"]


def pack_wave_arrays(cfg: cube.CubeConfig, reader, image_ps, grid_ps,
                     wave_channels: List[int], start: int,
                     arena: dict = None, pin: bool = False,
                     precision: str = "single") -> tuple:
    """Pack a wave of channels into the static chunked batch layout, in
    the dtypes of ``precision``.

    Host work only (no device transfer), so the prefetch worker runs it
    for wave N+1 while the device runs wave N.  Returns the 11 batch
    arrays and the (C, S) occupied-chunk counts.  Raises
    :class:`ChunkOverflowError` when a slice needs more than
    ``cfg.chunks_per_slice`` chunks (the caller grows the layout and
    repacks)."""
    C, S, N = len(wave_channels), cfg.w_slices, cfg.pixels
    NC, Mc = cfg.chunks_per_slice, cfg.chunk_size
    (kernels, tapers, psizes, midws, uv, sub, wp, anc, val, wts, vis,
     n_chunks) = _wave_buffers(arena if arena is not None else {}, cfg, C,
                               pin, precision)

    for i, ch in enumerate(wave_channels):
        rel = ch - start
        ip, gp = image_ps[rel], grid_ps[rel]
        kernels[i] = wkernel.make_convolution_kernel(ip, gp)
        tapers[i] = wkernel.taper(
            N, gp.fixed.antialias_width, gp.fixed.oversample
        ).astype(tapers.dtype)
        psizes[i] = ip.pixel_size
        midws[i] = wkernel.mid_w_values(ip, gp).astype(midws.dtype)
        for s in range(min(S, reader.num_w_slices(rel))):
            # Coordinates first (the plan), then the payloads streamed in
            # bounded blocks.
            cu, cs, cw = reader.slice_coords(rel, s)
            if len(cu) == 0:
                continue
            use_native = native.available()
            if use_native:
                # Parallel C++ plan and coordinate scatter straight into
                # the batch views (bitwise the numpy path's).
                nc, rc, rs = native.pack_slice_coords(
                    cu, cs, cw, pixels=N, kernel_width=cfg.kernel_width,
                    ts=cfg.rv, mc=Mc, out_uv=uv[i, s], out_sub=sub[i, s],
                    out_wp=wp[i, s], out_anchor=anc[i, s],
                    out_valid=val[i, s])
            else:
                asg = mxu_gridder.plan_chunks_tiled_coords(
                    cu, pixels=N, kernel_width=cfg.kernel_width,
                    ts=cfg.rv, mc=Mc)
                nc = asg["n_chunks"]
            if nc > NC:
                raise ChunkOverflowError(
                    f"slice needs {nc} chunks > configured {NC}")
            n_chunks[i, s] = nc
            if not use_native:
                # nc <= NC: every destination is in range.
                order = asg["order"]
                dst = (asg["chunk_of"], asg["slot_of"])
                uv[i, s][dst] = cu[order]
                sub[i, s][dst] = cs[order]
                wp[i, s][dst] = cw[order]
                anc[i, s, :nc] = asg["anchor"][:nc]
                val[i, s, :nc] = asg["valid"][:nc]
                rc, rs = asg["row_chunk"], asg["row_slot"]
            row = 0
            # The native placement writes complex64 visibilities; at
            # double numpy places (and widens) them.
            native_payload = use_native and vis.dtype == np.complex64
            for blk in reader.iter_slice(rel, s, 1 << 20):
                m = len(blk)
                rr = slice(row, row + m)
                if native_payload:
                    native.place_payload(rc[rr], rs[rr], blk.weights,
                                         blk.vis, wts[i, s], vis[i, s])
                else:
                    wts[i, s][rc[rr], rs[rr]] = blk.weights
                    vis[i, s][rc[rr], rs[rr]] = blk.vis
                row += m
    return (kernels, tapers, psizes, midws, uv, sub, wp, anc, val, wts, vis,
            n_chunks)


def vis_block(arrs: tuple, mesh) -> tuple:
    """The packed arrays of a vis rank: every chunk field cut to the
    rank's contiguous block of the NC chunks (views), the occupied-chunk
    counts to those inside it (:func:`.parallel.multichannel.local_batch`
    cuts a batch the same way).  The arrays themselves where
    ``vis_size`` is 1."""
    if mesh.vis_size == 1:
        return arrs
    NC = arrs[4].shape[2]
    ncl = NC // mesh.vis_size
    nc0 = mesh.vis_index * ncl
    block = tuple(a[:, :, nc0:nc0 + ncl] for a in arrs[4:11])
    n_chunks = np.clip(arrs[11] - nc0, 0, ncl)
    return tuple(arrs[:4]) + block + (n_chunks,)


def batch_from_arrays(arrs: tuple, device=None,
                      arena: dict = None) -> ChannelBatch:
    """The :class:`ChannelBatch` of packed wave arrays on ``device``
    (None: the CUDA device, which must exist).

    On CUDA each array is copied asynchronously (from pinned memory when
    the arena pinned it), and an event recorded after the copies goes
    into ``arena``: :func:`_wave_buffers` waits on it before the arena is
    refilled.  On the CPU the batch shares the arena's memory (a vis
    block is copied): a wave's batch is used up before its arena is
    packed again, two waves later.  The occupied-chunk counts stay on the
    host."""
    device = device_mod.resolve(device)
    *arrays, n_chunks = arrs
    if device.type == "cuda":
        tensors = [torch.from_numpy(a).to(device, non_blocking=True)
                   for a in arrays]
        if arena is not None:
            event = torch.cuda.Event()
            event.record()
            arena["event"] = event
    else:
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in arrays]
    return ChannelBatch(*tensors, n_chunks=torch.from_numpy(n_chunks.copy()))


def _sky_batch(cfg, subtract_model, dataset, image_ps, grid_ps, wave_channels,
               start, pol_index, device) -> cube.SkyBatch:
    """The wave's continuum-subtraction model: per channel the sources'
    (l, m, n-1), their sinc-tapered fluxes, zero-padded to
    ``cfg.num_sources`` rows, and the dequantisation scales."""
    C, Smax, Pp = len(wave_channels), cfg.num_sources, cfg.num_pols
    lmn_all = subtract_model.lmn(dataset.phase_centre()).astype(np.float32)
    ns = len(lmn_all)
    sky_lmn = np.zeros((C, Smax, 3), np.float32)
    sky_flux = np.zeros((C, Smax, Pp), np.float32)
    scales = np.zeros((C, 3), np.float32)
    for i, ch in enumerate(wave_channels):
        ip, gp = image_ps[ch - start], grid_ps[ch - start]
        flux = subtract_model.flux_density(ip.wavelength)[:, pol_index]
        taper_scale = float(ip.image_size * gp.fixed.oversample)
        taper = (np.sinc(lmn_all[:, 0] / taper_scale)
                 * np.sinc(lmn_all[:, 1] / taper_scale))
        sky_lmn[i, :ns] = lmn_all
        sky_flux[i, :ns] = (flux * taper[:, None]).astype(np.float32)
        scales[i] = predict.uvw_scale_bias(ip, gp)
    return cube.SkyBatch(*(torch.from_numpy(a).to(device)
                           for a in (sky_lmn, sky_flux, scales)))


def _check_args(args, world: int = None) -> None:
    """Raise where ``--vis-shards`` does not divide the number of ranks
    (``world``, default: the process group's size, 1 without one)."""
    vis_shards = getattr(args, "vis_shards", 1)
    if world is None:
        world = mesh_mod.world_size()
    if vis_shards < 1 or world % vis_shards:
        raise ValueError(f"--vis-shards {vis_shards} does not divide the "
                         f"{world} process(es) of the run")


def pack_agreed(pack, cfg, mesh) -> tuple:
    """``(arrays, cfg, overflowed)``: ``pack(cfg)`` packs this rank's
    wave at the chunk capacity of ``cfg`` or raises
    :class:`ChunkOverflowError`.  An overflow on any rank (one
    ``all_reduce`` over all of them) makes every rank double the capacity
    and pack again, so the ranks keep one layout; ``overflowed`` says
    whether this rank's own packing overflowed."""
    overflowed = False
    while True:
        try:
            arrs, overflow = pack(cfg), False
        except ChunkOverflowError:
            arrs, overflow = None, True
        overflowed = overflowed or overflow
        if not mesh_mod.all_max_int(overflow, mesh):
            return arrs, cfg, overflowed
        cfg = dataclasses.replace(
            cfg, chunks_per_slice=cfg.chunks_per_slice * 2)
        logger.info("Growing chunk capacity to %d", cfg.chunks_per_slice)


def run_cube(args, dataset, writer, *, device=None) -> list:
    """Image the requested channel range in waves of ``mesh.shape["chan"]``
    channels on ``device`` (None: this rank's card under a process group,
    else the CUDA device, which must exist).  Only rank 0 writes
    through ``writer``.
    Returns one dict per wave run of this rank: its channel, its host
    seconds (``host_s``: preprocess and pack in the worker;
    ``blocked_s``: the wait for it; ``device_write_s``: the device
    stages, the gather and the writes), the chunk capacity and whether
    this rank's packing overflowed it."""
    _check_args(args)
    mesh = mesh_mod.make_mesh(getattr(args, "vis_shards", 1), device=device)
    device = mesh.device
    wave_size = mesh.chan_size
    pin = device.type == "cuda"
    input_polarizations = dataset.polarizations()
    mueller = (polarization.polarization_matrix(args.stokes,
                                                input_polarizations), None)
    if dataset.has_feed_angles():
        mueller = polarization.polarization_matrices(args.stokes,
                                                     input_polarizations)
    array_p = dataset.array_parameters()
    if args.stop_channel is None:
        args.stop_channel = dataset.num_channels()
    fixed_image_p = parameters.FixedImageParameters(tuple(args.stokes),
                                                    args.precision)
    from .units import parse_quantity

    max_w = (array_p.longest_baseline if args.max_w is None
             else parse_quantity(args.max_w).value)
    fixed_grid_p = parameters.FixedGridParameters(
        args.aa_width, args.grid_oversample, args.kernel_image_oversample,
        max_w, args.kernel_width, True, None)

    clean_mode = (clean_ops.CLEAN_I if args.clean_mode == "I"
                  else clean_ops.CLEAN_SUMSQ)
    clean_p = parameters.CleanParameters(
        args.minor, args.loop_gain, args.major_gain, args.threshold,
        clean_mode, args.psf_cutoff, args.psf_limit, args.border)

    if args.subtract == "auto":
        subtract_model = dataset.sky_model()
    elif args.subtract is not None:
        subtract_model = sky_model.open_sky_model(args.subtract)
    else:
        subtract_model = None

    beams = None
    if getattr(args, "primary_beam", "none") in ("meerkat", "meerkat:1"):
        from . import primary_beam

        band = dataset.band()
        if band is None:
            raise ValueError("Data set does not specify a band, so "
                             "--primary-beam cannot be used")
        beams = primary_beam.meerkat_v1_beam(band)
    pol_index = [polarization.STOKES_IQUV.index(p)
                 for p in fixed_image_p.polarizations]

    cfg = None
    #: 0 sizes the CLEAN patch per wave from its PSFs
    auto_patch = getattr(args, "cube_psf_patch", 65) == 0
    channels = list(range(args.start_channel, args.stop_channel))

    # Every wave shares one (w_slices, w_planes) geometry: the maximum over
    # the whole channel range (parameter arithmetic; no data is read).
    all_params = [frontend.ChannelParameters(args, dataset, ch, array_p,
                                             fixed_image_p, fixed_grid_p)
                  for ch in channels]
    w_slices = max(p.grid_p.w_slices for p in all_params)
    w_planes = max(p.grid_p.w_planes for p in all_params)

    # Waves to run: fully written waves are dropped up front (decided on
    # rank 0, which writes), so the prefetch never preprocesses a skipped
    # wave.  A partial last wave pads with its last channel; this rank
    # images the channel of its chan group.
    starts = list(range(0, len(channels), wave_size))
    todo = None
    if mesh.rank == 0:
        todo = []
        for wave_start in starts:
            wave_channels = channels[wave_start:wave_start + wave_size]
            if all(writer.channel_already_done(dataset, ch)
                   for ch in wave_channels):
                logger.info("Skipping wave %s: already done", wave_channels)
            else:
                todo.append(wave_start)
    waves = []
    for wave_start in mesh_mod.broadcast(todo, mesh):
        wave_channels = channels[wave_start:wave_start + wave_size]
        padded = wave_channels + [wave_channels[-1]] * (
            wave_size - len(wave_channels))
        mine = padded[mesh.chan_index]
        image_ps = [all_params[mine - channels[0]].image_p]
        grid_ps = [parameters.GridParameters(fixed_grid_p, w_slices,
                                             w_planes)]
        waves.append((wave_channels, mine, image_ps, grid_ps))

    # The chunk capacity is set on the first wave and may grow on
    # overflow; the worker reads it from this box when its preprocessing
    # ends (None, or a stale layout, means the main thread packs).
    cfg_box = [None]
    # Two pack arenas: the worker packs wave N+1 into one while wave N's
    # arrays, in the other, are uploaded.
    arenas = ({}, {})

    def _prepare_wave(wave, wave_idx):
        """Load, compress and pack this rank's channel of a wave: all of
        its host data work, off the main thread."""
        _, mine, image_ps, grid_ps = wave
        t0 = time.monotonic()
        collector = frontend.preprocess_visibilities(
            dataset, args, mine, mine + 1, image_ps, grid_ps, mueller,
            device)
        reader = collector.reader()
        arrs = None
        pack_cfg = cfg_box[0]
        if pack_cfg is not None:
            try:
                arrs = pack_wave_arrays(pack_cfg, reader, image_ps,
                                        grid_ps, [mine], mine,
                                        arena=arenas[wave_idx % 2], pin=pin,
                                        precision=args.precision)
            except ChunkOverflowError:
                arrs = None   # the main thread grows the layout, repacks
        return reader, arrs, pack_cfg, time.monotonic() - t0

    # While the device runs wave N, one worker thread loads, compresses
    # and packs wave N+1.
    timings = []
    prefetch = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        next_reader = (prefetch.submit(_prepare_wave, waves[0], 0)
                       if waves else None)
        for wave_idx, wave in enumerate(waves):
            wave_channels, mine, image_ps, grid_ps = wave
            # Whether this rank's channel is the wave's own, not a pad
            # (a pad's results are dropped).
            real = mesh.chan_index < len(wave_channels)

            t_block0 = time.monotonic()
            reader, arrs, packed_cfg, t_host = next_reader.result()
            t_blocked = time.monotonic() - t_block0
            if wave_idx + 1 < len(waves):
                next_reader = prefetch.submit(_prepare_wave,
                                              waves[wave_idx + 1],
                                              wave_idx + 1)
            t_wave0 = time.monotonic()

            if cfg is None:
                template = dict(
                    pixels=image_ps[0].pixels,
                    num_pols=fixed_image_p.num_polarizations,
                    kernel_width=args.kernel_width,
                    oversample=args.grid_oversample,
                    w_planes=w_planes, w_slices=w_slices,
                    chunk_size=256, rv=_tile_for(args.kernel_width),
                    ru=_tile_for(args.kernel_width),
                    majors=args.major, minor=args.minor,
                    patch=(getattr(args, "cube_psf_patch", 65) or 65),
                    psf_core=64,
                    border_pixels=round(args.border * image_ps[0].pixels),
                    loop_gain=args.loop_gain, major_gain=args.major_gain,
                    threshold_sigma=args.threshold, clean_mode=clean_mode,
                    weight_type=args.weight_type,
                    robustness=args.robustness,
                    num_sources=(-(-len(subtract_model) // 8) * 8
                                 if subtract_model is not None else 0),
                    primary_beam=beams is not None,
                    primary_beam_cutoff=getattr(args, "primary_beam_cutoff",
                                                0.1),
                )
                template = _plan_layout(reader, len(image_ps), template)
                # Every rank takes the largest capacity any rank measured.
                template["chunks_per_slice"] = mesh_mod.all_max_int(
                    template["chunks_per_slice"], mesh)
                cfg = cube.CubeConfig(**template)
                cfg_box[0] = cfg
                logger.info("Cube config: %s", cfg)

            arena = arenas[wave_idx % 2]

            worker_arrs, worker_cfg = arrs, packed_cfg

            def pack(layout):
                # The worker's arrays where it packed this layout;
                # otherwise the first wave, an overflow there, or a
                # layout grown since.
                if worker_arrs is not None and worker_cfg == layout:
                    return worker_arrs
                return pack_wave_arrays(layout, reader, image_ps, grid_ps,
                                        [mine], mine, arena=arena, pin=pin,
                                        precision=args.precision)

            arrs, cfg, overflowed = pack_agreed(pack, cfg, mesh)
            cfg_box[0] = cfg
            batch = batch_from_arrays(vis_block(arrs, mesh), device, arena)

            sky = None
            if subtract_model is not None:
                sky = _sky_batch(cfg, subtract_model, dataset, image_ps,
                                 grid_ps, [mine], mine, pol_index, device)

            if auto_patch:
                psf_res = cube.wave_psf(cfg, batch, mesh=mesh)
                psf_np = psf_res.psf.cpu().numpy()
                box = clean_ops.psf_patch(psf_np[0], args.psf_cutoff,
                                          args.psf_limit)
                # The patch is sized over the wave's own channels.
                need = mesh_mod.all_max_int(
                    max(box[1], box[2]) if real else 0, mesh)
                patch = _patch_bucket(need, cfg.pixels)
                logger.info("Wave %s: PSF patch %dx%d (need %d)",
                            wave_channels, patch, patch, need)
                residual, model, noise_t, minor_t = cube.wave_clean(
                    cfg, batch, psf_res, patch, sky, mesh=mesh)
                half = cfg.pixels // 2
                c0 = half - cfg.psf_core // 2
                cores = psf_np[:, :, c0:c0 + cfg.psf_core,
                               c0:c0 + cfg.psf_core]
                ms, fitted_beams = cube.fit_wave_beams(cores)
                result = cube.WaveResult(
                    residual, model, torch.from_numpy(cores), noise_t,
                    psf_res.psf_peak, minor_t, psf_res.weights_noise,
                    psf_res.normalized_noise)
                patch_used = patch
            else:
                result = cube.wave_image(cfg, batch, sky, mesh=mesh)
                ms, fitted_beams = cube.fit_wave_beams(result.psf_core)
                patch_used = cfg.patch
            image_p = image_ps[0]
            pbeam = None
            if beams is not None:
                from .units import C_M_PER_S

                N = cfg.pixels
                coords = (np.arange(N) - N / 2) * image_p.pixel_size
                pbeam = beams.sample_grid(
                    coords, coords, C_M_PER_S / image_p.wavelength
                ).astype(np.float32)
            final = cube.wave_restore(
                cfg, result.model, result.residual, ms,
                None if pbeam is None
                else torch.from_numpy(pbeam[None]).to(device))[0]
            out = None
            if real and mesh.vis_index == 0:
                # Thermal noise from the weights takes the dataset's
                # weight calibration, as the per-channel path does.
                w_noise = result.weights_noise.cpu().numpy()
                wscale = dataset.weight_scale()
                if wscale is not None:
                    w_noise = np.where(w_noise < 0, w_noise,
                                       w_noise * wscale)
                out = dict(
                    channel=mine, final=final.cpu().numpy(), pbeam=pbeam,
                    beam=fitted_beams[0],
                    noise=float(result.noise.cpu().numpy()[0]),
                    psf_peak=result.psf_peak[0].cpu().numpy(),
                    minor=int(result.minor[0]),
                    weights_noise=float(w_noise[0]),
                    normalized_noise=float(
                        result.normalized_noise.cpu().numpy()[0]),
                    compressed_vis=sum(reader.len(0, s)
                                       for s in range(w_slices)))
            reader.close()
            gathered = mesh_mod.gather_to_rank0(out, mesh)
            if mesh.rank == 0:
                for res in sorted((r for r in gathered if r is not None),
                                  key=lambda r: r["channel"]):
                    _write_channel(
                        writer, dataset, res,
                        all_params[res["channel"] - channels[0]].image_p,
                        grid_ps[0], cfg, patch_used, clean_p)
            # Host data-plane seconds (preprocess and pack in the worker)
            # against the seconds the pipeline waited for them, and the
            # device stages with the gather and the writes.
            t_rest = time.monotonic() - t_wave0
            timings.append({"channels": list(wave_channels),
                            "channel": mine, "host_s": t_host,
                            "blocked_s": t_blocked,
                            "device_write_s": t_rest,
                            "chunks_per_slice": cfg.chunks_per_slice,
                            "overflowed": overflowed})
            logger.info(
                "Wave %s timing: host preprocess+pack %.1fs (pipeline "
                "blocked %.1fs), device+write %.1fs -> %.2f s/channel",
                wave_channels, t_host, t_blocked, t_rest,
                (t_blocked + t_rest) / len(wave_channels))
    finally:
        prefetch.shutdown(wait=True)
    return timings


def _write_channel(writer, dataset, res: dict, image_p, grid_p, cfg,
                   patch_used: int, clean_p) -> None:
    """Write one channel's restored image and statistics (rank 0), or
    mark it as having no usable data."""
    ch, final = res["channel"], res["final"]
    if np.any(res["psf_peak"] == 0):
        logger.info("Skipping channel %d which has no usable data", ch)
        writer.skip_channel(dataset, image_p, ch)
        return
    beam = res["beam"]
    writer.write_fits_image("clean", "clean image", dataset, final, image_p,
                            ch, beam)
    pbeam = (res["pbeam"] if res["pbeam"] is not None
             else np.ones(final.shape[-2:], final.dtype))
    peak = frontend.find_peak(final, pbeam, res["noise"])
    totals = frontend.get_totals(image_p, final, beam)
    wn = res["weights_noise"]
    writer.statistics(
        dataset, ch, major=cfg.majors, minor=res["minor"], peak=peak,
        totals=totals, noise=res["noise"],
        weights_noise=(None if wn < 0 else wn),
        normalized_noise=res["normalized_noise"],
        psf_patch_size=(patch_used, patch_used),
        compressed_vis=res["compressed_vis"], image_parameters=image_p,
        grid_parameters=grid_p, clean_parameters=clean_p,
        restoring_beam=beam)
