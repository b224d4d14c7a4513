"""Cube-mode orchestration: image a spectral cube in waves of channels.

Counterpart of :mod:`katsdpimager_tpu.cube_frontend`.  The per-channel
frontend (:mod:`.frontend`) drives one channel at a time with host-side
control between stages; this module runs each wave of channels through
the whole Cotton-Schwab pipeline of :mod:`.parallel.cube` on one device,
with beam fitting as the only host work between its device stages.

Differences from the JAX module:

- a wave is one channel.  The JAX package puts one channel on each device
  of its mesh (``make_mesh``); the port drives one card, and
  ``--vis-shards`` other than 1 raises (several GPUs are ROADMAP Queue 1);
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
from .ops import clean as clean_ops
from .ops import mxu_gridder, predict, wkernel
from .parallel import cube
from .parallel.multichannel import ChannelBatch, ChunkOverflowError

logger = logging.getLogger(__name__)

#: Channels per wave: one device, one channel.
WAVE_SIZE = 1


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


def _wave_buffers(arena: dict, cfg: cube.CubeConfig, C: int,
                  pin: bool = False) -> tuple:
    """Zeroed batch arrays for one wave, reused across waves.

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
    key = (C, S, N, NC, Mc, Pp, cfg.w_planes, cfg.oversample,
           cfg.kernel_width, pin)
    if arena.get("key") != key:
        arena.clear()
        arena["key"] = key
        shapes = (
            ((C, cfg.w_planes, cfg.oversample, cfg.kernel_width),
             torch.complex64),                                 # kernels
            ((C, N), torch.float32),                           # tapers
            ((C,), torch.float32),                             # psizes
            ((C, S), torch.float32),                           # midws
            ((C, S, NC, Mc, 2), torch.int32),                  # uv
            ((C, S, NC, Mc, 2), torch.int32),                  # sub
            ((C, S, NC, Mc), torch.int32),                     # wp
            ((C, S, NC, 2), torch.int32),                      # anc
            ((C, S, NC, Mc), torch.bool),                      # val
            ((C, S, NC, Mc, Pp), torch.float32),               # wts
            ((C, S, NC, Mc, Pp), torch.complex64),             # vis
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
                     arena: dict = None, pin: bool = False) -> tuple:
    """Pack a wave of channels into the static chunked batch layout.

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
                               pin)

    for i, ch in enumerate(wave_channels):
        rel = ch - start
        ip, gp = image_ps[rel], grid_ps[rel]
        kernels[i] = wkernel.make_convolution_kernel(ip, gp)
        tapers[i] = wkernel.taper(
            N, gp.fixed.antialias_width, gp.fixed.oversample
        ).astype(np.float32)
        psizes[i] = ip.pixel_size
        midws[i] = wkernel.mid_w_values(ip, gp).astype(np.float32)
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
            for blk in reader.iter_slice(rel, s, 1 << 20):
                m = len(blk)
                rr = slice(row, row + m)
                if use_native:
                    native.place_payload(rc[rr], rs[rr], blk.weights,
                                         blk.vis, wts[i, s], vis[i, s])
                else:
                    wts[i, s][rc[rr], rs[rr]] = blk.weights
                    vis[i, s][rc[rr], rs[rr]] = blk.vis
                row += m
    return (kernels, tapers, psizes, midws, uv, sub, wp, anc, val, wts, vis,
            n_chunks)


def batch_from_arrays(arrs: tuple, device=None,
                      arena: dict = None) -> ChannelBatch:
    """The :class:`ChannelBatch` of packed wave arrays on ``device``
    (None: the CUDA device, which must exist).

    On CUDA each array is copied asynchronously (from pinned memory when
    the arena pinned it), and an event recorded after the copies goes
    into ``arena``: :func:`_wave_buffers` waits on it before the arena is
    refilled.  On the CPU the batch shares the arena's memory: a wave's
    batch is used up before its arena is packed again, two waves later.
    The occupied-chunk counts stay on the host."""
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
        tensors = [torch.from_numpy(a).to(device) for a in arrays]
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


def _check_args(args) -> None:
    """Raise on what the port's cube does not run."""
    if args.precision == "double":
        raise NotImplementedError(
            "--cube --precision double is not ported: the wave runs its "
            "float32 parts path only, not the JAX wave's complex path "
            "(katsdpimager_tpu/parallel/cube.py:146-148; ROADMAP, Queue 1)")
    vis_shards = getattr(args, "vis_shards", 1)
    if vis_shards != 1:
        raise NotImplementedError(
            f"--vis-shards {vis_shards}: the port's cube runs on one GPU; "
            "several GPUs are not ported (ROADMAP, Queue 1)")


def run_cube(args, dataset, writer, *, device=None,
             plain: bool = False) -> list:
    """Image the requested channel range in waves on ``device`` (None:
    the CUDA device, which must exist); ``plain`` runs every kernel's
    plain version.  Returns one dict of host seconds per wave run
    (``host_s``: preprocess and pack in the worker; ``blocked_s``: the
    wait for it; ``device_write_s``: the device stages and the writes)."""
    device = device_mod.resolve(device)
    _check_args(args)
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

    # Waves to run: fully written waves are dropped up front, so the
    # prefetch never preprocesses a skipped wave.
    waves = []
    for wave_start in range(0, len(channels), WAVE_SIZE):
        wave_channels = channels[wave_start:wave_start + WAVE_SIZE]
        if all(writer.channel_already_done(dataset, ch)
               for ch in wave_channels):
            logger.info("Skipping wave %s: already done", wave_channels)
            continue
        start = wave_channels[0]
        stop = wave_channels[-1] + 1
        image_ps = [all_params[ch - channels[0]].image_p
                    for ch in range(start, stop)]
        grid_ps = [parameters.GridParameters(fixed_grid_p, w_slices,
                                             w_planes)
                   for _ in range(start, stop)]
        waves.append((wave_channels, start, stop, image_ps, grid_ps))

    # The chunk capacity is set on the first wave and may grow on
    # overflow; the worker reads it from this box when its preprocessing
    # ends (None, or a stale layout, means the main thread packs).
    cfg_box = [None]
    # Two pack arenas: the worker packs wave N+1 into one while wave N's
    # arrays, in the other, are uploaded.
    arenas = ({}, {})

    def _prepare_wave(wave, wave_idx):
        """Load, compress and pack a wave: all of its host data work, off
        the main thread."""
        wave_channels, start, stop, image_ps, grid_ps = wave
        t0 = time.monotonic()
        collector = frontend.preprocess_visibilities(
            dataset, args, start, stop, image_ps, grid_ps, mueller, device)
        reader = collector.reader()
        arrs = None
        pack_cfg = cfg_box[0]
        if pack_cfg is not None:
            try:
                arrs = pack_wave_arrays(pack_cfg, reader, image_ps,
                                        grid_ps, wave_channels, start,
                                        arena=arenas[wave_idx % 2], pin=pin)
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
            wave_channels, start, stop, image_ps, grid_ps = wave

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
                cfg = cube.CubeConfig(**template)
                cfg_box[0] = cfg
                logger.info("Cube config: %s", cfg)

            arena = arenas[wave_idx % 2]
            while True:
                try:
                    if arrs is None or packed_cfg != cfg:
                        # Not packed by the worker: the first wave, an
                        # overflow there, or a layout grown since.
                        arrs = pack_wave_arrays(
                            cfg, reader, image_ps, grid_ps, wave_channels,
                            start, arena=arena, pin=pin)
                        packed_cfg = cfg
                    batch = batch_from_arrays(arrs, device, arena)
                    break
                except ChunkOverflowError:
                    arrs = None
                    cfg = dataclasses.replace(
                        cfg, chunks_per_slice=cfg.chunks_per_slice * 2)
                    cfg_box[0] = cfg
                    logger.info("Growing chunk capacity to %d",
                                cfg.chunks_per_slice)

            sky = None
            if subtract_model is not None:
                sky = _sky_batch(cfg, subtract_model, dataset, image_ps,
                                 grid_ps, wave_channels, start, pol_index,
                                 device)

            if auto_patch:
                psf_res = cube.wave_psf(cfg, batch, plain=plain)
                psf_np = psf_res.psf.cpu().numpy()
                boxes = [clean_ops.psf_patch(psf_np[i], args.psf_cutoff,
                                             args.psf_limit)
                         for i in range(len(wave_channels))]
                need = max(max(b[1], b[2]) for b in boxes)
                patch = _patch_bucket(need, cfg.pixels)
                logger.info("Wave %s: PSF patch %dx%d (need %d)",
                            wave_channels, patch, patch, need)
                residual, model, noise_t, minor_t = cube.wave_clean(
                    cfg, batch, psf_res, patch, sky, plain=plain)
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
                result = cube.wave_image(cfg, batch, sky, plain=plain)
                ms, fitted_beams = cube.fit_wave_beams(result.psf_core)
                patch_used = cfg.patch
            pbeams = None
            if beams is not None:
                from .units import C_M_PER_S

                N = cfg.pixels
                pbeams = np.empty((len(wave_channels), N, N), np.float32)
                for i, ch in enumerate(wave_channels):
                    ip = image_ps[ch - start]
                    coords = (np.arange(N) - N / 2) * ip.pixel_size
                    pbeams[i] = beams.sample_grid(
                        coords, coords, C_M_PER_S / ip.wavelength)
                pbeams = torch.from_numpy(pbeams).to(device)
            final = cube.wave_restore(cfg, result.model, result.residual, ms,
                                      pbeams).cpu().numpy()
            noise = result.noise.cpu().numpy()
            psf_peaks = result.psf_peak.cpu().numpy()
            minors = result.minor.cpu().numpy()
            w_noise = result.weights_noise.cpu().numpy()
            # Thermal noise from the weights takes the dataset's weight
            # calibration, as the per-channel path does.
            wscale = dataset.weight_scale()
            if wscale is not None:
                w_noise = np.where(w_noise < 0, w_noise, w_noise * wscale)
            norm_noise = result.normalized_noise.cpu().numpy()
            if pbeams is not None:
                pbeams = pbeams.cpu().numpy()
            for i, ch in enumerate(wave_channels):
                rel = ch - start
                image_p = image_ps[rel]
                if np.any(psf_peaks[i] == 0):
                    logger.info("Skipping channel %d which has no usable "
                                "data", ch)
                    writer.skip_channel(dataset, image_p, ch)
                    continue
                writer.write_fits_image("clean", "clean image", dataset,
                                        final[i], image_p, ch,
                                        fitted_beams[i])
                pbeam = (pbeams[i] if pbeams is not None
                         else np.ones(final[i].shape[-2:], final.dtype))
                peak = frontend.find_peak(final[i], pbeam, float(noise[i]))
                totals = frontend.get_totals(image_p, final[i],
                                             fitted_beams[i])
                wn = w_noise[i]
                writer.statistics(
                    dataset, ch, major=cfg.majors, minor=int(minors[i]),
                    peak=peak, totals=totals, noise=float(noise[i]),
                    weights_noise=(None if wn < 0 else float(wn)),
                    normalized_noise=float(norm_noise[i]),
                    psf_patch_size=(patch_used, patch_used),
                    compressed_vis=sum(
                        reader.len(rel, s) for s in range(w_slices)),
                    image_parameters=image_p, grid_parameters=grid_ps[rel],
                    clean_parameters=clean_p,
                    restoring_beam=fitted_beams[i])
            reader.close()
            # Host data-plane seconds (preprocess and pack in the worker)
            # against the seconds the pipeline waited for them, and the
            # device stages with the writes.
            t_rest = time.monotonic() - t_wave0
            timings.append({"channels": list(wave_channels),
                            "host_s": t_host, "blocked_s": t_blocked,
                            "device_write_s": t_rest})
            logger.info(
                "Wave %s timing: host preprocess+pack %.1fs (pipeline "
                "blocked %.1fs), device+write %.1fs -> %.2f s/channel",
                wave_channels, t_host, t_blocked, t_rest,
                (t_blocked + t_rest) / len(wave_channels))
    finally:
        prefetch.shutdown(wait=True)
    return timings
