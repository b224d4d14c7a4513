"""Pipeline orchestration: parameter derivation, channel batching, and the
per-channel imaging flow (weights -> PSF -> CLEAN major/minor cycles ->
primary beam -> restore -> statistics).

Counterpart of :mod:`katsdpimager_tpu.frontend`, with the same flag
surface (:func:`add_options`), ``Writer`` contract and per-channel
processing order.  The imaging state of a channel lives on one torch
device (:class:`.imaging.Imaging`): CUDA, where every kernel of the path
runs, or the CPU, where the kernels' plain versions run.  ``plain`` runs
the plain versions on CUDA too (the reference the kernels are checked
against).
"""

from __future__ import annotations

import concurrent.futures
import logging
import math
from abc import abstractmethod
from typing import Optional

import numpy as np
import torch

from . import device as device_mod
from . import (
    imaging, loader, parameters, polarization, preprocess, progress,
    sky_model, units,
)
from .ops import beam as beam_ops
from .ops import clean as clean_ops
from .ops import weights as weight_ops
from .profiling import profile, profile_function

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Preprocessing

@profile_function
def preprocess_visibilities(dataset, args, start_channel, stop_channel,
                            image_ps, grid_ps, polarization_matrices,
                            device):
    """Stream the dataset through the collector, overlapping load with
    preprocess via a single worker thread.  ``--preprocess auto`` takes
    the native host core when imaging on CUDA (the card stays free for
    imaging) and the torch engine on the CPU."""
    mueller_stokes, mueller_circular = polarization_matrices
    engine = getattr(args, "preprocess", "auto")
    if engine == "auto":
        engine = "native" if torch.device(device).type == "cuda" else "torch"
    if args.tmp_file:
        import atexit
        import os
        import tempfile

        handle, filename = tempfile.mkstemp(".h5")
        os.close(handle)
        atexit.register(lambda: os.path.exists(filename) and os.remove(filename))
        collector = preprocess.VisibilityCollectorHDF5(
            filename, image_ps, grid_ps, args.vis_block,
            max_cache_size=args.max_cache_size, engine=engine, device=device)
    else:
        collector = preprocess.VisibilityCollectorMem(
            image_ps, grid_ps, args.vis_block, engine=engine, device=device)

    bar = None
    add_future = None
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as executor:
        for chunk in loader.data_iter(dataset, args.vis_limit, args.vis_load,
                                      start_channel, stop_channel):
            if bar is None:
                bar = progress.make_progressbar("Preprocessing vis",
                                                max=chunk["total"])
            if add_future is not None:
                bar.goto(add_future.result())

            def add_chunk(chunk=chunk):
                collector.add(
                    chunk["uvw"], chunk["weights"], chunk["vis"],
                    chunk.get("feed_angle1"), chunk.get("feed_angle2"),
                    mueller_stokes, mueller_circular)
                return chunk["progress"]

            add_future = executor.submit(add_chunk)
        if add_future is not None:
            bar.goto(add_future.result())
    if bar is not None:
        bar.finish()
    collector.close()
    if collector.num_input:
        logger.info("Compressed %d visibilities to %d (%.2f%%)",
                    collector.num_input, collector.num_output,
                    100.0 * collector.num_output / max(collector.num_input, 1))
    return collector


# ---------------------------------------------------------------------------
# Per-channel helpers

@profile_function
def make_weights(reader, rel_channel, imager, weight_type, vis_block,
                 weight_scale):
    imager.clear_weights()
    if weight_type != weight_ops.WeightType.NATURAL:
        for w_slice in range(reader.num_w_slices(rel_channel)):
            for chunk in reader.iter_slice(rel_channel, w_slice, vis_block):
                imager.grid_weights(chunk.uv, chunk.weights)
    noise, normalized_noise = imager.finalize_weights()
    if noise is not None and weight_scale is not None:
        noise *= weight_scale
    if noise is not None:
        logger.info("Thermal RMS noise (from weights): %g", noise)
    logger.info("Normalized thermal RMS noise: %g", normalized_noise)
    return noise, normalized_noise


@profile_function
def make_dirty(reader, rel_channel, name, field, imager, vis_block,
               degrid, full_cycle=False, subtract_model=False):
    """Grid a full pass of the visibilities (optionally with model
    subtraction) and accumulate the dirty image over W slices
    (reference frontend.py:109-142)."""
    imager.clear_dirty()
    if full_cycle and not degrid:
        imager.model_to_predict()
    for w_slice in range(reader.num_w_slices(rel_channel)):
        if reader.len(rel_channel, w_slice) == 0:
            continue
        imager.clear_grid()
        model_grid = (imager.model_to_grid(imager.mid_w[w_slice])
                      if full_cycle and degrid else None)
        # Stream the slice in vis_block-bounded blocks (spill backends
        # recycle one read buffer, keeping host memory flat regardless of
        # slice size; gridding is additive so per-block plans compose).
        for block, chunk in enumerate(
                reader.iter_slice(rel_channel, w_slice, vis_block)):
            vis = chunk[field]
            if subtract_model:
                vis = imager.continuum_predict(chunk, vis, w_slice)
            if full_cycle:
                if degrid:
                    vis = imager.degrid_slice(chunk, vis, model_grid,
                                              w_slice, block)
                else:
                    vis = imager.model_predict(chunk, vis, w_slice)
            with profile(f"grid_slice_{w_slice}"):
                imager.grid_slice(chunk, vis, w_slice, block)
        with profile(f"grid_to_image_{w_slice}"):
            imager.grid_to_image(w_slice)


def find_peak(image, pbeam, noise):
    """Peak absolute value where beam-corrected signal exceeds 7.5 sigma
    (reference frontend.py:171-195)."""
    absval = np.abs(image)
    significant = absval * pbeam[None] > 7.5 * noise
    masked = np.where(significant, absval, 0)
    peak = float(masked.max(initial=0))
    return peak if peak > 0 else float("nan")


def get_totals(image_parameters, image, restoring_beam):
    """Total flux density per polarization (reference frontend.py:197-214)."""
    sums = np.nansum(np.where(np.isnan(image), 0, image), axis=(1, 2),
                     dtype=np.float64)
    all_nan = np.all(np.isnan(image), axis=(1, 2))
    sums = np.where(all_nan, np.nan, sums)
    sums /= beam_ops.beam_area(restoring_beam)
    return {
        polarization.STOKES_NAMES[pol]: float(s)
        for pol, s in zip(image_parameters.fixed.polarizations, sums)
    }


class ChannelParameters:
    """Per-channel image + grid parameters (reference frontend.py:222-270)."""

    def __init__(self, args, dataset, channel, array_p, fixed_image_p,
                 fixed_grid_p):
        self.channel = channel
        pixel_size = args.pixel_size
        if pixel_size is not None and not isinstance(pixel_size, float):
            q = units.parse_quantity(pixel_size)
            pixel_size = math.sin(q.value) if q.physical_type == "angle" else q.value
        self.image_p = parameters.make_image_parameters(
            fixed_image_p, args.q_fov, args.image_oversample,
            dataset.frequency(channel), array_p, pixel_size, args.pixels)
        if args.w_slices is None:
            w_slices = parameters.w_slices(
                self.image_p, fixed_grid_p.max_w, args.eps_w,
                args.kernel_width, args.aa_width)
        else:
            w_slices = args.w_slices
        w_step = units.parse_quantity(args.w_step)
        if w_step.physical_type == "length":
            w_planes = fixed_grid_p.max_w / w_step.value
        elif w_step.physical_type == "dimensionless":
            step = w_step.value * self.image_p.cell_size / args.grid_oversample
            w_planes = fixed_grid_p.max_w / step
        else:
            raise ValueError("--w-step must be dimensionless or a length")
        w_planes = int(np.ceil(w_planes / w_slices))
        self.grid_p = parameters.GridParameters(fixed_grid_p, w_slices, w_planes)


# ---------------------------------------------------------------------------
# Option surface

def add_options(parser):
    """CLI surface parity with reference frontend.py:276-367."""
    group = parser.add_argument_group("Input selection")
    group.add_argument("--input-option", "-i", action="append", default=[],
                       metavar="KEY=VALUE",
                       help="Backend-specific input parsing option")
    group.add_argument("--start-channel", "-c", type=int, default=0,
                       help="Index of first channel to process [%(default)s]")
    group.add_argument("--stop-channel", "-C", type=int,
                       help="Index past last channel to process [#channels]")
    group.add_argument("--subtract", metavar="URL",
                       help="Sky model with sources to subtract at the start")

    group = parser.add_argument_group("Image options")
    group.add_argument("--q-fov", type=float, default=1.0,
                       help="Field of view to image, relative to main lobe [%(default)s]")
    group.add_argument("--image-oversample", type=float, default=5,
                       help="Pixels per beam [%(default)s]")
    group.add_argument("--pixel-size", type=str,
                       help="Size of each image pixel (e.g. 18arcsec) [computed]")
    group.add_argument("--pixels", type=int,
                       help="Number of pixels in image [computed]")
    group.add_argument("--stokes", type=polarization.parse_stokes, default="I",
                       help="Stokes parameters to image e.g. IQUV [%(default)s]")
    group.add_argument("--precision", choices=["single", "double"],
                       default="single",
                       help="Internal floating-point precision [%(default)s]")

    group = parser.add_argument_group("Weighting options")
    group.add_argument("--weight-type",
                       choices=[t.name.lower() for t in weight_ops.WeightType],
                       default="natural",
                       help="Imaging density weights [%(default)s]")
    group.add_argument("--robustness", type=float, default=0.0,
                       help="Robustness parameter for robust weighting [%(default)s]")

    group = parser.add_argument_group("Gridding options")
    group.add_argument("--grid-oversample", type=int, default=8,
                       help="Oversampling factor for convolution kernels [%(default)s]")
    group.add_argument("--kernel-image-oversample", type=int, default=4,
                       help="Oversampling factor for kernel generation [%(default)s]")
    group.add_argument("--w-slices", type=int,
                       help="Number of W slices [computed from --kernel-width]")
    group.add_argument("--w-step", type=str, default="1.0",
                       help="Separation between W planes, in subgrid cells or "
                            "a distance [%(default)s]")
    group.add_argument("--max-w", type=str,
                       help="Largest w, as a distance [longest baseline]")
    group.add_argument("--aa-width", type=float, default=7,
                       help="Support of anti-aliasing kernel [%(default)s]")
    group.add_argument("--kernel-width", type=int, default=60,
                       help="Support of combined anti-aliasing + w kernel [%(default)s]")
    group.add_argument("--eps-w", type=float, default=0.001,
                       help="Level at which to truncate W kernel [%(default)s]")
    group.add_argument("--degrid", action="store_true",
                       help="Use degridding rather than direct prediction")
    group.add_argument("--primary-beam", choices=["meerkat", "meerkat:1", "none"],
                       default="none",
                       help="Primary beam model for the telescope")
    group.add_argument("--primary-beam-cutoff", type=float, default=0.1,
                       help="Primary beam power level below which output "
                            "pixels are discarded [%(default)s]")

    group = parser.add_argument_group("Cleaning options")
    group.add_argument("--psf-cutoff", type=float, default=0.01,
                       help="fraction of PSF peak at which to truncate PSF [%(default)s]")
    group.add_argument("--psf-limit", type=float, default=0.5,
                       help="maximum fraction of image to use for PSF [%(default)s]")
    group.add_argument("--loop-gain", type=float, default=0.1,
                       help="Loop gain for cleaning [%(default)s]")
    group.add_argument("--major-gain", type=float, default=0.85,
                       help="Fraction of peak to clean in each major cycle [%(default)s]")
    group.add_argument("--threshold", type=float, default=5.0,
                       help="CLEAN threshold in sigma [%(default)s]")
    group.add_argument("--major", type=int, default=1,
                       help="Major cycles [%(default)s]")
    group.add_argument("--minor", type=int, default=10000,
                       help="Max minor cycles per major cycle [%(default)s]")
    group.add_argument("--border", type=float, default=0.02,
                       help="CLEAN border as a fraction of image size [%(default)s]")
    group.add_argument("--clean-mode", choices=["I", "IQUV"], default="IQUV",
                       help="Stokes parameters for peak-finding [%(default)s]")

    group = parser.add_argument_group("Performance tuning options")
    group.add_argument("--vis-block", type=int, default=1048576,
                       help="Number of visibilities to grid at a time [%(default)s]")
    group.add_argument("--vis-load", type=int, default=32 * 1048576,
                       help="Number of visibilities to load at a time [%(default)s]")
    group.add_argument("--vis-limit", type=int,
                       help="Maximum number of visibilities to process")
    group.add_argument("--channel-batch", type=int, default=16,
                       help="Channels to process per batch [%(default)s]")
    group.add_argument("--no-tmp-file", dest="tmp_file", action="store_false",
                       default=True,
                       help="Keep preprocessed visibilities in memory")
    group.add_argument("--max-cache-size", type=int, default=None,
                       help="Limit HDF5 chunk-cache bytes for preprocessing")
    group.add_argument("--preprocess", choices=["auto", "torch", "native"],
                       default="auto",
                       help="Preprocessing compute engine: the C++/OpenMP "
                            "host core or the torch path on the imaging "
                            "device; auto picks native when imaging on CUDA "
                            "so the card stays free for imaging "
                            "[%(default)s]")
    group.add_argument("--minor-batch", type=int, default=256,
                       help="Minor cycles per device batch [%(default)s]")


# ---------------------------------------------------------------------------
# Writer

class Writer:
    """Abstract output handler (parity with reference frontend.py:383-461)."""

    def channel_already_done(self, dataset, channel) -> bool:
        return False

    @abstractmethod
    def needs_fits_image(self, name: str) -> bool:
        ...

    @abstractmethod
    def needs_fits_grid(self, name: str) -> bool:
        ...

    @abstractmethod
    def write_fits_image(self, name, description, dataset, image,
                         image_parameters, channel, beam=None,
                         bunit="Jy/beam"):
        ...

    @abstractmethod
    def write_fits_grid(self, name, description, fftshift, grid_data,
                        image_parameters, channel):
        ...

    def skip_channel(self, dataset, image_parameters, channel):
        pass

    def statistics(self, dataset, channel, **kwargs):
        """Statistics contract parity: noise, weights_noise,
        normalized_noise, peak, totals, major, minor, psf_patch_size,
        compressed_vis, image/grid/clean parameters."""


# ---------------------------------------------------------------------------
# Per-channel processing

@profile_function
def process_channel(dataset, args, start_channel, reader, writer,
                    channel_p, array_p, weight_p, clean_p,
                    subtract_model, *, device=None,
                    plain: bool = False) -> Optional[dict]:
    """Image one channel on ``device`` (None: the CUDA device, which must
    exist); ``plain`` runs every kernel's plain version."""
    device = device_mod.resolve(device)
    channel = channel_p.channel
    rel_channel = channel - start_channel
    image_p = channel_p.image_p
    grid_p = channel_p.grid_p

    if writer.channel_already_done(dataset, channel):
        logger.info("Skipping channel %d: already done", channel)
        return None
    if not dataset.channel_enabled(channel):
        logger.info("Skipping channel %d which is masked", channel)
        return None
    if not any(reader.len(rel_channel, ws)
               for ws in range(reader.num_w_slices(rel_channel))):
        logger.info("Skipping channel %d which has no data", channel)
        writer.skip_channel(dataset, image_p, channel)
        return None

    logger.info("Processing channel %d", channel)
    imager = imaging.Imaging(image_p, grid_p, weight_p, clean_p,
                             device=device, plain=plain)
    imager.clear_model()

    # Imaging weights
    weights_noise, normalized_noise = make_weights(
        reader, rel_channel, imager, weight_p.weight_type, args.vis_block,
        dataset.weight_scale())
    if writer.needs_fits_image("weights"):
        writer.write_fits_image("weights", "image weights", dataset,
                                imager.get_buffer("weights_grid"), image_p,
                                channel, bunit=None)

    # PSF
    make_dirty(reader, rel_channel, "PSF", "weights", imager,
               args.vis_block, args.degrid)
    psf_peak = imager.psf_peak()
    if np.any(psf_peak == 0):
        logger.info("Skipping channel %d which has no usable data", channel)
        writer.skip_channel(dataset, image_p, channel)
        return None
    scale = np.reciprocal(psf_peak)
    imager.scale_dirty(scale)
    imager.dirty_to_psf()
    psf_patch = imager.psf_patch()
    logger.info("Using %dx%d patch for PSF", psf_patch[2], psf_patch[1])
    psf_core = imager.extract_psf_core(psf_patch)
    restoring_beam = beam_ops.fit_beam(psf_core)
    if writer.needs_fits_image("psf"):
        writer.write_fits_image("psf", "PSF", dataset,
                                imager.get_buffer("psf"), image_p, channel,
                                restoring_beam)

    # Continuum subtraction model
    if subtract_model is not None:
        lmn = subtract_model.lmn(dataset.phase_centre()).astype(np.float32)
        flux = subtract_model.flux_density(image_p.wavelength)
        pol_index = [polarization.STOKES_IQUV.index(p)
                     for p in image_p.fixed.polarizations]
        flux = flux[:, pol_index]
        taper_scale = float(image_p.image_size * grid_p.fixed.oversample)
        taper = (np.sinc(lmn[:, 0] / taper_scale)
                 * np.sinc(lmn[:, 1] / taper_scale))
        imager.set_sky_model(lmn, (flux * taper[:, None]).astype(np.float32))

    # Major cycles
    major = 0
    minor = 0
    noise = 0.0
    for i in range(args.major):
        logger.info("Starting major cycle %d/%d", i + 1, args.major)
        make_dirty(reader, rel_channel, "image", "vis", imager,
                   args.vis_block, args.degrid, i != 0,
                   subtract_model is not None)
        imager.scale_dirty(scale)
        if i == 0:
            if writer.needs_fits_grid("grid"):
                writer.write_fits_grid("grid", "grid", True,
                                       imager.get_buffer("grid"), image_p,
                                       channel)
            if writer.needs_fits_image("dirty"):
                writer.write_fits_image("dirty", "dirty image", dataset,
                                        imager.get_buffer("dirty"), image_p,
                                        channel, restoring_beam)
        major += 1

        noise = imager.noise_est()
        imager.clean_reset()
        # First cycle to measure the starting peak
        k, first_peak, _last = imager.clean_cycles(0.0, 1)
        minor += k
        peak_power = clean_ops.metric_to_power(clean_p.mode, first_peak)
        noise_threshold = noise * clean_ops.noise_threshold_scale(
            clean_p.mode, clean_p.threshold, imager.num_pols)
        mgain_threshold = (1.0 - clean_p.major_gain) * peak_power
        threshold = max(noise_threshold, mgain_threshold)
        logger.info("Threshold from noise estimate: %g", noise_threshold)
        logger.info("Threshold from mgain:          %g", mgain_threshold)
        if peak_power <= threshold:
            imager.clean_finish()
            logger.info("Threshold reached, terminating")
            break
        logger.info("CLEANing to threshold:         %g", threshold)
        threshold_metric = clean_ops.power_to_metric(clean_p.mode, threshold)
        remaining = clean_p.minor - 1
        while remaining > 0:
            batch = min(args.minor_batch, remaining)
            k, _first, _last = imager.clean_cycles(threshold_metric, batch)
            minor += k
            remaining -= batch
            if k < batch:
                break
        imager.clean_finish()
        if i == args.major - 1:
            noise = imager.noise_est()

    # Primary beam
    model = imager.get_buffer("model")
    if grid_p.fixed.beams is not None:
        pbeam_model = grid_p.fixed.beams
        coords = (np.arange(image_p.pixels) - image_p.pixels / 2) * image_p.pixel_size
        pbeam = pbeam_model.sample_grid(coords, coords,
                                        units.C_M_PER_S / image_p.wavelength)
        pbeam = pbeam.astype(image_p.fixed.real_dtype)
        imager.set_beam_power(pbeam)
        imager.apply_primary_beam(args.primary_beam_cutoff)
        writer.write_fits_image("primary_beam", "primary beam", dataset,
                                np.broadcast_to(pbeam, model.shape), image_p,
                                channel)
    else:
        pbeam = np.ones(model.shape[-2:], image_p.fixed.real_dtype)

    if writer.needs_fits_image("model"):
        writer.write_fits_image("model", "model", dataset,
                                imager.get_buffer("model"), image_p, channel)
    if writer.needs_fits_image("residuals"):
        writer.write_fits_image("residuals", "residuals", dataset,
                                imager.get_buffer("dirty"), image_p, channel,
                                restoring_beam)

    # Restore
    imager.convolve_model_with_beam(restoring_beam)
    imager.add_model_to_dirty()
    final_image = imager.get_buffer("dirty")

    writer.write_fits_image("clean", "clean image", dataset, final_image,
                            image_p, channel, restoring_beam)
    peak = find_peak(final_image, pbeam, noise)
    totals = get_totals(image_p, final_image, restoring_beam)
    compressed_vis = sum(reader.len(rel_channel, ws)
                         for ws in range(reader.num_w_slices(rel_channel)))
    stats = dict(major=major, minor=minor, peak=peak, totals=totals,
                 noise=noise, weights_noise=weights_noise,
                 normalized_noise=normalized_noise,
                 psf_patch_size=(psf_patch[2], psf_patch[1]),
                 compressed_vis=compressed_vis,
                 image_parameters=image_p, grid_parameters=grid_p,
                 clean_parameters=clean_p, restoring_beam=restoring_beam)
    writer.statistics(dataset, channel, **stats)
    return stats


# ---------------------------------------------------------------------------
# Top level

def run(args, dataset, writer, *, device=None, plain: bool = False):
    """Run the whole pipeline on ``device`` (default: by ``--host``, see
    :func:`.device.select`); ``plain`` runs every kernel's plain version
    whatever the device."""
    if args.precision == "double":
        raise NotImplementedError(
            "--precision double is not ported: the port's kernels are "
            "float32 only (ROADMAP, Queue 1)")
    if device is None:
        device = device_mod.select(getattr(args, "host", False))
    input_polarizations = dataset.polarizations()
    if dataset.has_feed_angles():
        polarization_matrices = polarization.polarization_matrices(
            args.stokes, input_polarizations)
    else:
        polarization_matrices = (
            polarization.polarization_matrix(args.stokes, input_polarizations),
            None)
    array_p = dataset.array_parameters()
    if args.stop_channel is None:
        args.stop_channel = dataset.num_channels()
    if not (0 <= args.start_channel < args.stop_channel
            <= dataset.num_channels()):
        raise ValueError("Channels are out of range")
    weight_p = parameters.WeightParameters(
        weight_ops.WeightType[args.weight_type.upper()], args.robustness)

    clean_mode = clean_ops.CLEAN_I if args.clean_mode == "I" else clean_ops.CLEAN_SUMSQ
    clean_p = parameters.CleanParameters(
        args.minor, args.loop_gain, args.major_gain, args.threshold,
        clean_mode, args.psf_cutoff, args.psf_limit, args.border)

    fixed_image_p = parameters.FixedImageParameters(
        tuple(args.stokes), args.precision)

    if args.max_w is None:
        max_w = array_p.longest_baseline
    else:
        max_w = units.parse_quantity(args.max_w).value
    beams = None
    if args.primary_beam in ("meerkat", "meerkat:1"):
        from . import primary_beam

        band = dataset.band()
        if band is None:
            raise ValueError("Data set does not specify a band, so "
                             "--primary-beam cannot be used")
        beams = primary_beam.meerkat_v1_beam(band)
    fixed_grid_p = parameters.FixedGridParameters(
        args.aa_width, args.grid_oversample, args.kernel_image_oversample,
        max_w, args.kernel_width, args.degrid, beams)

    if args.subtract == "auto":
        subtract_model = dataset.sky_model()
    elif args.subtract is not None:
        subtract_model = sky_model.open_sky_model(args.subtract)
    else:
        subtract_model = None

    results = []
    for start_channel in range(args.start_channel, args.stop_channel,
                               args.channel_batch):
        stop_channel = min(args.stop_channel, start_channel + args.channel_batch)
        channels = range(start_channel, stop_channel)
        params = [ChannelParameters(args, dataset, channel, array_p,
                                    fixed_image_p, fixed_grid_p)
                  for channel in channels]
        image_ps = [p.image_p for p in params]
        grid_ps = [p.grid_p for p in params]
        collector = preprocess_visibilities(
            dataset, args, start_channel, stop_channel, image_ps, grid_ps,
            polarization_matrices, device)
        reader = collector.reader()
        for channel_p in params:
            results.append(process_channel(
                dataset, args, start_channel, reader, writer, channel_p,
                array_p, weight_p, clean_p, subtract_model, device=device,
                plain=plain))
        reader.close()
    return results
