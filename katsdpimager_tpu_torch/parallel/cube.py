"""Spectral-cube imaging: the full per-channel Cotton-Schwab pipeline.

Counterpart of :mod:`katsdpimager_tpu.parallel.cube` on one device.  A
wave of channels runs, channel after channel:

1. imaging weights (natural, uniform or robust) and the PSF, gridded from
   the weights through the dirty-image path (kernels K1-K4);
2. with a sky model (``cfg.num_sources > 0``, ``--subtract``), its DFT
   subtracted once from the stored visibilities of every non-empty W
   slice (:func:`_predict_subtract_slices`);
3. ``majors`` major cycles: the first images the visibilities; each later
   one first subtracts the degridded model from every non-empty W slice
   (K6 and K7 transform the model to grid planes, K5 predicts), then
   images the residual visibilities; each ends with a CLEAN stage whose
   threshold, ``max(noise * sigma, (1 - major_gain) * peak)``, is derived
   on the device;
4. on the host, a restoring beam fitted to each channel's PSF core
   (:func:`fit_wave_beams`); then :func:`wave_restore` convolves each
   model with its beam and adds the residual.

The JAX package shards the channels over a mesh and vmaps them; here a
rank's ``vmap`` over its channels is a loop over them, and under a
``mesh`` (:mod:`.mesh`) with ``vis_size > 1`` this rank holds a block of
each channel's chunks: the weight grid and every slice's grid planes are
summed over its vis group (:func:`.mesh.psum`, where the JAX package
has ``psum``), so every rank of the group holds the same dirty images
and runs the same CLEAN, as each JAX vis shard does.  Degridding,
prediction and CLEAN need no collective.  Each slice's occupied-chunk
count is a host int (:attr:`ChannelBatch.n_chunks`), so empty slices are
skipped without a device sync; the skip follows the group's maximum of
the counts (:func:`.mesh.pmax_ints`).

The precision follows the batch's dtypes
(:func:`.multichannel.precision_of`): complex64 visibilities and a
float32 taper run every kernel; complex128 and float64 (``--precision
double``) take the JAX wave's complex path, on the per-channel CLI's
double route: K1's float32 colour planes added onto float64 grids,
``torch.fft`` at complex128, CLEAN, the beam and the restore at float64,
and K5 on float32 planes cut from the float64 model's grid.  The weight
grid and the density stay float32 at both.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import beam as beam_ops
from ..ops import clean as clean_ops
from ..ops import fourier, fused_degrid, predict
from ..profiling import profile_function
from . import multichannel
from .mesh import pmax_ints, psum


@dataclasses.dataclass(frozen=True)
class CubeConfig:
    """Static configuration for cube-mode imaging."""

    pixels: int
    num_pols: int
    kernel_width: int
    oversample: int
    w_planes: int
    w_slices: int
    chunks_per_slice: int
    chunk_size: int
    rv: int = 64
    ru: int = 64
    # CLEAN
    majors: int = 2
    minor: int = 512
    patch: int = 65
    psf_core: int = 64
    border_pixels: int = 0
    loop_gain: float = 0.1
    major_gain: float = 0.85
    threshold_sigma: float = 5.0
    clean_mode: int = clean_ops.CLEAN_I
    #: "natural", "uniform" or "robust"
    weight_type: str = "natural"
    robustness: float = 0.0
    #: sky-model capacity for continuum subtraction (``--subtract``); 0
    #: disables the subtraction stage
    num_sources: int = 0
    #: apply primary-beam correction in the restore stage
    primary_beam: bool = False
    primary_beam_cutoff: float = 0.1

    @property
    def clean_cfg(self) -> clean_ops.CleanConfig:
        return clean_ops.CleanConfig(
            pixels=self.pixels, num_pols=self.num_pols,
            border_pixels=self.border_pixels, patch_y=self.patch,
            patch_x=self.patch, mode=self.clean_mode,
            loop_gain=self.loop_gain)


class SkyBatch(NamedTuple):
    """Per-wave continuum-subtraction model, zero-padded to
    ``cfg.num_sources`` rows (a zero-flux row subtracts exactly zero)."""

    lmn: torch.Tensor         # (C, Smax, 3) float32 (l, m, n-1)
    flux: torch.Tensor        # (C, Smax, P) float32, sinc-tapered
    uvw_scales: torch.Tensor  # (C, 3) float32 (uv_scale, w_scale, w_bias)


class WaveResult(NamedTuple):
    residual: torch.Tensor   # (C, P, N, N)
    model: torch.Tensor      # (C, P, N, N)
    psf_core: torch.Tensor   # (C, P, core, core)
    noise: torch.Tensor      # (C,)
    psf_peak: torch.Tensor   # (C, P)
    minor: torch.Tensor      # (C,) int32 total minor cycles over majors
    weights_noise: torch.Tensor      # (C,) thermal RMS from weights (<0: n/a)
    normalized_noise: torch.Tensor   # (C,) RMS relative to natural


class PsfWaveResult(NamedTuple):
    density: torch.Tensor   # (C, P, N, N) imaging-weight density
    psf: torch.Tensor       # (C, P, N, N), peak-normalized
    psf_peak: torch.Tensor  # (C, P)
    scale: torch.Tensor     # (C, P)
    weights_noise: torch.Tensor     # (C,) thermal RMS from weights (<0: n/a)
    normalized_noise: torch.Tensor  # (C,)


def _check_supported(cfg: CubeConfig, vis, taper1d) -> None:
    multichannel.precision_of(vis, taper1d)


def _wave_sky(cfg: CubeConfig, sky):
    """The wave's sky model where ``cfg.num_sources > 0`` (it must be
    given there), else None."""
    if cfg.num_sources == 0:
        return None
    if sky is None:
        raise ValueError("cfg.num_sources > 0 requires a SkyBatch")
    return sky


def _grid_slices(cfg: CubeConfig, kernel, density, uv, sub_uv, w_plane,
                 anchor, valid, vis, taper1d, pixel_size, mid_w, nc_slices,
                 mesh=None, take=None):
    """W-stacked image of chunked visibilities (K1, K2 and the routed
    grid -> image transform per slice, each slice's grid summed over the
    vis group: :func:`multichannel.image_slices`)."""
    if cfg.weight_type == "natural":
        density = None   # density == 1: skip the per-vis window lookups
    return multichannel.image_slices(
        kernel, density, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane,
        anchor, valid, vis, nc_slices, pixels=cfg.pixels, ts=cfg.rv,
        mesh=mesh, take=take)


def _degrid_slices(cfg: CubeConfig, kernel, model, uv, sub_uv, w_plane,
                   anchor, valid, weights, vis, taper1d, pixel_size, mid_w,
                   nc_slices):
    """Every slice's visibilities less the degridded model (K6, K7, K5
    per non-empty slice); an empty slice keeps its visibilities.  K5
    takes square tiles: ``rv != ru`` (an XLA assembly in the JAX
    package) raises."""
    if cfg.rv != cfg.ru:
        raise NotImplementedError(
            f"the fused degridder takes rv == ru, not rv={cfg.rv}, "
            f"ru={cfg.ru}; no other degridder is ported")
    out = []
    for s, nc_s in enumerate(nc_slices):
        if nc_s == 0:
            out.append(vis[s])
            continue
        grid = fourier.image_to_grid_parts(model, taper1d, mid_w[s],
                                           pixel_size)
        out.append(fused_degrid.degrid_slice(
            grid, kernel, uv[s], sub_uv[s], w_plane[s], weights[s], vis[s],
            anchor[s], valid[s], int(nc_s), pixels=cfg.pixels, ts=cfg.rv))
    return torch.stack(out)


#: Visibility rows per DFT block times sky-model rows: bounds the
#: (block, Smax) phase matrix of :func:`_predict_subtract_slices`.
_PREDICT_BLOCK_ELEMENTS = 1 << 25


def _predict_subtract_slices(cfg: CubeConfig, sky_lmn, sky_flux, uv, sub_uv,
                             w_plane, valid, weights, vis, uvw_scales, mid_w,
                             nc_slices):
    """Continuum subtraction: every non-empty slice's stored (weighted)
    visibilities less the weighted DFT of the sky model, at coordinates
    dequantised at bin centres, ``w = wp * w_scale + (w_bias + mid_w[s])``
    (:func:`..ops.predict.predict_subtract`).  Only the first
    ``nc_slices[s]`` chunks hold valid slots; invalid slots keep their
    visibilities (a select), and an empty slice is returned as it is.
    The scales stay 0-d device tensors: no host sync."""
    out = []
    Pp = vis.shape[-1]
    block = max(8192, _PREDICT_BLOCK_ELEMENTS // max(1, sky_lmn.shape[0]))
    for s, nc_s in enumerate(nc_slices):
        nc_s = int(nc_s)
        if nc_s == 0:
            out.append(vis[s])
            continue
        live = vis[s, :nc_s]
        sub = predict.predict_subtract(
            sky_lmn, sky_flux, uv[s, :nc_s].reshape(-1, 2),
            sub_uv[s, :nc_s].reshape(-1, 2), w_plane[s, :nc_s].reshape(-1),
            live.reshape(-1, Pp), weights[s, :nc_s].reshape(-1, Pp),
            uvw_scales[0], uvw_scales[1], uvw_scales[2] + mid_w[s],
            oversample=cfg.oversample, block=block).reshape(live.shape)
        sub = torch.where(valid[s, :nc_s, :, None], sub, live)
        out.append(torch.cat([sub, vis[s, nc_s:]]))
    return torch.stack(out)


@profile_function("cube.clean_stage")
def _clean_stage(cfg: CubeConfig, residual, model, psf_patch_arr):
    """One major cycle's CLEAN: reset the tiles, derive the threshold on
    the device, run the minor cycles.  Updates ``model`` in place.
    Returns (residual, model, noise, cycles)."""
    ccfg = cfg.clean_cfg
    noise = clean_ops.noise_est(residual, border_pixels=cfg.border_pixels)
    state = clean_ops.make_state(ccfg, residual, model)
    zero = torch.zeros((), dtype=residual.dtype, device=residual.device)
    # The first cycle measures the starting peak (threshold 0 always fires).
    state, k1, first_peak, _ = clean_ops.minor_cycles(
        ccfg, state, psf_patch_arr, zero, 1)
    nts = clean_ops.noise_threshold_scale(cfg.clean_mode,
                                          cfg.threshold_sigma, cfg.num_pols)
    if cfg.clean_mode == clean_ops.CLEAN_SUMSQ:
        peak_power = torch.sqrt(first_peak)
    else:
        peak_power = first_peak
    threshold_power = torch.maximum(noise * nts,
                                    (1.0 - cfg.major_gain) * peak_power)
    if cfg.clean_mode == clean_ops.CLEAN_SUMSQ:
        threshold = threshold_power * threshold_power
    else:
        threshold = threshold_power
    state, k2, _, _ = clean_ops.minor_cycles(ccfg, state, psf_patch_arr,
                                             threshold, cfg.minor - 1)
    cycles = (k1 + k2).to(torch.int32)
    return clean_ops.residual_image(ccfg, state), state.model, noise, cycles


def _channel_density_psf(cfg: CubeConfig, kernel, taper1d, pixel_size,
                         mid_w, uv, sub_uv, w_plane, anchor, valid, weights,
                         nc_slices, mesh=None, take=None):
    """Imaging weights and the normalized PSF of one channel (this rank's
    chunks of it under a ``mesh``: the weight grid and the PSF's grids
    are summed over the vis group)."""
    N, Pp = cfg.pixels, cfg.num_pols
    half = N // 2
    dev = weights.device
    cdtype = (torch.complex128 if taper1d.dtype == torch.float64
              else torch.complex64)

    # ---- imaging weights (natural / uniform / robust; Briggs formulas,
    # including the robust mean-weight pass)
    if cfg.weight_type in ("uniform", "robust"):
        wgrid = psum(multichannel.weight_grid(
            Pp, N, uv, valid, weights, anchor=anchor, ts=cfg.rv,
            kernel_width=cfg.kernel_width), mesh)
        if cfg.weight_type == "robust":
            w0 = wgrid[0]
            mean_w = (w0 * w0).sum() / w0.sum()
            s2 = (5.0 * 10.0 ** (-cfg.robustness)) ** 2 / mean_w
            density = torch.where(
                wgrid > 0,
                1.0 / (torch.where(wgrid > 0, wgrid, 1.0) * s2 + 1.0), 0.0)
        else:
            density = torch.where(
                wgrid > 0, 1.0 / torch.where(wgrid > 0, wgrid, 1.0), 0.0)
        # Thermal-noise statistics from the weights.
        w0 = wgrid[0]
        d0 = density[0]
        sum_w = w0.sum()
        sum_dw = (d0 * w0).sum()
        sum_d2w = (d0 * d0 * w0).sum()
        w_rms = torch.sqrt(sum_d2w) / sum_dw.clamp(min=1e-30)
        w_norm = w_rms * torch.sqrt(sum_w)
    elif cfg.weight_type == "natural":
        density = torch.ones((Pp, N, N), dtype=torch.float32, device=dev)
        # natural weighting reports no weights-derived RMS (sentinel < 0)
        w_rms = torch.tensor(-1.0, device=dev)
        w_norm = torch.tensor(1.0, device=dev)
    else:
        raise ValueError(f"unknown weight_type {cfg.weight_type!r}")

    # ---- PSF: grid the weights as visibilities
    psf = _grid_slices(cfg, kernel, density, uv, sub_uv, w_plane, anchor,
                       valid, weights.to(cdtype) * valid[..., None],
                       taper1d, pixel_size, mid_w, nc_slices, mesh=mesh,
                       take=take)
    psf_peak = psf[:, half, half]
    scale = torch.where(psf_peak != 0,
                        1.0 / torch.where(psf_peak != 0, psf_peak, 1.0), 0.0)
    psf = fourier.scale_image(psf, scale)
    return density, psf, psf_peak, scale, w_rms, w_norm


def _channel_majors(cfg: CubeConfig, kernel, taper1d, pixel_size, mid_w,
                    uv, sub_uv, w_plane, anchor, valid, weights, vis,
                    density, scale, patch, nc_slices, sky=None,
                    mesh=None, take=None):
    """Major cycles of one channel given its density weights and PSF
    patch; with ``sky`` (this channel's ``(lmn, flux, uvw_scales)``) the
    sky model is subtracted first, once: every major cycle degrids
    against the subtracted visibilities.  Under a ``mesh`` this rank
    subtracts and degrids its own chunks, and each dirty image's grids
    are summed over the vis group.  Returns (residual, model, noise,
    minor cycles in all)."""
    N, Pp = cfg.pixels, cfg.num_pols
    dev = vis.device
    if sky is not None:
        vis = _predict_subtract_slices(cfg, *sky[:2], uv, sub_uv, w_plane,
                                       valid, weights, vis, sky[2], mid_w,
                                       nc_slices)
    model = torch.zeros((Pp, N, N), dtype=taper1d.dtype, device=dev)
    cur_vis = vis
    minor_total = torch.zeros((), dtype=torch.int32, device=dev)
    for major in range(cfg.majors):
        if major > 0:
            cur_vis = _degrid_slices(cfg, kernel, model, uv, sub_uv,
                                     w_plane, anchor, valid, weights, vis,
                                     taper1d, pixel_size, mid_w, nc_slices)
        dirty = _grid_slices(cfg, kernel, density, uv, sub_uv, w_plane,
                             anchor, valid, cur_vis, taper1d, pixel_size,
                             mid_w, nc_slices, mesh=mesh, take=take)
        dirty = fourier.scale_image(dirty, scale)
        residual, model, noise, cycles = _clean_stage(cfg, dirty, model,
                                                      patch)
        minor_total = minor_total + cycles
    return residual, model, noise, minor_total


def _centre(image, size: int):
    """The ``size`` x ``size`` window at the centre of (P, N, N) images
    (the JAX ``dynamic_slice`` at ``N/2 - size/2``)."""
    c0 = image.shape[-1] // 2 - size // 2
    return image[:, c0:c0 + size, c0:c0 + size]


def _channel(batch: multichannel.ChannelBatch, c: int):
    """Channel ``c``'s arrays (the 11 per-channel fields) and its host
    occupied-chunk counts."""
    *args, nc = multichannel.channel_args(batch, c)
    return tuple(args), nc


def wave_psf(cfg: CubeConfig, batch: multichannel.ChannelBatch, *,
             mesh=None) -> PsfWaveResult:
    """Phase A of the auto-patch route: density weights and the full
    normalized PSF of every channel of the wave (of this rank's chunks
    under a ``mesh``, summed over its vis group)."""
    _check_supported(cfg, batch.vis, batch.taper1d)
    outs = []
    for c in range(batch.kernel.shape[0]):
        (kern, tap, ps, midw, uv, sub, wp, anc, val, wt, _), nc = _channel(
            batch, c)
        outs.append(_channel_density_psf(cfg, kern, tap, ps, midw, uv, sub,
                                         wp, anc, val, wt, nc, mesh=mesh,
                                         take=pmax_ints(nc, mesh)))
    return PsfWaveResult(*(torch.stack(x) for x in zip(*outs)))


def _sky_of(sky, c: int):
    """Channel ``c``'s ``(lmn, flux, uvw_scales)`` of a :class:`SkyBatch`
    (None without one)."""
    return None if sky is None else tuple(x[c] for x in sky)


def wave_clean(cfg: CubeConfig, batch: multichannel.ChannelBatch,
               psf_result: PsfWaveResult, patch: int,
               sky: SkyBatch = None, *, mesh=None):
    """Phase B of the auto-patch route: the major cycles with a CLEAN
    patch of ``patch`` pixels cut from phase A's PSFs, after the
    continuum subtraction of ``sky`` where ``cfg.num_sources > 0`` (this
    rank's chunks under a ``mesh``).  Returns (residual, model, noise,
    minor), each stacked over the channels."""
    _check_supported(cfg, batch.vis, batch.taper1d)
    sky = _wave_sky(cfg, sky)
    cfgp = dataclasses.replace(cfg, patch=patch)
    outs = []
    for c in range(batch.kernel.shape[0]):
        (kern, tap, ps, midw, uv, sub, wp, anc, val, wt, vis), nc = _channel(
            batch, c)
        outs.append(_channel_majors(
            cfgp, kern, tap, ps, midw, uv, sub, wp, anc, val, wt, vis,
            psf_result.density[c], psf_result.scale[c],
            _centre(psf_result.psf[c], patch), nc, sky=_sky_of(sky, c),
            mesh=mesh, take=pmax_ints(nc, mesh)))
    return tuple(torch.stack(x) for x in zip(*outs))


def wave_image(cfg: CubeConfig, batch: multichannel.ChannelBatch,
               sky: SkyBatch = None, *, mesh=None) -> WaveResult:
    """A wave of channels through everything before the restore: weights,
    PSF, the continuum subtraction of ``sky`` where ``cfg.num_sources >
    0``, the major cycles and their CLEAN stages.  Under a ``mesh``,
    ``batch`` is this rank's shard (:func:`.multichannel.local_batch`)
    and every rank of a vis group returns the same images."""
    _check_supported(cfg, batch.vis, batch.taper1d)
    sky = _wave_sky(cfg, sky)
    outs = []
    for c in range(batch.kernel.shape[0]):
        args, nc = _channel(batch, c)
        take = pmax_ints(nc, mesh)
        kern, tap, ps, midw, uv, sub, wp, anc, val, wt, vis = args
        density, psf, psf_peak, scale, w_rms, w_norm = _channel_density_psf(
            cfg, kern, tap, ps, midw, uv, sub, wp, anc, val, wt, nc,
            mesh=mesh, take=take)
        residual, model, noise, minor = _channel_majors(
            cfg, kern, tap, ps, midw, uv, sub, wp, anc, val, wt, vis,
            density, scale, _centre(psf, cfg.patch), nc,
            sky=_sky_of(sky, c), mesh=mesh, take=take)
        outs.append((residual, model, _centre(psf, cfg.psf_core), noise,
                     psf_peak, minor, w_rms, w_norm))
    return WaveResult(*(torch.stack(x) for x in zip(*outs)))


def wave_restore(cfg: CubeConfig, model, residual, beam_m, pbeam=None):
    """Convolve each channel's model with its Gaussian restoring beam and
    add the residual.  ``beam_m`` (C, 2, 2) holds the covariance square
    roots in pixels (:func:`fit_wave_beams`).

    With ``cfg.primary_beam``, ``pbeam`` (C, N, N) is each channel's
    power beam, divided out first: the model is filled with 0 and the
    residual with NaN below the cutoff."""
    if cfg.primary_beam and pbeam is None:
        raise ValueError("cfg.primary_beam requires the power beams")
    out = []
    for c in range(model.shape[0]):
        m, r = model[c], residual[c]
        if cfg.primary_beam:
            cut = cfg.primary_beam_cutoff
            m = fourier.apply_primary_beam(m, pbeam[c], cut, 0.0)
            r = fourier.apply_primary_beam(r, pbeam[c], cut, float("nan"))
        out.append(fourier.add_image(
            beam_ops.convolve_gaussian(m, beam_m[c]), r))
    return torch.stack(out)


def fit_wave_beams(psf_cores):
    """Fit restoring beams on the host for a wave; returns the (C, 2, 2)
    float32 covariance square roots and the list of :class:`Beam`."""
    cores = np.asarray(psf_cores.cpu() if torch.is_tensor(psf_cores)
                       else psf_cores)
    beams = [beam_ops.fit_beam(core[0]) for core in cores]
    ms = np.stack([b.covariance_sqrt() for b in beams]).astype(np.float32)
    return ms, beams


#: Point sources :func:`with_point_sources` adds, and the range of their
#: fluxes in units of the expected dirty-image RMS.
NUM_SOURCES = 5
SOURCE_SNR = (10.0, 100.0)


def with_point_sources(cfg: CubeConfig, batch: multichannel.ChannelBatch,
                       seed: int = 0):
    """Add bright point sources to a (noise) batch, for CLEAN and the
    degridder to work on.

    :data:`NUM_SOURCES` positions are drawn from ``seed`` inside the
    central half of the image, at least ``2 * cfg.patch`` pixels apart;
    their fluxes are uniform in :data:`SOURCE_SNR` times each channel's
    expected dirty RMS, ``sqrt(sum |vis|^2 / 2) / sum(weights)`` over
    the valid visibilities (the PSF-normalised natural-weight dirty image
    of the noise).  Their visibilities are predicted with the port's own degrid
    path (K6, K7, K5) from a model of deltas and added, weighted, to
    ``vis``.  Returns ``(batch, positions (S, 2) [y, x], fluxes (C, S))``
    with numpy positions and fluxes."""
    N = cfg.pixels
    rng = np.random.default_rng(seed)
    sep = 2 * cfg.patch
    lo, hi = N // 4, N - N // 4
    positions: list[tuple[int, int]] = []
    while len(positions) < NUM_SOURCES:
        y, x = (int(v) for v in rng.integers(lo, hi, size=2))
        if all(max(abs(y - py), abs(x - px)) >= sep for py, px in positions):
            positions.append((y, x))
    ratios = rng.uniform(*SOURCE_SNR, size=NUM_SOURCES)
    pos = np.array(positions)
    fluxes = np.empty((batch.kernel.shape[0], NUM_SOURCES))
    new_vis = []
    for c in range(batch.kernel.shape[0]):
        (kern, tap, ps, midw, uv, sub, wp, anc, val, wt, vis), nc = _channel(
            batch, c)
        live = val[..., None]
        rms = (torch.sqrt(((vis.abs() ** 2) * live).sum() / 2)
               / (wt * live).sum()).item()
        fluxes[c] = ratios * rms
        model = torch.zeros((cfg.num_pols, N, N), dtype=tap.dtype,
                            device=vis.device)
        model[:, pos[:, 0], pos[:, 1]] = torch.as_tensor(
            fluxes[c], dtype=tap.dtype, device=vis.device)
        # vis - (-wt) * pred: the weighted prediction added
        new_vis.append(_degrid_slices(cfg, kern, model, uv, sub, wp, anc,
                                      val, -wt, vis, tap, ps, midw, nc))
    return batch._replace(vis=torch.stack(new_vis)), pos, fluxes
