r"""CLEAN deconvolution: tile-accelerated minor cycles on the device.

Counterpart of :mod:`katsdpimager_tpu.ops.clean`.  The image interior
(inside a ``border`` margin) is divided into 32x32 tiles; each tile's peak
metric and position are cached; a minor cycle takes the best tile,
subtracts ``loop_gain * peak`` times the PSF patch from the zero-padded
residual, records the component in the model and rescans only the tiles
the patch touched.  The peak metric is |Stokes I| (:data:`CLEAN_I`) or the
sum of squares over polarizations (:data:`CLEAN_SUMSQ`).

The JAX ``lax.while_loop`` becomes batches of :data:`CYCLE_BATCH` cycles.
Inside a batch every index and the stop test stay on the device (tensor
indexing, no ``.item()``): a cycle after the stop subtracts exactly zero
and records no component.  The host reads the stop flag once per batch.
Ties go to the first maximum (``torch.argmax``, as ``jnp.argmax``).

Unlike the JAX functions, :func:`minor_cycles` updates the state's
residual, model and tile cache IN PLACE (and returns the state): the
residual is the largest array of the stage, and nothing needs the old one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import scipy.stats
import torch
import torch.nn.functional as F

from ..profiling import profile

#: Use only Stokes I to find peaks
CLEAN_I = 0
#: Use the sum of squares of available Stokes components
CLEAN_SUMSQ = 1

#: Scales median absolute value of a zero-mean Gaussian to its standard
#: deviation: 1 / sqrt(chi2.ppf(0.5, 1)).
_MEDIAN_TO_RMS = 1.4826022185056031

_TILE = 32

#: Minor cycles queued on the device between two reads of the stop flag.
CYCLE_BATCH = 64


def metric_to_power(mode: int, metric):
    """Convert peak metric to a linear power scale (Jy/beam)."""
    return math.sqrt(metric) if mode == CLEAN_SUMSQ else metric


def power_to_metric(mode: int, power):
    return power * power if mode == CLEAN_SUMSQ else power


def noise_threshold_scale(mode: int, threshold: float,
                          num_polarizations: int) -> float:
    """Scale a Gaussian sigma threshold for the CLEAN_SUMSQ chi-squared
    metric (reference clean.py:187-204)."""
    if mode == CLEAN_I:
        return threshold
    p = 2 * scipy.stats.norm.sf(threshold)
    return float(np.sqrt(scipy.stats.chi2.isf(p, num_polarizations)))


def psf_patch(psf: np.ndarray, threshold: float, limit: float | None = None):
    """Bounding box of |psf| >= threshold, centred, odd-sized, optionally
    capped at ``limit`` of the image (reference clean.py:894-936)."""
    if limit is not None:
        hlimit = (round(limit * min(psf.shape[1], psf.shape[2])) - 1) // 2
        mid_x = psf.shape[2] // 2
        mid_y = psf.shape[1] // 2
        min_x = max(0, mid_x - hlimit)
        min_y = max(0, mid_y - hlimit)
        max_x = min(psf.shape[2] - 1, mid_x + hlimit)
        max_y = min(psf.shape[1] - 1, mid_y + hlimit)
        psf = psf[:, min_y:max_y + 1, min_x:max_x + 1]
    nz = np.nonzero(np.abs(psf) >= threshold)
    if len(nz[0]) == 0:
        return (psf.shape[0], 1, 1)
    y_dist = int(np.max(np.abs(nz[1] - psf.shape[1] // 2)))
    x_dist = int(np.max(np.abs(nz[2] - psf.shape[2] // 2)))
    return (psf.shape[0],
            min(psf.shape[1], 2 * y_dist + 1),
            min(psf.shape[2], 2 * x_dist + 1))


def _order_stats_bits(bits, k1: int, k2: int):
    """Bit patterns (shape (1,) int32) of the k1-th and k2-th smallest
    (0-based) of non-negative floats given as int32 bit patterns.

    Non-negative IEEE floats order as their bit patterns, so a 31-step
    search from the most significant bit down, each step one rank count
    over the data, finds each order statistic exactly (the JAX package's
    ``_order_stats_bits`` and the reference's GPU median), with no host
    sync.  On an NVIDIA H100 at 16.7 M pixels a noise estimate takes
    about 6.5 ms this way; ``torch.kthvalue`` took 124 ms per order
    statistic."""
    p1 = torch.zeros(1, dtype=torch.int32, device=bits.device)
    p2 = torch.zeros_like(p1)
    for b in range(30, -1, -1):
        t1 = p1 | (1 << b)
        t2 = p2 | (1 << b)
        c1 = (bits < t1).sum()
        c2 = (bits < t2).sum()
        p1 = torch.where(c1 <= k1, t1, p1)
        p2 = torch.where(c2 <= k2, t2, p2)
    return p1, p2


def noise_est(image, *, border_pixels: int):
    """Robust noise estimate: scaled median absolute value of the interior,
    a 0-d tensor on the image's device (exact median by rank search)."""
    b = border_pixels
    interior = image[:, b:image.shape[1] - b, b:image.shape[2] - b]
    a = interior.abs().to(torch.float32).reshape(-1)
    n = a.numel()
    b1, b2 = _order_stats_bits(a.view(torch.int32), (n - 1) // 2, n // 2)
    median = 0.5 * (b1.view(torch.float32) + b2.view(torch.float32))
    return median[0].to(interior.dtype) * _MEDIAN_TO_RMS


@dataclasses.dataclass(frozen=True)
class CleanConfig:
    """Static CLEAN geometry."""

    pixels: int
    num_pols: int
    border_pixels: int
    patch_y: int
    patch_x: int
    mode: int
    loop_gain: float

    @property
    def interior(self) -> int:
        return self.pixels - 2 * self.border_pixels

    @property
    def tiles(self) -> int:
        return -(-self.interior // _TILE)

    @property
    def pad(self) -> int:
        # Padding must absorb both the PSF window overhang at image edges
        # and the tile grid's overhang past the interior (ragged last tile).
        return max(max(self.patch_y, self.patch_x) // 2 + 1, _TILE)

    @property
    def window_tiles_y(self) -> int:
        return min((self.patch_y - 1) // _TILE + 2, self.tiles)

    @property
    def window_tiles_x(self) -> int:
        return min((self.patch_x - 1) // _TILE + 2, self.tiles)


class CleanState(NamedTuple):
    """Device-resident CLEAN state."""

    residual: torch.Tensor   # (P, N + 2*pad, N + 2*pad), zero-padded
    model: torch.Tensor      # (P, N, N)
    tile_max: torch.Tensor   # (T, T) peak metric per tile
    tile_pos: torch.Tensor   # (T, T, 2) int32 absolute (y, x) of each peak


def _metric(cfg: CleanConfig, window):
    """Peak metric of a residual window (P, h, w) -> (h, w)."""
    if cfg.mode == CLEAN_I:
        return window[0].abs()
    return (window * window).sum(0)


def _window_index(start, size: int, limit: int):
    """Indices ``start + arange(size)`` with ``start`` (a device scalar)
    clamped into ``[0, limit - size]``, as ``lax.dynamic_slice`` clamps."""
    start = torch.as_tensor(start).clamp(0, limit - size)
    return start + torch.arange(size, device=start.device)


def _tile_scan(cfg: CleanConfig, residual, t0y, t0x, nty: int, ntx: int):
    """Recompute tile peaks for an (nty x ntx)-tile window anchored at tile
    (t0y, t0x) (device scalars or ints).  Returns (win_max (nty, ntx),
    win_pos (nty, ntx, 2) int32)."""
    dev = residual.device
    t0y = torch.as_tensor(t0y, dtype=torch.int64, device=dev)
    t0x = torch.as_tensor(t0x, dtype=torch.int64, device=dev)
    pad = cfg.pad
    b = cfg.border_pixels
    rows = _window_index(b + pad + t0y * _TILE, nty * _TILE,
                         residual.shape[1])
    cols = _window_index(b + pad + t0x * _TILE, ntx * _TILE,
                         residual.shape[2])
    window = residual[:, rows[:, None], cols[None, :]]
    metric = _metric(cfg, window)
    # Mask positions outside the interior (ragged last tile / padding).
    iy = t0y * _TILE + torch.arange(nty * _TILE, device=dev)
    ix = t0x * _TILE + torch.arange(ntx * _TILE, device=dev)
    inside = (iy[:, None] < cfg.interior) & (ix[None, :] < cfg.interior)
    metric = torch.where(inside, metric, -1.0)

    m = metric.reshape(nty, _TILE, ntx, _TILE).permute(0, 2, 1, 3)
    m = m.reshape(nty, ntx, _TILE * _TILE)
    win_max = m.amax(dim=-1)
    idx = m.argmax(dim=-1)      # first maximum, as jnp.argmax
    ty = torch.arange(nty, device=dev)[:, None]
    tx = torch.arange(ntx, device=dev)[None, :]
    pos_y = b + (t0y + ty) * _TILE + idx // _TILE
    pos_x = b + (t0x + tx) * _TILE + idx % _TILE
    return win_max, torch.stack([pos_y, pos_x], dim=-1).to(torch.int32)


def make_state(cfg: CleanConfig, residual, model) -> CleanState:
    """Build the state from a dirty/residual image (copied, zero-padded)
    and a model, which the state takes over: minor cycles add to it in
    place."""
    pad = cfg.pad
    res_pad = F.pad(residual, (pad, pad, pad, pad))
    T = cfg.tiles
    state = CleanState(
        res_pad, model,
        torch.zeros((T, T), dtype=residual.dtype, device=residual.device),
        torch.zeros((T, T, 2), dtype=torch.int32, device=residual.device))
    return reset(cfg, state)


def reset(cfg: CleanConfig, state: CleanState) -> CleanState:
    """Recompute the whole tile cache (after the residual changed)."""
    T = cfg.tiles
    win_max, win_pos = _tile_scan(cfg, state.residual, 0, 0, T, T)
    return state._replace(tile_max=win_max, tile_pos=win_pos)


def residual_image(cfg: CleanConfig, state: CleanState):
    pad = cfg.pad
    return state.residual[:, pad:pad + cfg.pixels, pad:pad + cfg.pixels]


def _cycle(cfg: CleanConfig, st: CleanState, psf_patch_arr, threshold, k,
           first_peak, last_peak, stop):
    """One predicated minor cycle; updates ``st`` in place and returns the
    new ``(k, first_peak, last_peak, stop)``, each of shape (1,).

    Every index is a shape-(1,) device tensor: PyTorch reads a 0-d index
    tensor back to the host (``Tensor.item``), a sync per use."""
    T = cfg.tiles
    ph, pw = cfg.patch_y, cfg.patch_x
    pad = cfg.pad
    nty, ntx = cfg.window_tiles_y, cfg.window_tiles_x
    live = ~stop

    flat = torch.argmax(st.tile_max).reshape(1)
    ty, tx = flat // T, flat % T
    peak = st.tile_max[ty, tx]
    pos = st.tile_pos[ty, tx].long()                    # (1, 2)
    first_peak = torch.where(live & (k == 0), peak, first_peak)
    last_peak = torch.where(live, peak, last_peak)
    go = live & (peak >= threshold)

    py, px = pos[:, 0], pos[:, 1]
    res = st.residual
    scale = cfg.loop_gain * res[:, py + pad, px + pad]  # (P, 1)
    rows = _window_index(py + pad - ph // 2, ph, res.shape[1])
    cols = _window_index(px + pad - pw // 2, pw, res.shape[2])
    window = res[:, rows[:, None], cols[None, :]]
    res[:, rows[:, None], cols[None, :]] = torch.where(
        go, window - scale[..., None] * psf_patch_arr, window)
    old = st.model[:, py, px]
    st.model[:, py, px] = torch.where(go, old + scale, old)
    # Refresh the tile window covering the subtraction footprint (a
    # skipped cycle rescans an unchanged residual: the cache is unchanged).
    t0y = ((py - cfg.border_pixels - ph // 2) // _TILE).clamp(0, T - nty)
    t0x = ((px - cfg.border_pixels - pw // 2) // _TILE).clamp(0, T - ntx)
    win_max, win_pos = _tile_scan(cfg, res, t0y, t0x, nty, ntx)
    ry = t0y + torch.arange(nty, device=res.device)
    rx = t0x + torch.arange(ntx, device=res.device)
    st.tile_max[ry[:, None], rx[None, :]] = win_max
    st.tile_pos[ry[:, None], rx[None, :]] = win_pos
    return k + go.to(k.dtype), first_peak, last_peak, ~go


def minor_cycles(cfg: CleanConfig, state: CleanState, psf_patch_arr,
                 threshold, max_cycles: int):
    """Run up to ``max_cycles`` minor cycles on the device.

    Stops (without subtracting) when the peak metric drops below
    ``threshold`` (a number or a device scalar).  Returns ``(state,
    cycles_done, first_peak, last_peak)`` as device scalars, where
    ``first_peak`` is the metric before any subtraction this call (used
    for the major-gain threshold) and ``last_peak`` the metric that
    stopped the loop (or the last peak examined).  The state is updated
    in place.  Cycles run in batches of :data:`CYCLE_BATCH` with one host
    read of the stop flag per batch: each batch's enqueue is a
    ``clean.batch`` span, each read (the host's wait for the device) a
    ``clean.sync`` span."""
    dev = state.residual.device
    dtype = state.tile_max.dtype
    threshold = torch.as_tensor(threshold, dtype=dtype, device=dev)
    k = torch.zeros(1, dtype=torch.int32, device=dev)
    first_peak = torch.zeros(1, dtype=dtype, device=dev)
    last_peak = torch.zeros(1, dtype=dtype, device=dev)
    stop = torch.zeros(1, dtype=torch.bool, device=dev)
    done = 0
    while done < max_cycles:
        with profile("clean.batch"):
            for _ in range(min(CYCLE_BATCH, max_cycles - done)):
                k, first_peak, last_peak, stop = _cycle(
                    cfg, state, psf_patch_arr, threshold, k, first_peak,
                    last_peak, stop)
        done += CYCLE_BATCH
        with profile("clean.sync"):
            stopped = bool(stop)
        if stopped:
            break
    return state, k[0], first_peak[0], last_peak[0]
