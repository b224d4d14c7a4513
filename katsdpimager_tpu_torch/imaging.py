"""Per-channel imaging: the state and operations of one channel.

Counterpart of :class:`katsdpimager_tpu.imaging.Imaging`, with the method
surface that the frontend calls.  The state lives on one device:

- ``grid``: the running W-slice grid as a ``(gr, gi)`` pair of (P, N, N)
  real planes (the gridder kernels' layout; no complex grid is built);
- ``dirty``, ``model``, ``psf``: (P, N, N) real images;
- the density-weight grid (:class:`.ops.weights.Weights`) and the CLEAN
  state (:mod:`.ops.clean`, every index a shape-(1,) tensor, so no minor
  cycle syncs with the host).

The W-slice loop runs through kernels K1 + K2 (grid onto the running
grid), K3 + K4 (grid -> dirty image) and, for the degridding major cycle,
K6 + K7 (model -> grid) and K5 (degrid), planned and dispatched by
:class:`MxuGridder`.  Chunk plans are cached per (w_slice, block):
coordinates are fixed across major cycles, only vis change.

``--precision double`` follows the JAX package's route on its chip: the
grid, the images, the taper, CLEAN and the beam at float64; K1 still
fills its float32 colour planes, added onto the float64 grid in plain
torch (not K2), and K5 reads float32 planes cut from the float64 model
grid; the transforms leave the kernels for ``torch.fft`` at complex128
(:func:`.ops.fourier.use_fused_fft`); the weights grid stays float32.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from . import device as device_mod
from .ops import wkernel

from .ops import beam as beam_ops
from .ops import clean as clean_ops
from .ops import fourier, fused_degrid, fused_gridder, gridder, mxu_gridder
from .ops import predict
from .ops import weights as weight_ops
from .profiling import profile_function

logger = logging.getLogger(__name__)

_logged_double = False


class MxuGridder:
    """Plan on the host, grid and degrid on the device (dense mode).

    Counterpart of :class:`katsdpimager_tpu.ops.mxu_gridder.MxuGridder`
    for a (channel, w_slice) visibility set whose coordinates are fixed
    across major cycles.  Plans are the tile-aligned layout of
    :func:`.ops.mxu_gridder.plan_chunks_tiled` at the tile size of
    :func:`.ops.mxu_gridder.tile_size`; :meth:`upload_plan` moves one to
    ``device`` once (None: the CUDA device, which must exist)."""

    def __init__(self, *, pixels: int, kernel_width: int, device=None):
        self.pixels = pixels
        self.K = kernel_width
        self.ts = mxu_gridder.tile_size(pixels, kernel_width)
        self.device = device_mod.resolve(device)

    def plan(self, uv, sub_uv, w_plane, vis, weights) -> mxu_gridder.ChunkPlan:
        """The host plan of one block of visibilities (numpy)."""
        return mxu_gridder.plan_chunks_tiled(
            np.asarray(uv), np.asarray(sub_uv), np.asarray(w_plane),
            np.asarray(vis), np.asarray(weights), pixels=self.pixels,
            kernel_width=self.K, ts=self.ts, mc=mxu_gridder.CHUNK_SIZE)

    def upload_plan(self, plan: mxu_gridder.ChunkPlan
                    ) -> mxu_gridder.ChunkPlan:
        """The plan's coordinate fields, weights and row mapping as
        tensors on the device, uploaded once (the vis payload stays
        behind: grid and degrid take ``vis_chunked``)."""
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return plan._replace(
            uv=dev(plan.uv), sub_uv=dev(plan.sub_uv),
            w_plane=dev(plan.w_plane), vis=None, weights=dev(plan.weights),
            anchor=dev(plan.anchor), valid=dev(plan.valid),
            row_chunk=dev(np.asarray(plan.row_chunk, np.int64)),
            row_slot=dev(np.asarray(plan.row_slot, np.int64)))

    def grid(self, grid, kernel, weights_grid, plan: mxu_gridder.ChunkPlan,
             vis_chunked, dw_chunks=None, n_chunks=None):
        """Add the planned chunks onto ``grid`` (a ``(gr, gi)`` pair of
        (P, N, N) planes) in place; returns it.  ``dw_chunks``
        (NC, Mc, P) gives each visibility's density weight (skipping the
        gather from ``weights_grid``); ``n_chunks`` (host int) the
        occupied chunks, else counted with a device sync."""
        if plan.uv.shape[0] == 0:
            return grid
        return fused_gridder.grid_slice(
            kernel, weights_grid, plan.uv, plan.sub_uv, plan.w_plane,
            vis_chunked, plan.anchor, plan.valid, n_chunks,
            pixels=self.pixels, ts=self.ts, dw_chunks=dw_chunks, out=grid)

    def degrid(self, grid, kernel, plan: mxu_gridder.ChunkPlan, vis_chunked,
               n_chunks=None):
        """``vis_chunked - weights * prediction`` (NC, Mc, P) from the
        ``(gr, gi)`` model grid planes.  The JAX method pads the grid by
        (ts, ts) first; K5 reads cells outside the planes as zero, which
        is what that padding gave."""
        if plan.uv.shape[0] == 0:
            return vis_chunked
        return fused_degrid.degrid_slice(
            grid, kernel, plan.uv, plan.sub_uv, plan.w_plane, plan.weights,
            vis_chunked, plan.anchor, plan.valid, n_chunks,
            pixels=self.pixels, ts=self.ts)

    def chunk_vis(self, plan: mxu_gridder.ChunkPlan, vis):
        """A flat (n, P) complex64 vis tensor in the (NC, Mc, P) chunk
        layout (zero in padding slots)."""
        out = torch.zeros(plan.weights.shape, dtype=torch.complex64,
                          device=vis.device)
        out[plan.row_chunk, plan.row_slot] = vis.to(torch.complex64)
        return out

    def unchunk_vis(self, plan: mxu_gridder.ChunkPlan, vis_chunked):
        """Inverse of :meth:`chunk_vis`: the flat (n, P) vis."""
        return vis_chunked[plan.row_chunk, plan.row_slot]


class Imaging:
    """Imaging state and operations for one channel on ``device`` (None:
    the CUDA device, which must exist; see :mod:`.device`)."""

    def __init__(self, image_p, grid_p, weight_p, clean_p, *, device=None):
        global _logged_double
        double = image_p.fixed.real_dtype == np.float64
        self._rdtype = rdtype = torch.float64 if double else torch.float32
        if double and not _logged_double:
            _logged_double = True
            logger.info("--precision double: grid, images and CLEAN in "
                        "float64; K1 and K5 at float32 with the grid "
                        "planes added in torch; transforms in torch.fft")
        self.image_p = image_p
        self.grid_p = grid_p
        self.weight_p = weight_p
        self.clean_p = clean_p
        self.device = dev = device_mod.resolve(device)

        N = image_p.pixels
        P = image_p.fixed.num_polarizations
        self.pixels = N
        self.num_pols = P

        fixed = grid_p.fixed
        self.kernel = torch.from_numpy(np.ascontiguousarray(
            wkernel.make_convolution_kernel(image_p, grid_p),
            np.complex64)).to(dev)
        beta = wkernel.default_beta(fixed.antialias_width)
        self.taper1d = torch.from_numpy(wkernel.taper(
            N, fixed.antialias_width, fixed.oversample, beta).astype(
                image_p.fixed.real_dtype)).to(dev)
        self.mid_w = wkernel.mid_w_values(image_p, grid_p)
        self._uv_scale, self._w_scale, self._w_bias = predict.uvw_scale_bias(
            image_p, grid_p)

        def zeros():
            return torch.zeros((P, N, N), dtype=rdtype, device=dev)

        self.grid = (zeros(), zeros())
        self.dirty = zeros()
        self.model = zeros()
        self.psf = zeros()
        self.weights = weight_ops.Weights(weight_p.weight_type, P, N,
                                          weight_p.robustness, device=dev)
        self.beam_power: Optional[torch.Tensor] = None

        self._clean_cfg: Optional[clean_ops.CleanConfig] = None
        self._clean_state: Optional[clean_ops.CleanState] = None
        self._psf_patch_arr: Optional[torch.Tensor] = None
        self._sky_lmn = self._sky_flux = None
        self._model_lmn = self._model_flux = None
        self._model_xi = self._model_yi = None

        self._mxu = MxuGridder(pixels=N, kernel_width=fixed.kernel_width,
                               device=dev)
        self._plans: dict = {}
        self._dw_cache: dict = {}

    # ------------------------------------------------------------------
    # clearing

    def clear_grid(self):
        for plane in self.grid:
            plane.zero_()

    def clear_dirty(self):
        self.dirty = torch.zeros_like(self.dirty)

    def clear_model(self):
        self.model = torch.zeros_like(self.model)

    # ------------------------------------------------------------------
    # weights

    def clear_weights(self):
        self.weights.clear()
        self._dw_cache.clear()

    def grid_weights(self, uv: np.ndarray, weights: np.ndarray):
        self.weights.accumulate(np.asarray(uv), np.asarray(weights))

    def finalize_weights(self):
        return self.weights.finalize()

    @property
    def weights_grid(self):
        return self.weights.grid

    # ------------------------------------------------------------------
    # gridding / degridding / prediction

    def _tensor(self, a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    @staticmethod
    def _plan_key(chunk, w_slice: int, block: int):
        """Plan cache key: (w_slice, block, size, coordinate fingerprint),
        the fingerprint a strided sum of the uv coordinates, as in the JAX
        class."""
        uv = np.asarray(chunk.uv)
        n = len(uv)
        fp = int(uv[:: max(1, n // 64)].sum(dtype=np.int64)) if n else 0
        return (w_slice, block, n, fp)

    @profile_function("imaging.slice_plan")
    def _slice_plan(self, chunk, w_slice: int, block: int = 0):
        """(device plan, occupied chunks) of one block, planned on the host
        and uploaded once."""
        key = self._plan_key(chunk, w_slice, block)
        entry = self._plans.get(key)
        if entry is None:
            host = self._mxu.plan(chunk.uv, chunk.sub_uv, chunk.w_plane,
                                  np.asarray(chunk.vis, np.complex64),
                                  chunk.weights)
            entry = (self._mxu.upload_plan(host),
                     int(host.valid.any(axis=1).sum()))
            self._plans[key] = entry
        return entry

    def grid_slice(self, chunk, vis, w_slice: int, block: int = 0):
        """Grid a (channel, w_slice) visibility set (or one block of it)
        onto the running grid.  ``vis`` may be numpy or a tensor."""
        plan, n = self._slice_plan(chunk, w_slice, block)
        if n == 0:
            return
        vis_chunked = self._mxu.chunk_vis(plan,
                                          self._tensor(vis, torch.complex64))
        dw = None
        if self.weights.weight_type != weight_ops.WeightType.NATURAL:
            key = self._plan_key(chunk, w_slice, block)
            dw = self._dw_cache.get(key)
            if dw is None:
                # Each visibility's density weight, gathered on the device
                # once per plan (padding slots read the centre cell and are
                # masked by ``valid``).
                half = self.pixels // 2
                cells = plan.uv.long() + half
                dw = self.weights.grid[:, cells[..., 1], cells[..., 0]]
                dw = dw.permute(1, 2, 0).contiguous()
                self._dw_cache[key] = dw
        self._mxu.grid(self.grid, self.kernel, None, plan, vis_chunked,
                       dw_chunks=dw, n_chunks=n)

    def grid_chunk(self, chunk, vis):
        """Grid (pre-weighted) visibilities onto the running grid with the
        scatter gridder (:mod:`.ops.gridder`); ``vis`` is (n, P) complex or
        real (the weights, for the PSF).  :meth:`grid_slice` is the fast
        path."""
        gr, gi = self.grid
        grid = gridder.grid_vis(
            torch.complex(gr, gi), self.kernel, self.weights.grid,
            self._tensor(chunk.uv, torch.int32),
            self._tensor(chunk.sub_uv, torch.int32),
            self._tensor(chunk.w_plane, torch.int32),
            self._tensor(vis, torch.complex64), pixels=self.pixels)
        self.grid = (grid.real.contiguous(), grid.imag.contiguous())

    def degrid_slice(self, chunk, vis, model_grid, w_slice: int,
                     block: int = 0):
        """``vis`` less the weighted degridded prediction of ``model_grid``
        (a ``(gr, gi)`` pair) for a slice (or one block of it); the result
        stays on the device."""
        plan, n = self._slice_plan(chunk, w_slice, block)
        vis = self._tensor(vis, torch.complex64)
        vis_chunked = self._mxu.chunk_vis(plan, vis)
        out = self._mxu.degrid(model_grid, self.kernel, plan, vis_chunked,
                               n_chunks=n)
        return self._mxu.unchunk_vis(plan, out)

    def degrid_chunk(self, chunk, vis, model_grid):
        """``vis`` less the weighted prediction of ``model_grid`` (a
        ``(gr, gi)`` pair) by the scatter degridder (:mod:`.ops.gridder`);
        the result stays on the device.  :meth:`degrid_slice` is the fast
        path."""
        gr, gi = model_grid
        return gridder.degrid_vis(
            torch.complex(gr, gi), self.kernel,
            self._tensor(chunk.uv, torch.int32),
            self._tensor(chunk.sub_uv, torch.int32),
            self._tensor(chunk.w_plane, torch.int32),
            self._tensor(chunk.weights, torch.float32),
            self._tensor(vis, torch.complex64), pixels=self.pixels)

    def predict_chunk(self, chunk, vis, w_slice: int, lmn, flux):
        """``vis`` less the direct DFT prediction of (lmn, flux); the
        result stays on the device."""
        if lmn is None or lmn.shape[0] == 0:
            return vis
        return predict.predict_subtract(
            lmn, flux, self._tensor(chunk.uv, torch.int32),
            self._tensor(chunk.sub_uv, torch.int32),
            self._tensor(chunk.w_plane, torch.int32),
            self._tensor(vis, torch.complex64),
            self._tensor(chunk.weights, torch.float32),
            self._uv_scale, self._w_scale,
            float(np.float32(self._w_bias + self.mid_w[w_slice])),
            oversample=self.grid_p.fixed.oversample)

    # ------------------------------------------------------------------
    # model component extraction (for the major cycle)

    def set_sky_model(self, lmn: np.ndarray, flux: np.ndarray):
        """Continuum-subtraction sky model."""
        self._sky_lmn = self._tensor(lmn, torch.float32)
        self._sky_flux = self._tensor(flux, torch.float32)

    def model_to_predict(self):
        """Extract the CLEAN components of the model image for direct
        prediction (a host round trip, as in the reference).  Components
        sit on image pixels, so their pixel indices are kept for the
        exact predict (:meth:`model_predict`)."""
        lmn, flux, xi, yi = predict.extract_sky_image(
            self.image_p, self.grid_p, self.model.cpu().numpy(),
            return_pixels=True)
        self._model_lmn = self._tensor(lmn, torch.float32)
        self._model_flux = self._tensor(flux, torch.float32)
        self._model_xi = self._tensor(xi, torch.int32)
        self._model_yi = self._tensor(yi, torch.int32)

    def model_to_grid(self, w: float):
        """The model image's grid at W ``w`` as (gr, gi) planes, for
        degridding."""
        return fourier.image_to_grid_parts(
            self.model, self.taper1d, float(w), self.image_p.pixel_size)

    def continuum_predict(self, chunk, vis, w_slice: int):
        return self.predict_chunk(chunk, vis, w_slice, self._sky_lmn,
                                  self._sky_flux)

    def model_predict(self, chunk, vis, w_slice: int):
        """``vis`` less the direct prediction of the model's components:
        the DFT (:meth:`predict_chunk`), or with ``KTPU_PREDICT_EXACT=1``
        the trig-free predict (:func:`.ops.predict.predict_subtract_exact`),
        as in the JAX class."""
        if os.environ.get("KTPU_PREDICT_EXACT", "0") != "1":
            return self.predict_chunk(chunk, vis, w_slice, self._model_lmn,
                                      self._model_flux)
        if self._model_lmn.shape[0] == 0:
            return vis
        return predict.predict_subtract_exact(
            self._model_xi, self._model_yi, self._model_lmn[:, 2],
            self._model_flux, self._tensor(chunk.uv, torch.int32),
            self._tensor(chunk.sub_uv, torch.int32),
            self._tensor(vis, torch.complex64),
            self._tensor(chunk.weights, torch.float32),
            self._tensor(chunk.w_plane, torch.int32),
            float(np.float32(self._w_scale)),
            float(np.float32(self._w_bias + self.mid_w[w_slice])),
            pixels=self.pixels, oversample=self.grid_p.fixed.oversample,
            w_planes=self.grid_p.w_planes)

    # ------------------------------------------------------------------
    # FFT

    def grid_to_image(self, w_slice: int):
        gr, gi = self.grid
        self.dirty = fourier.grid_to_image_parts(
            gr, gi, self.dirty, self.taper1d, float(self.mid_w[w_slice]),
            self.image_p.pixel_size)

    # ------------------------------------------------------------------
    # normalisation / PSF

    def psf_peak(self) -> np.ndarray:
        N = self.pixels
        return self.dirty[:, N // 2, N // 2].cpu().numpy()

    def scale_dirty(self, scale: np.ndarray):
        self.dirty = fourier.scale_image(
            self.dirty, self._tensor(scale, self._rdtype))

    def dirty_to_psf(self):
        """Buffer swap."""
        self.psf, self.dirty = self.dirty, self.psf

    def psf_patch(self):
        psf = self.psf.cpu().numpy()
        box = clean_ops.psf_patch(psf, self.clean_p.psf_cutoff,
                                  self.clean_p.psf_limit)
        N = self.pixels
        y0 = N // 2 - box[1] // 2
        x0 = N // 2 - box[2] // 2
        self._psf_patch_arr = self._tensor(
            psf[:, y0:y0 + box[1], x0:x0 + box[2]], self._rdtype)
        return box

    def extract_psf_core(self, patch) -> np.ndarray:
        """Central PSF region (first polarization) for beam fitting."""
        psf = self.psf.cpu().numpy()
        y0 = (psf.shape[1] - patch[1]) // 2
        x0 = (psf.shape[2] - patch[2]) // 2
        return psf[0, y0:y0 + patch[1], x0:x0 + patch[2]]

    # ------------------------------------------------------------------
    # CLEAN

    def _border(self) -> int:
        return round(self.clean_p.border * self.pixels)

    def noise_est(self) -> float:
        return float(clean_ops.noise_est(self.dirty,
                                         border_pixels=self._border()))

    def clean_reset(self):
        box = self._psf_patch_arr.shape
        cfg = clean_ops.CleanConfig(
            pixels=self.pixels, num_pols=self.num_pols,
            border_pixels=self._border(), patch_y=int(box[1]),
            patch_x=int(box[2]), mode=self.clean_p.mode,
            loop_gain=self.clean_p.loop_gain)
        self._clean_cfg = cfg
        self._clean_state = clean_ops.make_state(cfg, self.dirty, self.model)

    def clean_cycles(self, threshold: float, max_cycles: int):
        """Run up to ``max_cycles`` minor cycles on the device; returns
        (cycles_done, first_peak_metric, last_peak_metric)."""
        self._clean_state, k, first, last = clean_ops.minor_cycles(
            self._clean_cfg, self._clean_state, self._psf_patch_arr,
            threshold, max_cycles)
        return int(k), float(first), float(last)

    def clean_finish(self):
        """Copy CLEAN results back to the dirty/model buffers."""
        self.dirty = clean_ops.residual_image(self._clean_cfg,
                                              self._clean_state).contiguous()
        self.model = self._clean_state.model

    # ------------------------------------------------------------------
    # finishing

    def set_beam_power(self, beam_power: np.ndarray):
        self.beam_power = self._tensor(beam_power, self._rdtype)

    def apply_primary_beam(self, cutoff: float):
        self.dirty = fourier.apply_primary_beam(
            self.dirty, self.beam_power, cutoff, float("nan"))
        self.model = fourier.apply_primary_beam(
            self.model, self.beam_power, cutoff, 0.0)

    def convolve_model_with_beam(self, restoring_beam: beam_ops.Beam):
        self.model = beam_ops.convolve_beam(self.model, restoring_beam)

    def add_model_to_dirty(self):
        self.dirty = fourier.add_image(self.dirty, self.model)

    def get_buffer(self, name: str) -> np.ndarray:
        """A state buffer as numpy (``grid`` as complex64)."""
        if name == "weights_grid":
            return self.weights.grid.cpu().numpy()
        if name == "grid":
            gr, gi = self.grid
            return torch.complex(gr, gi).cpu().numpy()
        return getattr(self, name).cpu().numpy()
