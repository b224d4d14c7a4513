r"""Direct prediction: DFT of point-source components, subtracted.

Counterpart of :mod:`katsdpimager_tpu.ops.predict` (``uvw_scale_bias``,
``extract_sky_image``, ``predict_subtract``):

- quantized UV is dequantized at bin centres:
  ``uv_wl = (uv * oversample + sub_uv + 0.5) * cell / (oversample * lambda)``;
- w is dequantized per plane and offset by the W-slice mid-w;
- the predicted visibility is ``sum_s flux[s] * exp(-2 pi i (u l + v m +
  w (n-1)))`` and ``weights * predicted`` is subtracted from the stored
  (pre-weighted) visibilities;
- fluxes are tapered by ``sinc(l / (image_size * oversample))`` per axis to
  mirror the quantisation of the UV coordinates.

The JAX package evaluates the DFT as products in XLA, in blocks of 8192
visibilities: the phase matrix ``(B, 3) @ (3, S)``, then its cosine and
sine times the flux.  Here the same products are ``torch.matmul`` in f32
(``Precision.HIGHEST`` there; TF32 must stay off on the card,
``torch.backends.cuda.matmul.allow_tf32 = False``).  The trig-free
``predict_subtract_exact`` (``KTPU_PREDICT_EXACT=1``) is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def uvw_scale_bias(image_parameters, grid_parameters):
    """(uv_scale, w_scale, w_bias) in wavelengths for dequantization."""
    ip, gp = image_parameters, grid_parameters
    uv_scale = ip.cell_size / gp.fixed.oversample / ip.wavelength
    w_scale = gp.fixed.max_w / ((gp.w_slices - 0.5) * gp.w_planes) / ip.wavelength
    w_bias = (0.5 - 0.5 * gp.w_planes) * w_scale
    return float(uv_scale), float(w_scale), float(w_bias)


def extract_sky_image(image_parameters, grid_parameters,
                      model_image: np.ndarray):
    """Non-zero model-image pixels as (lmn (S, 3) float32 with n-1 in the
    last column, flux (S, P) tapered, in the model's dtype); numpy."""
    ip = image_parameters
    mask = np.any(model_image != 0, axis=0)
    ys, xs = np.nonzero(mask)
    pixel_size = float(ip.pixel_size)
    l = (xs - 0.5 * ip.pixels) * pixel_size
    m = (ys - 0.5 * ip.pixels) * pixel_size
    n1 = np.sqrt(1.0 - (np.square(l) + np.square(m))) - 1.0
    lmn = np.stack([l, m, n1], axis=-1).astype(np.float32)
    flux = model_image[:, ys, xs].T.astype(np.float64)
    taper_scale = float(ip.image_size * grid_parameters.fixed.oversample)
    taper = np.sinc(l / taper_scale) * np.sinc(m / taper_scale)
    flux = (flux * taper[:, None]).astype(model_image.dtype)
    return lmn, flux


def predict_subtract(lmn, flux, uv, sub_uv, w_plane, vis, weights,
                     uv_scale, w_scale, w_bias, *, oversample: int,
                     block: int = 8192):
    """``vis - weights * DFT(lmn, flux)`` at the visibilities' dequantized
    coordinates.

    lmn (S, 3) f32 (l, m, n-1); flux (S, P) real; uv/sub_uv (N, 2) and
    w_plane (N,) integer; vis (N, P) complex64; weights (N, P) f32.
    ``w_bias`` must already include the W-slice mid-w.  The DFT runs in
    blocks of ``block`` visibilities, so the (block, S) phase matrix stays
    bounded.  Returns a new (N, P) complex64 tensor."""
    f32 = torch.float32
    u = (uv[:, 0].to(f32) * oversample + sub_uv[:, 0].to(f32) + 0.5) * uv_scale
    v = (uv[:, 1].to(f32) * oversample + sub_uv[:, 1].to(f32) + 0.5) * uv_scale
    w = w_plane.to(f32) * w_scale + w_bias
    uvw = torch.stack([u, v, w], dim=-1)                     # (N, 3)
    lmn_t = lmn.to(f32).transpose(0, 1)
    fluxf = flux.to(f32)
    out = torch.empty_like(vis)
    for b0 in range(0, vis.shape[0], block):
        b1 = min(vis.shape[0], b0 + block)
        phase = (-2 * math.pi) * (uvw[b0:b1] @ lmn_t)        # (B, S)
        pred = torch.complex(torch.cos(phase) @ fluxf,
                             torch.sin(phase) @ fluxf)
        out[b0:b1] = vis[b0:b1] - weights[b0:b1] * pred
    return out
