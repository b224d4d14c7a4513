r"""Direct prediction: DFT of point-source components, subtracted.

Counterpart of :mod:`katsdpimager_tpu.ops.predict` (``uvw_scale_bias``,
``extract_sky_image``, ``predict_subtract``, ``predict_subtract_exact``):

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
:func:`predict_subtract_exact` (``KTPU_PREDICT_EXACT=1``) gathers each
phase factor from a table of roots of unity instead.
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
                      model_image: np.ndarray, return_pixels: bool = False):
    """Non-zero model-image pixels as (lmn (S, 3) float32 with n-1 in the
    last column, flux (S, P) tapered, in the model's dtype); numpy.  With
    ``return_pixels`` also their centre-relative int32 pixel indices
    (xi, yi), which :func:`predict_subtract_exact` takes."""
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
    if return_pixels:
        xi = (xs - ip.pixels // 2).astype(np.int32)
        yi = (ys - ip.pixels // 2).astype(np.int32)
        return lmn, flux, xi, yi
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


def predict_subtract_exact(xi, yi, n1, flux, uv, sub_uv, vis, weights,
                           w_plane, w_scale, w_bias, *, pixels: int,
                           oversample: int, w_planes: int,
                           block: int = 8192):
    """Trig-free :func:`predict_subtract` for components on image pixels.

    With ``cell_size = wavelength / image_size``, the UV phase of a
    subgrid-quantized visibility at a pixel-grid component is an exact
    multiple of ``2 pi / M``, ``M = 2 N O``: ``u l = (2 uq + 1) x / M``
    with ``uq = uv * O + sub_uv``.  So each (visibility, component) phase
    factor is one of M roots of unity, gathered from a table by an
    integer index, ``((2 uq_u + 1) x + (2 uq_v + 1) y) mod M``.  The W
    phase takes only ``w_planes`` values per slice, so it folds into
    per-plane flux columns: an (B, S) @ (S, W P) product, then each
    visibility's plane column.

    xi, yi (S,) integer centre-relative pixel indices and n1 (S,) n - 1
    (:func:`extract_sky_image` with ``return_pixels``); flux (S, P) real;
    uv/sub_uv (N, 2) and w_plane (N,) integer; vis (N, P) complex64;
    weights (N, P) f32; ``w_bias`` includes the W-slice mid-w.  Returns
    ``vis - weights * predicted``, a new (N, P) complex64 tensor.

    The index is reduced modulo M in int64, exact at every M.  The JAX
    function reduces it with ``& (M - 1)``, which is a modulo only when M
    is a power of two: it is wrong at image sizes that are not.
    """
    dev = vis.device
    f32 = torch.float32
    M = 2 * pixels * oversample
    ang = -2.0 * np.pi * np.arange(M) / M
    tab_re = torch.from_numpy(np.cos(ang).astype(np.float32)).to(dev)
    tab_im = torch.from_numpy(np.sin(ang).astype(np.float32)).to(dev)
    P = vis.shape[1]
    W = w_planes
    wvals = torch.arange(W, dtype=f32, device=dev) * w_scale + w_bias
    wphase = (-2 * math.pi) * wvals[:, None] * n1.to(f32)[None, :]
    fluxf = flux.to(f32)                                     # (S, P)
    # (S, W*P) per-plane flux columns, rotated by the w phase
    fw_re = (torch.cos(wphase)[:, :, None] * fluxf[None]).transpose(0, 1)
    fw_im = (torch.sin(wphase)[:, :, None] * fluxf[None]).transpose(0, 1)
    fw_re = fw_re.reshape(-1, W * P)
    fw_im = fw_im.reshape(-1, W * P)
    i64 = torch.int64
    au = (2 * (uv[:, 0].to(i64) * oversample + sub_uv[:, 0].to(i64)) + 1) % M
    av = (2 * (uv[:, 1].to(i64) * oversample + sub_uv[:, 1].to(i64)) + 1) % M
    xm = xi.to(i64) % M
    ym = yi.to(i64) % M
    out = torch.empty_like(vis)
    for b0 in range(0, vis.shape[0], block):
        b1 = min(vis.shape[0], b0 + block)
        k = (au[b0:b1, None] * xm[None, :]
             + av[b0:b1, None] * ym[None, :]) % M          # (B, S)
        c = tab_re[k]
        s = tab_im[k]
        re = (c @ fw_re - s @ fw_im).reshape(-1, W, P)
        im = (s @ fw_re + c @ fw_im).reshape(-1, W, P)
        idx = w_plane[b0:b1].to(i64)[:, None, None].expand(-1, 1, P)
        pred = torch.complex(torch.gather(re, 1, idx)[:, 0],
                             torch.gather(im, 1, idx)[:, 0])
        out[b0:b1] = vis[b0:b1] - weights[b0:b1] * pred
    return out
