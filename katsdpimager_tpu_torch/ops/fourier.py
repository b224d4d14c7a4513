r"""Grid <-> image transforms with the imaging corrections, and image ops.

Counterpart of :mod:`katsdpimager_tpu.ops.fourier`.  ``grid_to_image``
inverse-transforms the centred grid, unnormalised as the reference's
cuFFT is, multiplies by the W correction :math:`e^{2\pi i w(n-1)}`, keeps
the real part, multiplies by :math:`n = \sqrt{1 - l^2 - m^2}`, divides by
the separable taper and accumulates.  ``image_to_grid`` is its forward
counterpart for degridding: it divides by the taper and by ``n`` and
applies the conjugate W phase before a forward DFT.  The fftshifts fold
into :math:`(-1)^{x+y}` checkerboards on both sides of the DFT (N even).

:func:`grid_to_image` and :func:`image_to_grid` are the plain formulas,
the composite plain versions of kernels K3 + K4 and K6 + K7;
:func:`grid_to_image_parts` and :func:`image_to_grid_parts` send CUDA
tensors through the kernels (:mod:`.fused_fft`) and CPU tensors through
the plain formulas.
"""

from __future__ import annotations

import math

import torch

from .fused_fft import (checkerboard, grid_to_image_fused_parts,
                        image_to_grid_fused_parts, sqrt_rn)


def _lm_grids(pixels: int, pixel_size, dtype, device) -> torch.Tensor:
    """n = sqrt(1 - l^2 - m^2) over the centred image layout, with
    lm(x) = pixel_size * x - pixels/2 * pixel_size."""
    pixel_size = torch.as_tensor(pixel_size, dtype=dtype, device=device)
    lm = (torch.arange(pixels, dtype=dtype, device=device) * pixel_size
          - 0.5 * pixels * pixel_size)
    lm2 = lm * lm
    return sqrt_rn(1.0 - (lm2[:, None] + lm2[None, :])).to(dtype)


def _checkerboard(pixels: int, dtype, device) -> torch.Tensor:
    """(-1)^(x+y) over an (N, N) array (N even)."""
    return checkerboard(pixels, device).to(dtype)


def grid_to_image(grid, image, kernel1d, w, pixel_size):
    """Plain formula: accumulate the W-corrected layer of the centred
    (P, N, N) complex ``grid`` into the real ``image``; returns the sum."""
    pixels = image.shape[-1]
    rdtype = image.dtype
    dev = image.device
    cb = _checkerboard(pixels, rdtype, dev)
    layer = torch.fft.ifft2(grid * cb)
    scale = pixels * pixels  # match the unnormalised cuFFT inverse
    n = _lm_grids(pixels, pixel_size, rdtype, dev)
    w = torch.as_tensor(w, dtype=rdtype, device=dev)
    phase = (2 * math.pi) * w * (n - 1.0)
    k1d = torch.as_tensor(kernel1d, device=dev)
    taper2 = torch.outer(k1d, k1d).to(rdtype)
    common = cb * (n * scale) / taper2
    a = torch.cos(phase) * common
    b = -torch.sin(phase) * common
    return image + (layer.real * a + layer.imag * b).to(rdtype)


def grid_to_image_parts(gr, gi, image, kernel1d, w, pixel_size):
    """:func:`grid_to_image` taking the grid as (P, N, N) f32 re/im planes.

    CUDA tensors run kernels K3 and K4 on the transposed image; CPU
    tensors run the plain formula.  Returns the new image."""
    if gr.device.type == "cpu":
        return grid_to_image(torch.complex(gr, gi), image, kernel1d, w,
                             pixel_size)
    imageT = image.transpose(-1, -2).contiguous()
    grid_to_image_fused_parts(gr, gi, imageT, kernel1d, w, pixel_size)
    return imageT.transpose(-1, -2).contiguous()


def image_to_grid(image, kernel1d, w, pixel_size):
    """Plain formula: the (P, N, N) complex centred grid whose
    :func:`grid_to_image` is ``image`` (forward DFT of the corrected
    layer ``image * cb / (taper^2 n) * e^{-2 pi i w (n - 1)}``)."""
    pixels = image.shape[-1]
    rdtype = image.dtype
    dev = image.device
    cb = _checkerboard(pixels, rdtype, dev)
    n = _lm_grids(pixels, pixel_size, rdtype, dev)
    k1d = torch.as_tensor(kernel1d, device=dev)
    taper2 = torch.outer(k1d, k1d).to(rdtype)
    w = torch.as_tensor(w, dtype=rdtype, device=dev)
    phase = (-2 * math.pi) * w * (n - 1.0)
    pre = cb / (taper2 * n)
    layer = (image * pre) * torch.complex(torch.cos(phase), torch.sin(phase))
    return torch.fft.fft2(layer) * cb


def image_to_grid_parts(image, kernel1d, w, pixel_size, *,
                        plain: bool = False):
    """:func:`image_to_grid` returning the grid as (P, N, N) f32 re/im
    planes (the fused degridder's input layout).

    CUDA tensors run kernels K6 and K7 on the transposed image (their
    plain versions with ``plain``); CPU tensors run the plain formula."""
    if image.device.type == "cpu":
        g = image_to_grid(image, kernel1d, w, pixel_size)
        return (g.real.to(torch.float32).contiguous(),
                g.imag.to(torch.float32).contiguous())
    imageT = image.transpose(-1, -2).contiguous()
    return image_to_grid_fused_parts(imageT, kernel1d, w, pixel_size,
                                     plain=plain)


def scale_image(image, scale):
    """Per-polarization scalar multiply."""
    return image * scale[:, None, None]


def add_image(dest, src):
    return dest + src


def apply_primary_beam(image, beam_power, cutoff, replacement):
    """Divide by the primary-beam power, replacing pixels below ``cutoff``
    (NaN for sky images, 0 for model images)."""
    return torch.where(beam_power[None] >= cutoff, image / beam_power[None],
                       replacement)
