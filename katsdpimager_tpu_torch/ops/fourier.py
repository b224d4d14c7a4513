r"""Grid -> image transform with the imaging corrections.

Counterpart of :mod:`katsdpimager_tpu.ops.fourier` (the grid -> image
half).  ``grid_to_image`` inverse-transforms the centred grid,
unnormalised as the reference's cuFFT is, multiplies by the W correction
:math:`e^{2\pi i w(n-1)}`, keeps the real part, multiplies by
:math:`n = \sqrt{1 - l^2 - m^2}`, divides by the separable taper and
accumulates.  The fftshifts fold into :math:`(-1)^{x+y}` checkerboards on
both sides of the DFT (N even).

:func:`grid_to_image` is the plain formula and the composite plain
version of kernels K3 + K4; :func:`grid_to_image_parts` sends CUDA
tensors through the kernels (:mod:`.fused_fft`) and CPU tensors through
the plain formula.
"""

from __future__ import annotations

import math

import torch

from .fused_fft import checkerboard, grid_to_image_fused_parts, sqrt_rn


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
