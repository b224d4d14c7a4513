r"""Grid <-> image transforms with the imaging corrections, and image ops.

Counterpart of :mod:`katsdpimager_tpu.ops.fourier`.  ``grid_to_image``
inverse-transforms the centred grid, unnormalised as the reference's
cuFFT is, multiplies by the W correction :math:`e^{2\pi i w(n-1)}`, keeps
the real part, multiplies by :math:`n = \sqrt{1 - l^2 - m^2}`, divides by
the separable taper and accumulates.  ``image_to_grid`` is its forward
counterpart for degridding: it divides by the taper and by ``n`` and
applies the conjugate W phase before a forward DFT.  The fftshifts fold
into :math:`(-1)^{x+y}` checkerboards on both sides of the DFT (N even).

Routing, by the rule of the JAX package's ``_use_pallas_fft``
(:func:`use_fused_fft`): CUDA tensors in float32 at a power-of-two N that
the kernels take go through kernels K3 + K4 (grid -> image) and K6 + K7
(image -> grid) in :mod:`.fused_fft`; everything else goes through the
plain formulas below (``torch.fft``), the counterpart of the JAX
package's XLA branch.  On CUDA that other route is taken by the rule,
never by catching a kernel's failure, and is logged once per size.
:func:`grid_to_image` and :func:`image_to_grid` take a complex grid,
:func:`grid_to_image_parts` and :func:`image_to_grid_parts` f32 re/im
planes.
"""

from __future__ import annotations

import logging
import math

import torch

from .fused_fft import (checkerboard, grid_to_image_fused_parts,
                        image_to_grid_fused_parts, kernel_size_ok, sqrt_rn)

logger = logging.getLogger(__name__)

_logged_sizes: set = set()


def use_fused_fft(pixels: int, device, *dtypes) -> bool:
    """Whether the grid <-> image transforms of an (N, N) image on
    ``device`` go through the column-DFT kernels: CUDA, every dtype
    float32 or complex64, and an N the kernels take (a power of two in
    [256, 8192]).  The counterpart of ``fourier._use_pallas_fft``, whose
    XLA branch takes the other sizes (``parameters.next_smooth`` gives
    2^a 3^b 5^c 7^d sizes such as 3024).  A CUDA image that takes the
    ``torch.fft`` route is logged once per size."""
    if torch.device(device).type != "cuda":
        return False
    f32 = all(d in (torch.float32, torch.complex64) for d in dtypes)
    if f32 and kernel_size_ok(pixels):
        return True
    if pixels not in _logged_sizes:
        _logged_sizes.add(pixels)
        logger.info("%d px image: grid <-> image transforms take the "
                    "torch.fft route (the column-DFT kernels take float32 "
                    "at power-of-two sizes in [256, 8192])", pixels)
    return False


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
    """Accumulate the W-corrected layer of the centred (P, N, N) complex
    ``grid`` into the real ``image``; returns the sum.  Routed by
    :func:`use_fused_fft`; the plain formula is
    :func:`grid_to_image_plain`."""
    if use_fused_fft(image.shape[-1], image.device, image.dtype,
                     grid.dtype):
        return grid_to_image_parts(grid.real.contiguous(),
                                   grid.imag.contiguous(), image, kernel1d,
                                   w, pixel_size)
    return grid_to_image_plain(grid, image, kernel1d, w, pixel_size)


def grid_to_image_plain(grid, image, kernel1d, w, pixel_size):
    """Plain formula of :func:`grid_to_image` (``torch.fft``)."""
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

    Where :func:`use_fused_fft` holds, kernels K3 and K4 run on the
    transposed image; elsewhere the plain formula.  Returns the new
    image."""
    if not use_fused_fft(image.shape[-1], gr.device, image.dtype, gr.dtype):
        return grid_to_image_plain(torch.complex(gr, gi), image, kernel1d, w,
                                   pixel_size)
    imageT = image.transpose(-1, -2).contiguous()
    grid_to_image_fused_parts(gr, gi, imageT, kernel1d, w, pixel_size)
    return imageT.transpose(-1, -2).contiguous()


def image_to_grid(image, kernel1d, w, pixel_size):
    """The (P, N, N) complex centred grid whose :func:`grid_to_image` is
    ``image``.  Routed by :func:`use_fused_fft`; the plain formula is
    :func:`image_to_grid_plain`."""
    if use_fused_fft(image.shape[-1], image.device, image.dtype):
        gr, gi = image_to_grid_parts(image, kernel1d, w, pixel_size)
        return torch.complex(gr, gi)
    return image_to_grid_plain(image, kernel1d, w, pixel_size)


def image_to_grid_plain(image, kernel1d, w, pixel_size):
    """Plain formula of :func:`image_to_grid` (``torch.fft``): the forward
    DFT of the corrected layer ``image * cb / (taper^2 n) *
    e^{-2 pi i w (n - 1)}``."""
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


def image_to_grid_parts(image, kernel1d, w, pixel_size):
    """:func:`image_to_grid` returning the grid as (P, N, N) f32 re/im
    planes (the fused degridder's input layout).

    Where :func:`use_fused_fft` holds, kernels K6 and K7 run on the
    transposed image; elsewhere the plain formula."""
    if not use_fused_fft(image.shape[-1], image.device, image.dtype):
        g = image_to_grid_plain(image, kernel1d, w, pixel_size)
        return (g.real.to(torch.float32).contiguous(),
                g.imag.to(torch.float32).contiguous())
    imageT = image.transpose(-1, -2).contiguous()
    return image_to_grid_fused_parts(imageT, kernel1d, w, pixel_size)


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
