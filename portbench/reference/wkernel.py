r"""Anti-aliasing + W-projection kernel tables and the image taper.

A frozen copy of the arithmetic of ``katsdpimager_tpu_torch.ops.wkernel``
(itself katsdpimager's ``grid.py:136-423``: a Kaiser-Bessel window, its
continuous Fourier transform, the separable small-angle W term and the
image-space taper), taking plain numbers instead of the program's
parameter objects and kept in float64 throughout.  The reference works
the tables out again with it: it takes nothing the program made.

Conventions: a kernel has support ``width`` UV cells tabulated at
``oversample`` sub-cell positions; ``kernel[w, s, t]`` is tap ``t`` of a
visibility in sub-cell bin ``s`` on W plane ``w``.
"""

from __future__ import annotations

import math

import numpy as np


def kaiser_bessel(x, width: float, beta: float):
    """Kaiser-Bessel window with support [-width/2, width/2]."""
    x = np.asarray(x)
    param = 1 - (2 * x / width) ** 2
    values = np.i0(beta * np.sqrt(np.maximum(0.0, param))) / np.i0(beta)
    return np.where(param >= 0, values, 0.0)


def kaiser_bessel_fourier(f, width: float, beta: float):
    """Continuous Fourier transform of :func:`kaiser_bessel`."""
    f = np.asarray(f, np.float64)
    alpha = beta / math.pi
    arg = (width * f) ** 2 - alpha * alpha
    root = np.sqrt(arg.astype(np.complex128))
    return width / np.i0(beta) * np.real(np.sinc(root))


def default_beta(width: float) -> float:
    """The window's shape parameter (first taper null just outside the
    image)."""
    return 1.2 * math.pi * math.sqrt(0.25 * width ** 2 - 1.0)


def antialias_w_kernel(cell_wavelengths: float, w, width: int,
                       oversample: int, antialias_width: float,
                       image_oversample: int, beta: float) -> np.ndarray:
    """(len(w), oversample, width) complex128: the transform of the
    image-plane product of the window's transform and one separable axis
    of the W curvature, sampled on a grid ``image_oversample`` times finer
    than the taps need; ``w`` in wavelengths."""
    w = np.asarray(w, np.float64)
    taps = oversample * width
    fine = taps * image_oversample
    du = cell_wavelengths / oversample
    lm = np.fft.fftfreq(fine) / du
    envelope = cell_wavelengths * kaiser_bessel_fourier(
        lm * cell_wavelengths, antialias_width, beta)
    curvature = 0.5 * (lm * lm) + (5.0 / 24.0) * (lm * lm) * (lm * lm)
    angle = 2.0 * np.pi * (np.outer(w, curvature) - (0.5 * du) * lm)
    spectrum = np.fft.fft(envelope * np.exp(1j * angle), axis=-1) / (
        fine * du)
    sub = np.arange(oversample)
    tap = np.arange(width)
    offsets = (tap[None, :] * oversample
               + (oversample - 1 - sub)[:, None] - taps // 2)
    return np.ascontiguousarray(spectrum[..., offsets % fine])


def plane_w_values(wavelength: float, *, w_slices: int, w_planes: int,
                   max_w: float) -> np.ndarray:
    """Residual w (wavelengths) of each W plane from its slice's mid-w."""
    w_scale = (w_slices - 0.5) * w_planes / max_w
    step_wl = 1.0 / (w_scale * wavelength)
    q = np.arange(w_planes)
    return (q + 0.5 - 0.5 * w_planes) * step_wl


def mid_w_values(wavelength: float, *, w_slices: int,
                 max_w: float) -> np.ndarray:
    """Mid-w (wavelengths) of each W slice."""
    return np.arange(w_slices) * (max_w / wavelength / (w_slices - 0.5))


def convolution_kernel(wavelength: float, *, pixels: int, pixel_size: float,
                       w_slices: int, w_planes: int, max_w: float,
                       kernel_width: int, oversample: int,
                       antialias_width: float,
                       image_oversample: int) -> np.ndarray:
    """One channel's (w_planes, oversample, kernel_width) complex128
    kernel stack."""
    cell_wavelengths = 1.0 / (pixel_size * pixels)
    ws = plane_w_values(wavelength, w_slices=w_slices, w_planes=w_planes,
                        max_w=max_w)
    return antialias_w_kernel(cell_wavelengths, ws, kernel_width, oversample,
                              antialias_width, image_oversample,
                              default_beta(antialias_width))


def taper(pixels: int, antialias_width: float, oversample: int) -> np.ndarray:
    """(pixels,) float64 image-space taper of the kernel, with the sinc of
    its sub-cell sampling."""
    beta = default_beta(antialias_width)
    x = np.arange(pixels) / pixels - 0.5
    return (kaiser_bessel_fourier(x, antialias_width, beta)
            * np.sinc(x / oversample))
