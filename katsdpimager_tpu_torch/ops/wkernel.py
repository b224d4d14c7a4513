r"""Combined anti-aliasing + W-projection convolution kernels.

Math parity with the reference's ``grid.py:136-423`` (Kaiser-Bessel window,
its continuous Fourier transform, the separable small-angle W term and the
image-space taper), but generated as plain arrays for upload once per
channel — there is no Mako/CUDA templating step to mirror.

Sampling/indexing conventions (shared with :mod:`..preprocess` and the
gridders):

- A kernel has support ``width`` UV cells and is tabulated at ``oversample``
  subpixel positions.  For a continuous (cell-unit) coordinate ``x``,
  ``xs = floor(x * oversample)``, ``pixel = xs // oversample``,
  ``subpixel = xs % oversample`` (reference grid.py:337-341).
- Tabulated values are at half-subpixel offsets (the centres of subpixel
  bins), implemented as a :math:`-\tfrac{1}{2}\text{cell}/\text{oversample}`
  shift in UV space (reference grid.py:258-261,314).
- The W term uses the separable small-angle approximation
  :math:`\sqrt{1-l^2-m^2}-1 \approx -\tfrac12(l^2+m^2)-\tfrac{5}{24}(l^4+m^4)`
  (reference grid.py:239-248).

One deliberate deviation: the per-plane kernel w values are spaced by
``max_w / ((w_slices - 0.5) * w_planes)`` — exactly the residual-w of the
quantisation in :mod:`..preprocess` — where the reference uses
``max_w / (w_slices * w_planes)`` (grid.py:369-383), a slight mismatch with
its own quantiser.

The port's own copy of :mod:`katsdpimager_tpu.ops.wkernel` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np


def kaiser_bessel(x, width: float, beta: float):
    r"""Kaiser-Bessel window with support :math:`[-W/2, W/2]`."""
    x = np.asarray(x)
    param = 1 - (2 * x / width) ** 2
    # Clamp the sqrt argument; out-of-support values are zeroed below.
    values = np.i0(beta * np.sqrt(np.maximum(0.0, param))) / np.i0(beta)
    return np.where(param >= 0, values, 0.0)


def kaiser_bessel_fourier(f, width: float, beta: float):
    r"""Continuous Fourier transform of :func:`kaiser_bessel` (even + real,
    so also its own inverse transform)."""
    f = np.asarray(f, np.float64)
    alpha = beta / math.pi
    arg = (width * f) ** 2 - alpha * alpha
    # sinc of a purely imaginary argument is sinh-like; evaluate via complex
    # sqrt so negative arguments are handled without NaNs.
    root = np.sqrt(arg.astype(np.complex128))
    return width / np.i0(beta) * np.real(np.sinc(root))


def default_beta(width: float) -> float:
    """Shape parameter placing the first taper null just outside the image
    (the 1.2 factor trades a little edge aliasing for numerical stability;
    reference grid.py:216-222,374-378)."""
    return 1.2 * math.pi * math.sqrt(0.25 * width ** 2 - 1.0)


def antialias_kernel(width: float, oversample: int, beta: float | None = None):
    """1D anti-aliasing kernel, shape (oversample, size) complex64.

    First axis is the subpixel position, second the pixel position; see
    module docstring for the indexing convention.
    """
    if beta is None:
        beta = default_beta(width)
    half = int(math.ceil(0.5 * width))
    # Tap t (0-based) updates the grid cell at offset t - half + 1 from the
    # visibility's integer cell; subpixel bin s places the visibility at
    # (s + 0.5)/oversample past that cell.  The window is evaluated at the
    # tap-minus-visibility separation.
    tap_offsets = np.arange(1 - half, half + 1, dtype=np.float64)
    bin_centres = (np.arange(oversample) + 0.5) / oversample
    values = kaiser_bessel(tap_offsets[None, :] - bin_centres[:, None],
                           width, beta)
    return values.astype(np.complex64)


def antialias_w_kernel(
    cell_wavelengths: float,
    w: np.ndarray,
    width: int,
    oversample: int,
    antialias_width: float,
    image_oversample: int,
    beta: float,
):
    r"""Combined anti-aliasing + W kernel, shape (len(w), oversample, width).

    The continuous UV-space kernel is the Fourier transform of a closed-form
    image-plane product (KB taper transform x separable W curvature phase),
    so it is tabulated by sampling that product and DFT-ing: a dense DFT of
    length ``taps * image_oversample`` approximates the continuous
    transform, and the ``taps = width * oversample`` values the gridder
    needs are gathered straight out of the DFT-ordered spectrum.  Behaviour
    matches reference ``grid.py:235-334``; ``w`` is in wavelengths.
    """
    w = np.asarray(w, np.float64)
    taps = oversample * width
    assert taps % 2 == 0, "odd kernel tabulations not supported"
    # DFT length: image_oversample pads the image-plane sampling so the
    # implied UV period is image_oversample x wider than the kept band,
    # pushing wrap-around aliases out of the tabulated kernel.
    fine = taps * image_oversample
    du = cell_wavelengths / oversample  # UV distance between adjacent taps

    # Image-plane sample coordinates, generated directly in DFT ordering
    # (fftfreq yields m/fine for integer m in [-fine/2, fine/2)); the image
    # extent is the reciprocal of the tap spacing.
    l = np.fft.fftfreq(fine) / du

    # Closed-form image-plane factor: the KB window's continuous transform
    # (argument in cell units), one separable axis of the small-angle W
    # curvature sqrt(1-l^2-m^2)-1 ~ -(l^2+m^2)/2 - 5(l^4+m^4)/24, and a
    # -du/2 linear phase so the tabulated taps land on subpixel-bin CENTRES
    # rather than edges.
    envelope = cell_wavelengths * kaiser_bessel_fourier(
        l * cell_wavelengths, antialias_width, beta)
    curvature = 0.5 * (l * l) + (5.0 / 24.0) * (l * l) * (l * l)
    angle = 2.0 * np.pi * (np.outer(w, curvature) - (0.5 * du) * l)
    # The 1/(fine*du) factor turns the DFT sum into the continuous-transform
    # integral (image-plane sample spacing).
    spectrum = np.fft.fft(envelope * np.exp(1j * angle), axis=-1) / (fine * du)

    # kernel[..., s, t] is the continuous kernel at UV offset
    # (t*oversample + oversample-1-s) - taps/2 tap steps from DC: the
    # subpixel axis encodes the VISIBILITY's bin, so it runs opposite to
    # the tap tabulation order.
    sub = np.arange(oversample)
    tap = np.arange(width)
    offsets = (tap[None, :] * oversample
               + (oversample - 1 - sub)[:, None] - taps // 2)
    return np.ascontiguousarray(spectrum[..., offsets % fine])


def plane_w_values(image_parameters, grid_parameters) -> np.ndarray:
    """Residual w (in wavelengths) of each W plane relative to its slice's
    mid-w, consistent with the quantiser in :mod:`..preprocess`.

    Global plane ``p = s * w_planes + q`` covers scaled w in ``[p, p+1)``
    where ``scaled = w * w_scale + w_planes / 2`` and
    ``w_scale = (w_slices - 0.5) * w_planes / max_w``; its centre is at
    residual ``(q + 0.5 - w_planes/2) / w_scale`` from the slice mid-w.
    """
    gp = grid_parameters
    w_scale = (gp.w_slices - 0.5) * gp.w_planes / gp.fixed.max_w  # 1/m
    step_wl = 1.0 / (w_scale * image_parameters.wavelength)
    q = np.arange(gp.w_planes)
    return (q + 0.5 - 0.5 * gp.w_planes) * step_wl


def make_convolution_kernel(image_parameters, grid_parameters) -> np.ndarray:
    """Tabulate the full kernel stack for one channel:
    shape (w_planes, oversample, kernel_width), in the image's complex
    dtype (tabulation is internally double precision)."""
    gp = grid_parameters
    ip = image_parameters
    cell_wavelengths = ip.cell_size / ip.wavelength
    beta = default_beta(gp.fixed.antialias_width)
    ws = plane_w_values(ip, gp)
    kern = antialias_w_kernel(
        cell_wavelengths,
        ws,
        gp.fixed.kernel_width,
        gp.fixed.oversample,
        gp.fixed.antialias_width,
        gp.fixed.image_oversample,
        beta,
    )
    return kern.astype(ip.fixed.complex_dtype)


def taper(N: int, antialias_width: float, oversample: int,
          beta: float | None = None) -> np.ndarray:
    """Image-space taper of the anti-aliasing kernel for an N-pixel image,
    including the sinc correction for piecewise-constant (subpixel-sampled)
    kernel application (reference grid.py:404-423)."""
    if beta is None:
        beta = default_beta(antialias_width)
    x = np.arange(N) / N - 0.5
    out = kaiser_bessel_fourier(x, antialias_width, beta)
    out = out * np.sinc(x / oversample)
    return out.astype(np.float64)


def mid_w_values(image_parameters, grid_parameters) -> np.ndarray:
    """Mid-w (in wavelengths) of each W-stacking slice, applied as the
    per-slice phase correction at FFT time (reference frontend.py:509-510)."""
    gp = grid_parameters
    slice_w_step = gp.fixed.max_w / image_parameters.wavelength / (gp.w_slices - 0.5)
    return np.arange(gp.w_slices) * slice_w_step
