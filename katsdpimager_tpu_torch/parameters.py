"""Imaging parameter derivation (sizing equations).

Physics equivalent to the reference's ``parameters.py`` (SKA-TEL-SDP-0000003
formulae), expressed with plain-float SI conventions (:mod:`.units`):
lengths in metres, angles in radians, frequencies in Hz, l/m dimensionless.

All parameter objects here are immutable and hashable so they can be used as
static arguments to jitted functions.

The port's own copy of :mod:`katsdpimager_tpu.parameters` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from . import units


def is_smooth(x: int) -> bool:
    """Whether x is an efficient FFT size: a multiple of 8 whose prime
    factors are all in {2, 3, 5, 7} (reference parameters.py:17-25)."""
    if x % 8 != 0:
        return False
    for d in (2, 3, 5, 7):
        while x % d == 0:
            x //= d
    return x == 1


def next_smooth(x: int) -> int:
    while not is_smooth(x):
        x += 1
    return x


@dataclasses.dataclass(frozen=True)
class ArrayParameters:
    """Physical attributes of an interferometric array (lengths in metres)."""

    antenna_diameter: float
    longest_baseline: float


@dataclasses.dataclass(frozen=True)
class FixedImageParameters:
    """Frequency-independent image properties.

    ``polarizations`` is a tuple of CASA Stokes enums; ``precision`` is
    ``'single'`` or ``'double'``.
    """

    polarizations: Tuple[int, ...]
    precision: str = "single"

    @property
    def real_dtype(self):
        return np.float32 if self.precision == "single" else np.float64

    @property
    def complex_dtype(self):
        return np.complex64 if self.precision == "single" else np.complex128

    @property
    def num_polarizations(self) -> int:
        return len(self.polarizations)


@dataclasses.dataclass(frozen=True)
class ImageParameters:
    """Physical properties of a single-frequency image.

    Use :func:`make_image_parameters` to derive ``pixel_size``/``pixels``
    from array geometry the same way the reference does
    (parameters.py:79-115).

    Attributes
    ----------
    fixed : FixedImageParameters
    wavelength : float, metres
    pixel_size : float, dimensionless (l/m size of one pixel)
    pixels : int, image width/height
    """

    fixed: FixedImageParameters
    wavelength: float
    pixel_size: float
    pixels: int

    @property
    def image_size(self) -> float:
        """Dimensionless l/m extent of the image."""
        return self.pixel_size * self.pixels

    @property
    def cell_size(self) -> float:
        """UV cell size in metres."""
        return self.wavelength / self.image_size

    def __str__(self):
        from . import polarization

        return (
            f"Pixel size: {units.rad_to_arcsec(math.asin(self.pixel_size)):.3f} arcsec\n"
            f"Pixels: {self.pixels}\n"
            f"FOV: {units.rad_to_deg(math.asin(self.image_size)):.3f} deg\n"
            f"Cell size: {self.cell_size:.3f} m\n"
            f"Wavelength: {self.wavelength:.3f} m\n"
            f"Polarizations: "
            + ",".join(polarization.STOKES_NAMES[i] for i in self.fixed.polarizations)
            + "\n"
            f"Precision: {32 if self.fixed.precision == 'single' else 64} bit\n"
        )


def make_image_parameters(
    fixed: FixedImageParameters,
    q_fov: float,
    image_oversample: float,
    frequency_hz: float,
    array: Optional[ArrayParameters],
    pixel_size: Optional[float] = None,
    pixels: Optional[int] = None,
) -> ImageParameters:
    """Derive image pixel size and count.

    - pixel size: wavelength over a UV plane of size (2/3 * oversample) *
      longest_baseline (reference parameters.py:84-90);
    - pixel count: FOV out to the first Airy null of the primary beam scaled
      by ``q_fov``, rounded up to an FFT-smooth size (parameters.py:98-111).

    ``pixel_size``, if given, is dimensionless (already ``sin(angle)``).
    """
    wavelength = units.wavelength_m(frequency_hz)
    if pixel_size is None:
        if image_oversample < 3.0:
            raise ValueError(
                "image_oversample is too small to capture all visibilities in the UV plane"
            )
        uv_size = (2.0 / 3.0 * image_oversample) * array.longest_baseline
        pixel_size = wavelength / uv_size
    if pixels is None:
        cell_size = array.antenna_diameter * (math.pi / (7.6634 * q_fov))
        image_size = wavelength / cell_size
        pixels = int(0.98 * image_size / pixel_size)
        pixels = next_smooth(pixels)
    else:
        if not is_smooth(pixels):
            raise ValueError(
                f"Image size {pixels} not supported - try {next_smooth(pixels)}"
            )
    assert pixels % 2 == 0
    return ImageParameters(fixed=fixed, wavelength=wavelength,
                           pixel_size=float(pixel_size), pixels=int(pixels))


def w_kernel_width(image_parameters: ImageParameters, w_m: float, eps_w: float,
                   antialias_width: float = 0.0) -> float:
    """Width in UV cells of a W kernel truncated at fraction ``eps_w`` of
    peak; Eq 9 of SKA-TEL-SDP-0000003 (reference parameters.py:135-158).
    ``w_m`` is in metres; combined with the anti-alias width in quadrature.
    """
    fov = image_parameters.image_size
    wl = w_m / image_parameters.wavelength
    wk2 = 4 * fov ** 2 * (
        (wl * fov / 2) ** 2 + wl ** 1.5 * fov / (2 * math.pi * eps_w)
    )
    return math.sqrt(wk2 + antialias_width ** 2)


def w_slices(image_parameters: ImageParameters, max_w_m: float, eps_w: float,
             kernel_width: float, antialias_width: float = 0.0) -> int:
    """Number of W-stacking slices so the per-slice residual W kernel fits in
    ``kernel_width`` cells (binary search; reference parameters.py:161-183).

    The first slice is half-width (centred at w=0), so the largest residual
    w for ``S`` slices is ``max_w / (2S - 1)``.
    """
    lo, hi = 0, 1
    half_max_w = max_w_m * 0.5

    def measure(slices: int) -> float:
        return w_kernel_width(
            image_parameters, half_max_w / (slices - 0.5), eps_w, antialias_width
        )

    # Even at w -> 0 the kernel cannot shrink below the anti-alias width;
    # guard the search or it doubles `hi` forever.
    if w_kernel_width(image_parameters, 0.0, eps_w,
                      antialias_width) > kernel_width:
        raise ValueError(
            f"kernel_width {kernel_width} is too small for the "
            f"anti-alias kernel (width {antialias_width}); increase "
            f"--kernel-width or reduce --aa-width")
    while measure(hi) > kernel_width:
        hi *= 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if measure(mid) < kernel_width:
            hi = mid
        else:
            lo = mid
    return hi


@dataclasses.dataclass(frozen=True)
class WeightParameters:
    """Imaging-weight scheme. ``weight_type`` is a :class:`.ops.weights.WeightType`."""

    weight_type: "object"
    robustness: float = 0.0

    def __str__(self):
        from .ops.weights import WeightType

        if self.weight_type == WeightType.ROBUST:
            ans = f"robust ({self.robustness:.3f})"
        else:
            ans = self.weight_type.name.lower()
        return "Image weights: " + ans


@dataclasses.dataclass(frozen=True)
class FixedGridParameters:
    """Frequency-independent gridding parameters.

    ``max_w`` is in metres. ``degrid`` selects degridding-based prediction
    for the major cycle instead of the direct DFT.
    """

    antialias_width: float
    oversample: int
    image_oversample: int
    max_w: float
    kernel_width: int
    degrid: bool = False
    beams: Optional[object] = None

    def __hash__(self):
        return hash((self.antialias_width, self.oversample, self.image_oversample,
                     self.max_w, self.kernel_width, self.degrid, id(self.beams)))


@dataclasses.dataclass(frozen=True)
class GridParameters:
    """Per-channel gridding parameters: W-stacking slice count and number of
    W-projection planes per slice."""

    fixed: FixedGridParameters
    w_slices: int
    w_planes: int

    def __str__(self):
        prediction = "degridding" if self.fixed.degrid else "direct"
        beam_correction = "yes" if self.fixed.beams else "no"
        return (
            f"Grid oversampling: {self.fixed.oversample}\n"
            f"Image oversample: {self.fixed.image_oversample}\n"
            f"W slices: {self.w_slices}\n"
            f"W planes per slice: {self.w_planes}\n"
            f"Maximum W: {self.fixed.max_w:.3f} m\n"
            f"Antialiasing support: {self.fixed.antialias_width} cells\n"
            f"Kernel support: {self.fixed.kernel_width} cells\n"
            f"Prediction: {prediction}\n"
            f"Primary beam correction: {beam_correction}"
        )


@dataclasses.dataclass(frozen=True)
class CleanParameters:
    """Cotton-Schwab CLEAN controls (reference parameters.py:274-298)."""

    minor: int
    loop_gain: float
    major_gain: float
    threshold: float
    mode: int
    psf_cutoff: float
    psf_limit: float
    border: float

    def __post_init__(self):
        if self.psf_cutoff >= 1.0:
            raise ValueError("PSF cutoff must be less than 1")

    def __str__(self):
        from .ops.clean import CLEAN_I

        mode = "I" if self.mode == CLEAN_I else "I^2+Q^2+U^2+V^2"
        return (
            f"Loop gain: {self.loop_gain}\n"
            f"Major cycle gain: {self.major_gain}\n"
            f"Threshold: {self.threshold} sigma\n"
            f"Max minor cycles: {self.minor}\n"
            f"PSF cutoff: {self.psf_cutoff}\n"
            f"PSF limit: {self.psf_limit * 100}%\n"
            f"Peak function: {mode}\n"
            f"Border: {self.border * 100}%"
        )
