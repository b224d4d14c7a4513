r"""Restoring-beam fitting and FFT convolution.

Counterpart of :mod:`katsdpimager_tpu.ops.beam` (which imports JAX, so the
port cannot import it).  :func:`fit_beam` fits a 2D elliptical Gaussian
to the PSF core on the host (numpy and scipy, moved across unchanged);
:func:`convolve_beam` convolves a model with the fitted beam by
multiplying its analytically known Fourier transform onto the model's
half-spectrum FFT.

The Gaussian :math:`e^{-\frac12\lVert M^{-1}x\rVert^2}` (``M`` the square
root of the covariance) transforms to
:math:`2\pi\lvert M\rvert e^{-2\pi^2\lVert Mk\rVert^2}`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.optimize
import torch


@dataclasses.dataclass
class Beam:
    """Gaussian synthesised beam: FWHM major/minor in pixels, position angle
    (radians, from +y toward +x of the PSF)."""

    major: float
    minor: float
    theta: float

    @property
    def sigma_major(self) -> float:
        return self.major / math.sqrt(8 * math.log(2))

    @property
    def sigma_minor(self) -> float:
        return self.minor / math.sqrt(8 * math.log(2))

    def covariance_sqrt(self) -> np.ndarray:
        c, s = math.cos(self.theta), math.sin(self.theta)
        Q = np.array([[c, -s], [s, c]])
        D = np.diag([self.sigma_major, self.sigma_minor])
        return Q @ D @ Q.T


def fit_beam(psf: np.ndarray, step: float = 1.0, threshold: float = 0.01,
             init_threshold: float = 0.5) -> Beam:
    """Fit a 2D Gaussian to the PSF core (reference beam.py:90-159).

    ``psf`` is 2D with the origin at the central pixel (rounded up).
    """
    def extract(data, thresh):
        mask = data > thresh
        ys, xs = np.nonzero(mask)
        y = (ys - data.shape[0] // 2) * step
        x = (xs - data.shape[1] // 2) * step
        return data[mask], y, x

    picked, iy, ix = extract(psf, init_threshold)
    total = np.sum(picked)
    cov = np.empty((2, 2))
    cov[0, 0] = np.sum(picked * iy ** 2) / total
    cov[0, 1] = np.sum(picked * iy * ix) / total
    cov[1, 0] = cov[0, 1]
    cov[1, 1] = np.sum(picked * ix ** 2) / total
    # Correct the truncation bias: a unit 2D Gaussian truncated at radius R
    # has variance 1 - (1 + R^2/2) exp(-R^2/2).
    R2 = -2 * np.log(init_threshold)
    cov /= 1 - (1 + 0.5 * R2) * np.exp(-0.5 * R2)

    picked, iy, ix = extract(psf, threshold)

    # Parametrise by the inverse covariance (a, b, c):
    # model = exp(-1/2 (a y^2 + 2 b x y + c x^2)).
    icov = np.linalg.inv(cov)
    p0 = np.array([icov[0, 0], icov[0, 1], icov[1, 1]])

    def residuals(p):
        a, b, c = p
        q = a * iy ** 2 + 2 * b * iy * ix + c * ix ** 2
        return np.exp(-0.5 * q) - picked

    sol = scipy.optimize.least_squares(residuals, p0, method="lm")
    a, b, c = sol.x
    icov_fit = np.array([[a, b], [b, c]])
    cov_fit = np.linalg.inv(icov_fit)
    # Eigen-decompose the covariance: eigenvalues are sigma^2 along the axes.
    evals, evecs = np.linalg.eigh(cov_fit)
    # eigh is ascending: evals[1] is the major axis.
    scale = math.sqrt(8 * math.log(2))
    major = math.sqrt(max(evals[1], 0.0)) * scale
    minor = math.sqrt(max(evals[0], 0.0)) * scale
    vec = evecs[:, 1]
    theta = math.atan2(vec[1], vec[0]) % math.pi
    return Beam(major=major, minor=minor, theta=theta)


def beam_area(beam: Beam) -> float:
    """Area under the unit-peak restoring beam in pixels:
    2 pi sigma_maj sigma_min (reference frontend.py:203-207)."""
    return 2 * math.pi * beam.major * beam.minor / (8 * math.log(2))


def convolve_gaussian(model, M):
    """Convolve a real (P, N, N) model with the unit-peak Gaussian of
    covariance square root ``M`` (2, 2, host array): the half-spectrum
    ``rfft2``/``irfft2`` pair of a real image, with the beam's transform
    (amplitude ``2 pi |det M|``, taken on the host) evaluated on the
    frequency grid.  Wraps at edges."""
    pixels = model.shape[-1]
    dev = model.device
    M = np.asarray(M, dtype=np.float64)
    amplitude = float(np.float32(2 * np.pi * abs(np.linalg.det(M))))
    # M rounded to f32 whatever the model's dtype, as the JAX package does
    M = torch.as_tensor(M.astype(np.float32), device=dev).to(model.dtype)
    model_ft = torch.fft.rfft2(model)
    u = torch.fft.fftfreq(pixels, device=dev, dtype=model.dtype)    # axis -2
    v = torch.fft.rfftfreq(pixels, device=dev, dtype=model.dtype)   # axis -1
    coords = torch.stack(torch.meshgrid(u, v, indexing="ij"), dim=-1)
    rotated = coords @ M.T
    r2 = (rotated * rotated).sum(-1)
    beam_ft = amplitude * torch.exp(-2.0 * math.pi ** 2 * r2)
    out = torch.fft.irfft2(model_ft * beam_ft[None], s=(pixels, pixels))
    return out.to(model.dtype)


def convolve_beam(model, beam: Beam):
    """Convolve a (P, N, N) model image with the restoring beam via FFT
    (reference beam.py:171-202).  Wraps at edges by design."""
    return convolve_gaussian(model, beam.covariance_sqrt())
