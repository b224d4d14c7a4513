"""Primary beam models: radially symmetric, frequency-interpolated power
beams (parity with reference ``primary_beam.py`` which samples
katsdpmodels-format HDF5 beams).

Two sources are supported:

- :class:`TrivialPrimaryBeam` backed by samples loaded from a
  katsdpmodels-style HDF5 file (``frequency`` (F,), ``beam`` (F, R) power
  samples at radius step ``beam_step_deg``) or from its ``.npz`` copy
  (the bundled MeerKAT tables);
- :func:`airy_beam`, an analytic unblocked-aperture Airy power pattern used
  when no measured model is available (the reference derives its FOV
  heuristic from the same Airy null).

The port's own copy of :mod:`katsdpimager_tpu.primary_beam` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from . import units


class TrivialPrimaryBeam:
    """Radially symmetric power beam sampled on a radius grid per frequency.

    ``radii`` are in units of (l, m) direction cosines; ``power`` is
    (F, R); frequencies in Hz.
    """

    def __init__(self, frequencies: np.ndarray, radii: np.ndarray,
                 power: np.ndarray, band: Optional[str] = None):
        self.frequencies = np.asarray(frequencies, np.float64)
        self.radii = np.asarray(radii, np.float64)
        self.power = np.asarray(power, np.float64)
        self.band = band

    def sample(self, radius, frequency_hz: float) -> np.ndarray:
        """Interpolate the beam power at direction-cosine radius values."""
        fi = np.interp(frequency_hz, self.frequencies,
                       np.arange(len(self.frequencies)))
        lo = int(np.floor(fi))
        hi = min(lo + 1, len(self.frequencies) - 1)
        frac = fi - lo
        row = (1 - frac) * self.power[lo] + frac * self.power[hi]
        return np.interp(np.abs(radius), self.radii, row, right=0.0)

    def sample_grid(self, x, y, frequency_hz: float) -> np.ndarray:
        """Sample on a grid of direction cosines (x: l, y: m)."""
        r = np.sqrt(np.asarray(x)[None, :] ** 2 + np.asarray(y)[:, None] ** 2)
        return self.sample(r, frequency_hz)


def airy_beam(diameter_m: float, band: Optional[str] = None,
              freq_range=(0.5e9, 2.0e9), num_freqs: int = 16,
              num_radii: int = 2048) -> TrivialPrimaryBeam:
    """Analytic Airy-disk power beam for an unblocked circular aperture of
    the given diameter: power = (2 J1(x)/x)^2 with
    x = pi D sin(theta) / lambda."""
    from scipy.special import j1

    freqs = np.linspace(freq_range[0], freq_range[1], num_freqs)
    power = np.empty((num_freqs, num_radii))
    # Radius grid out to well past the first null at any frequency
    max_radius = 3.8317 / math.pi * units.C_M_PER_S / (freqs[0] * diameter_m) * 3
    radii = np.linspace(0, max_radius, num_radii)
    for i, f in enumerate(freqs):
        wavelength = units.C_M_PER_S / f
        x = math.pi * diameter_m * radii / wavelength
        with np.errstate(divide="ignore", invalid="ignore"):
            amp = np.where(x == 0, 1.0, 2 * j1(x) / np.where(x == 0, 1.0, x))
        power[i] = amp ** 2
    return TrivialPrimaryBeam(freqs, radii, power, band)


def _read_hdf5_beam(filename: str):
    """(frequency, beam, radius) arrays of a katsdpmodels-style HDF5
    beam (needs h5py)."""
    import h5py

    with h5py.File(filename, "r") as f:
        freqs = np.asarray(f["frequency"])
        beam = np.asarray(f["beam"])
        step = f.attrs.get("beam_step_deg")
        if step is None:
            radii = np.asarray(f["radius"])
        else:
            radii = np.sin(np.deg2rad(np.arange(beam.shape[1]) * float(step)))
    return freqs, beam, radii


def load_hdf5_beam(filename: str, band: Optional[str] = None) -> TrivialPrimaryBeam:
    """Load a radially-symmetric beam from a katsdpmodels-style HDF5 file."""
    freqs, beam, radii = _read_hdf5_beam(filename)
    return TrivialPrimaryBeam(freqs, radii, beam ** 2 if beam.ndim == 2 else beam,
                              band)


def hdf5_to_npz(src: str, dst: str) -> None:
    """Write the ``frequency``, ``beam`` (voltage) and ``radius`` arrays
    of a katsdpmodels-style HDF5 beam to the ``.npz`` that
    :func:`load_npz_beam` reads.  The bundled MeerKAT tables are this
    function applied to the JAX package's
    ``models/beams/meerkat/v1/beam_{L,UHF}.h5``."""
    freqs, beam, radii = _read_hdf5_beam(src)
    np.savez(dst, frequency=freqs, beam=beam, radius=radii)


def load_npz_beam(filename: str, band: Optional[str] = None) -> TrivialPrimaryBeam:
    """Load a radially-symmetric beam from the ``.npz`` that
    :func:`hdf5_to_npz` writes: numpy only, no h5py."""
    with np.load(filename) as f:
        freqs, beam, radii = f["frequency"], f["beam"], f["radius"]
    return TrivialPrimaryBeam(freqs, radii, beam ** 2 if beam.ndim == 2 else beam,
                              band)


def meerkat_v1_beam(band: str) -> TrivialPrimaryBeam:
    """MeerKAT measured primary beam (parity with reference
    ``primary_beam.py:179-188``, which samples the katsdpmodels v1 HDF5
    tables).  This build bundles the measured tables downsampled in
    frequency as ``.npz`` (``models/beams/meerkat/v1``, made by
    :func:`hdf5_to_npz`), so reading them needs no h5py.  If a table is
    missing the analytic Airy pattern for a 13.5 m dish stands in."""
    ranges = {"L": (856e6, 1712e6), "UHF": (544e6, 1088e6)}
    if band not in ranges:
        raise ValueError(f"No primary beam model for band {band!r}")
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "models", "beams", "meerkat", "v1",
                        f"beam_{band}.npz")
    if os.path.exists(path):
        return load_npz_beam(path, band)
    return airy_beam(13.5, band, ranges[band])
