"""Minimal physical-unit helpers.

The reference uses astropy.units Quantities throughout (e.g.
``parameters.py``, ``frontend.py:293``).  astropy is not a dependency of this
framework; instead we fix internal conventions and provide parsing helpers for
the command-line surface:

- lengths are metres (float)
- angles are radians (float)
- frequencies are Hz (float)
- direction cosines (l, m) and pixel sizes are dimensionless floats
  (``sin(angle)``, matching reference ``parameters.py:94-96``)

The port's own copy of :mod:`katsdpimager_tpu.units` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import re

#: Speed of light [m/s] (CODATA; same constant astropy uses)
C_M_PER_S = 299792458.0

#: Multipliers to radians for angle suffixes
_ANGLE_UNITS = {
    "rad": 1.0,
    "deg": math.pi / 180.0,
    "arcmin": math.pi / 180.0 / 60.0,
    "arcsec": math.pi / 180.0 / 3600.0,
    "mas": math.pi / 180.0 / 3600.0e3,
}

#: Multipliers to metres for length suffixes
_LENGTH_UNITS = {
    "m": 1.0,
    "cm": 1e-2,
    "mm": 1e-3,
    "km": 1e3,
}

#: Multipliers to Hz
_FREQ_UNITS = {
    "Hz": 1.0,
    "kHz": 1e3,
    "MHz": 1e6,
    "GHz": 1e9,
}

_QUANTITY_RE = re.compile(r"^\s*([-+0-9.eE]+)\s*([A-Za-z]*)\s*$")


class Quantity:
    """A tiny typed value: a float plus a physical type tag.

    ``physical_type`` is one of ``'angle'``, ``'length'``, ``'frequency'`` or
    ``'dimensionless'``; ``value`` is in the canonical unit for that type
    (rad / m / Hz / unitless).
    """

    __slots__ = ("value", "physical_type")

    def __init__(self, value: float, physical_type: str = "dimensionless"):
        self.value = float(value)
        self.physical_type = physical_type

    def __repr__(self):
        return f"Quantity({self.value!r}, {self.physical_type!r})"

    def __float__(self):
        return self.value


def parse_quantity(text) -> Quantity:
    """Parse strings like ``18arcsec``, ``0.5deg``, ``12.3m``, ``1.4GHz``, ``1.0``.

    Mirrors the subset of astropy unit parsing the reference CLI uses
    (``frontend.py:293,318-320``).
    """
    if isinstance(text, Quantity):
        return text
    if isinstance(text, (int, float)):
        return Quantity(float(text), "dimensionless")
    m = _QUANTITY_RE.match(text)
    if not m:
        raise ValueError(f"could not parse quantity {text!r}")
    value = float(m.group(1))
    unit = m.group(2)
    if not unit:
        return Quantity(value, "dimensionless")
    if unit in _ANGLE_UNITS:
        return Quantity(value * _ANGLE_UNITS[unit], "angle")
    if unit in _LENGTH_UNITS:
        return Quantity(value * _LENGTH_UNITS[unit], "length")
    if unit in _FREQ_UNITS:
        return Quantity(value * _FREQ_UNITS[unit], "frequency")
    raise ValueError(f"unknown unit {unit!r} in {text!r}")


def wavelength_m(frequency_hz: float) -> float:
    """Wavelength in metres for a frequency in Hz."""
    return C_M_PER_S / frequency_hz


def rad_to_deg(x: float) -> float:
    return x * 180.0 / math.pi


def rad_to_arcsec(x: float) -> float:
    return x * 180.0 / math.pi * 3600.0
