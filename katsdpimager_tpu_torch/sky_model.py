"""Local sky models for continuum subtraction (``--subtract``).

Capability parity with the reference ``sky_model.py``: a :class:`SkyModel`
exposes ``lmn(phase_centre)`` and ``flux_density(wavelength)``; models load
from files via :func:`open_sky_model`.

Supported formats:

- whitespace-separated text like the reference's ``tests/lsm.txt``
  (``ra dec I [Q U V]`` with ra in ``h:m:s`` and dec in ``d:m:s``, or
  decimal degrees); lines starting with ``#`` are comments;
- katpoint catalogue description lines (``name, tags, ra, dec, (fmin fmax
  coefs... [I Q U V])`` with the log10-polynomial flux model), parsed
  natively — no katpoint dependency (reference sky_model.py:67-103
  semantics, validated against its test values);
- katdal-telstate CLEAN-component models via
  :func:`catalogue_from_telstate` (reference sky_model.py:104-163),
  operating on any katsdptelstate-shaped mapping (``view``/``join``).

The port's own copy of :mod:`katsdpimager_tpu.sky_model` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import re
import urllib.parse
from typing import List, Tuple

import numpy as np


class NoSkyModelError(Exception):
    """No sky model is available for the data set."""


def _parse_ra(text: str) -> float:
    """RA in radians from h:m:s or decimal degrees."""
    if ":" in text:
        parts = [float(p) for p in text.split(":")]
        hours = parts[0] + parts[1] / 60 + (parts[2] if len(parts) > 2 else 0) / 3600
        return hours * math.pi / 12
    return math.radians(float(text))


def _parse_dec(text: str) -> float:
    """Dec in radians from d:m:s or decimal degrees."""
    if ":" in text:
        neg = text.strip().startswith("-")
        parts = [abs(float(p)) for p in text.split(":")]
        deg = parts[0] + parts[1] / 60 + (parts[2] if len(parts) > 2 else 0) / 3600
        return math.radians(-deg if neg else deg)
    return math.radians(float(text))


class SkyModel:
    """Point-source sky model with power-law spectra.

    positions: (S, 2) radians (ra, dec); flux: (S, 4) IQUV Jy at the
    reference frequency; spectral_index: (S,) (0 = flat);
    ref_freq: reference frequency in Hz.
    """

    def __init__(self, positions: np.ndarray, flux_iquv: np.ndarray,
                 spectral_index=None, ref_freq: float = 1.4e9):
        self.positions = np.asarray(positions, np.float64)
        self.flux_iquv = np.asarray(flux_iquv, np.float64)
        self.spectral_index = (np.zeros(len(self.positions))
                               if spectral_index is None
                               else np.asarray(spectral_index, np.float64))
        self.ref_freq = ref_freq

    def __len__(self):
        return len(self.positions)

    def lmn(self, phase_centre: Tuple[float, float]) -> np.ndarray:
        """(S, 3) array of (l, m, n-1) relative to the phase centre."""
        ra0, dec0 = phase_centre
        ra = self.positions[:, 0]
        dec = self.positions[:, 1]
        l = np.cos(dec) * np.sin(ra - ra0)
        m = (np.sin(dec) * np.cos(dec0)
             - np.cos(dec) * np.sin(dec0) * np.cos(ra - ra0))
        n1 = np.sqrt(1.0 - l * l - m * m) - 1.0
        return np.stack([l, m, n1], axis=-1)

    def flux_density(self, wavelength: float) -> np.ndarray:
        """(S, 4) IQUV flux densities at the given wavelength
        (power law: S(f) = S0 (f/f0)^alpha)."""
        from .units import C_M_PER_S

        freq = C_M_PER_S / wavelength
        scale = (freq / self.ref_freq) ** self.spectral_index
        return self.flux_iquv * scale[:, None]


def parse_text_model(text: str) -> SkyModel:
    """Parse ``ra dec I [Q U V [alpha [ref_freq_MHz]]]`` lines."""
    positions: List[Tuple[float, float]] = []
    fluxes: List[Tuple[float, float, float, float]] = []
    alphas: List[float] = []
    ref_freq = 1.4e9
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        fields = re.split(r"[,\s]+", line)
        ra = _parse_ra(fields[0])
        dec = _parse_dec(fields[1])
        vals = [float(v) for v in fields[2:6]]
        while len(vals) < 4:
            vals.append(0.0)
        alpha = float(fields[6]) if len(fields) > 6 else 0.0
        if len(fields) > 7:
            ref_freq = float(fields[7]) * 1e6
        positions.append((ra, dec))
        fluxes.append(tuple(vals))
        alphas.append(alpha)
    return SkyModel(np.array(positions), np.array(fluxes),
                    np.array(alphas), ref_freq)


# ---------------------------------------------------------------------------
# katpoint catalogue format (description lines), parsed natively


class KatpointTarget:
    """One parsed katpoint description line.

    ``name, tags, ra, dec[, (fmin_MHz fmax_MHz a b c d e f [I Q U V])]``:
    the flux model follows katpoint's FluxDensityModel —
    ``log10(S_I/Jy) = a + b x + c x^2 + d x^3 + e v + f v^2`` with
    ``x = log10(v)`` and ``v`` the frequency in MHz — scaled per Stokes
    by the optional (I, Q, U, V) factors, valid only inside
    [fmin, fmax] (0 outside — reference katpoint semantics via
    sky_model.py:97-101 nan_to_num)."""

    def __init__(self, description: str):
        self.description = description.strip()
        fields = [f.strip() for f in self.description.split(",")]
        if len(fields) < 2:
            raise ValueError(f"Bad katpoint target {description!r}")
        names = [n.strip() for n in fields[0].split("|")]
        self.name = names[0]
        self.aliases = names[1:]
        self.tags = fields[1].split()
        self.body_type = self.tags[0] if self.tags else ""
        self.ra = self.dec = None
        self.flux_range = None
        self.flux_coefs = None
        self.flux_scales = np.array([1.0, 0.0, 0.0, 0.0])
        rest = fields[2:]
        if self.body_type == "radec" and len(rest) >= 2:
            self.ra = _parse_ra(rest[0])
            self.dec = _parse_dec(rest[1])
            rest = rest[2:]
        for field in rest:
            if field.startswith("("):
                vals = [float(v) for v in field.strip("() \t").split()]
                self.flux_range = (vals[0] * 1e6, vals[1] * 1e6)
                coefs = vals[2:]
                if len(coefs) > 6:
                    scales = coefs[6:10]
                    self.flux_scales = np.array(
                        (scales + [0.0] * 4)[:4], np.float64)
                    coefs = coefs[:6]
                self.flux_coefs = np.array(coefs, np.float64)

    def radec(self):
        return self.ra, self.dec

    #: katpoint.Target API name used by the katdal loader
    astrometric_radec = radec

    def flux_density_stokes(self, freq_hz: float) -> np.ndarray:
        """(4,) IQUV flux in Jy at ``freq_hz`` (zeros out of range)."""
        if self.flux_coefs is None or self.flux_range is None:
            return np.zeros(4)
        lo, hi = self.flux_range
        if not (lo <= freq_hz <= hi):
            return np.zeros(4)
        v = freq_hz / 1e6
        x = math.log10(v)
        c = list(self.flux_coefs) + [0.0] * (6 - len(self.flux_coefs))
        log_s = (c[0] + c[1] * x + c[2] * x ** 2 + c[3] * x ** 3
                 + c[4] * v + c[5] * v ** 2)
        return 10.0 ** log_s * self.flux_scales

    def __eq__(self, other):
        return (isinstance(other, KatpointTarget)
                and self.name == other.name and self.ra == other.ra
                and self.dec == other.dec)


class KatpointSkyModel(SkyModel):
    """SkyModel over parsed katpoint targets (reference sky_model.py:67)."""

    def __init__(self, targets):
        self.targets = [t if isinstance(t, KatpointTarget)
                        else KatpointTarget(t) for t in targets]
        positions = np.array([[t.ra, t.dec] for t in self.targets],
                             np.float64).reshape(-1, 2)
        # Flux handled by the katpoint model; base-class fields unused
        super().__init__(positions, np.zeros((len(self.targets), 4)))

    def flux_density(self, wavelength: float) -> np.ndarray:
        from .units import C_M_PER_S

        freq = C_M_PER_S / wavelength
        return np.stack([t.flux_density_stokes(freq) for t in self.targets]
                        ) if self.targets else np.zeros((0, 4))


def parse_katpoint_catalogue(text: str) -> KatpointSkyModel:
    lines = [ln.strip() for ln in text.splitlines()]
    return KatpointSkyModel([ln for ln in lines
                             if ln and not ln.startswith("#")])


def _looks_like_katpoint(text: str) -> bool:
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        fields = line.split(",")
        return len(fields) >= 2 and "radec" in fields[1]
    return False


def catalogue_from_telstate(telstate, capture_block_id, continuum,
                            target) -> KatpointSkyModel:
    """Extract the katsdpcontim CLEAN-component catalogue for ``target``.

    ``telstate`` is any mapping with katsdptelstate's ``view(name,
    exclusive=)``, ``join`` and ``get`` API (see
    :class:`~.loader_katdal.SimpleTelstate`); ``target`` is a
    :class:`KatpointTarget` or description string.  Mirrors reference
    sky_model.py:104-163 including auto-detection of the continuum
    stream."""
    if not isinstance(target, KatpointTarget):
        target = KatpointTarget(target)
    try:
        if continuum is None:
            for stream_name in telstate["sdp_archived_streams"]:
                # stream_type may live under the stream or the
                # capture-block-prefixed namespace (reference
                # sky_model.py:139-140 adds both views)
                view = telstate.view(stream_name, exclusive=True)
                view = view.view(telstate.join(capture_block_id,
                                               stream_name))
                if view.get("stream_type") in ("sdp.continuum_image",
                                               "continuum_image"):
                    if continuum is not None:
                        raise NoSkyModelError(
                            "Multiple continuum image streams found - "
                            "need to select one")
                    continuum = stream_name
            if continuum is None:
                raise NoSkyModelError("No continuum image streams found")
        view = telstate.view(continuum, exclusive=True)
        view = view.view(telstate.join(capture_block_id, continuum))
        target_namespace = view["targets"][target.description]
        prefix = telstate.join(capture_block_id, continuum,
                               target_namespace, "target0")
        data = view.view(prefix)["clean_components"]
        desc = data["description"]
        if isinstance(desc, bytes):
            desc = desc.decode("utf-8")
        if KatpointTarget(desc) == target:
            comps = [c.decode("utf-8") if isinstance(c, bytes) else c
                     for c in data["components"]]
            return KatpointSkyModel(comps)
    except (KeyError, TypeError):
        pass
    raise NoSkyModelError(f"Sky model for target {target.name} not found")


def open_sky_model(url: str) -> SkyModel:
    """Open a sky model from a URL/path, with ``format=`` query parameter
    (parity with reference sky_model.py:166-233).  ``format=text`` sniffs
    katpoint description lines so reference catalogues load either way."""
    parsed = urllib.parse.urlparse(url)
    params = urllib.parse.parse_qs(parsed.query)
    fmt = params.get("format", ["text"])[0]
    path = parsed.path or url.split("?")[0]
    if fmt in ("text", "lsm"):
        with open(path) as f:
            text = f.read()
        if _looks_like_katpoint(text):
            return parse_katpoint_catalogue(text)
        return parse_text_model(text)
    if fmt == "katpoint":
        with open(path) as f:
            return parse_katpoint_catalogue(f.read())
    raise ValueError(f"Unknown sky model format {fmt!r}")
