"""FITS output (and a minimal reader for tests), implemented directly on the
FITS format with numpy — astropy is not a dependency of this framework.

Header conventions are parity with the reference ``io.py:87-233``:

- axes are (l [reversed so RA grows right-to-left], m, Stokes, frequency);
- ``CRPIX1 = N/2`` on the flipped l axis and ``CRPIX2 = N/2 + 1`` place the
  phase centre at the (N/2, N/2) pixel of the stored image (fftshift
  convention);
- celestial WCS is RA---SIN / DEC--SIN, degrees, FK5/J2000;
- the Stokes axis uses the FITS enumeration (which differs from CASA's;
  ``_FITS_POLARIZATIONS``), required to form a linear sequence;
- restoring-beam headers BMAJ/BMIN/BPA in degrees; provenance in HISTORY.

The port's own copy of :mod:`katsdpimager_tpu.io` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from . import __version__, polarization, units

#: CASA -> FITS polarization codes (FITS swaps X and Y; AIPS memo 114)
_FITS_POLARIZATIONS = {
    polarization.STOKES_I: 1,
    polarization.STOKES_Q: 2,
    polarization.STOKES_U: 3,
    polarization.STOKES_V: 4,
    polarization.STOKES_RR: -1,
    polarization.STOKES_LL: -2,
    polarization.STOKES_RL: -3,
    polarization.STOKES_LR: -4,
    polarization.STOKES_YY: -5,
    polarization.STOKES_XX: -6,
    polarization.STOKES_YX: -7,
    polarization.STOKES_XY: -8,
}

_BLOCK = 2880


def _format_card(key: str, value, comment: str = "") -> bytes:
    """Format one 80-byte FITS header card."""
    if key == "END":
        card = "END"
    elif key in ("HISTORY", "COMMENT"):
        card = f"{key:<8}{value}"
    else:
        if isinstance(value, bool):
            sval = "T" if value else "F"
            body = f"{key:<8}= {sval:>20}"
        elif isinstance(value, (int, np.integer)):
            body = f"{key:<8}= {value:>20d}"
        elif isinstance(value, (float, np.floating)):
            body = f"{key:<8}= {value:>20.14G}"
        else:
            sval = "'" + str(value).replace("'", "''") + "'"
            body = f"{key:<8}= {sval:<20}"
        card = body + (f" / {comment}" if comment else "")
    return card[:80].ljust(80).encode("ascii")


def _fits_polarizations(cards, axis: int, polarizations):
    """Add Stokes-axis keywords; returns the permutation to apply to the
    polarization axis of the data."""
    pols = np.array([_FITS_POLARIZATIONS[i] for i in polarizations])
    if pols[0] >= 0:
        pol_permute = np.argsort(pols)
    else:
        pol_permute = np.argsort(-pols)
    pols = pols[pol_permute]
    pol_ref = pols[0]
    pol_delta = pols[1] - pols[0] if len(pols) > 1 else 1
    if np.any(pols != np.arange(len(pols)) * pol_delta + pol_ref):
        raise ValueError("Polarizations do not form a linear sequence in FITS enumeration")
    cards.append((f"CTYPE{axis}", "STOKES"))
    cards.append((f"CRPIX{axis}", 1.0))
    cards.append((f"CRVAL{axis}", float(pol_ref)))
    cards.append((f"CDELT{axis}", float(pol_delta)))
    return pol_permute


def write_fits_image(image: np.ndarray, image_parameters, filename: str,
                     phase_centre_radec=(0.0, 0.0), beam=None,
                     bunit: Optional[str] = "Jy/beam",
                     extra_headers=None, history=None):
    """Write a (P, N, N) image to a FITS file.

    ``phase_centre_radec`` is (ra, dec) in radians.  ``beam`` is an
    :class:`..ops.beam.Beam` (FWHM in pixels).
    """
    ip = image_parameters
    cards = [("SIMPLE", True, "conforms to FITS standard")]
    bitpix = -32 if image.dtype.itemsize == 4 else -64
    cards.append(("BITPIX", bitpix))
    cards.append(("NAXIS", 4))
    cards.append(("NAXIS1", image.shape[2]))
    cards.append(("NAXIS2", image.shape[1]))
    cards.append(("NAXIS3", image.shape[0]))
    cards.append(("NAXIS4", 1))
    if bunit is not None:
        cards.append(("BUNIT", bunit))
    cards.append(("ORIGIN", "katsdpimager-tpu"))
    cards.append(("HISTORY", f"Created by katsdpimager_tpu {__version__}"))
    if history:
        for line in history:
            cards.append(("HISTORY", line))

    cards.append(("CRPIX1", image.shape[2] * 0.5))
    cards.append(("CRPIX2", image.shape[1] * 0.5 + 1.0))
    cards.append(("CRPIX4", 1.0))
    delt = math.degrees(math.asin(ip.pixel_size))
    cards.append(("CDELT1", -delt))
    cards.append(("CDELT2", delt))
    cards.append(("CDELT4", 1.0))
    cards.append(("EQUINOX", 2000.0))
    cards.append(("RADESYS", "FK5"))
    cards.append(("CUNIT1", "deg"))
    cards.append(("CUNIT2", "deg"))
    cards.append(("CUNIT4", "Hz"))
    cards.append(("CTYPE1", "RA---SIN"))
    cards.append(("CTYPE2", "DEC--SIN"))
    cards.append(("CTYPE4", "FREQ"))
    cards.append(("CRVAL1", math.degrees(phase_centre_radec[0])))
    cards.append(("CRVAL2", math.degrees(phase_centre_radec[1])))
    cards.append(("CRVAL4", units.C_M_PER_S / ip.wavelength))
    if beam is not None:
        cards.append(("BMAJ", math.degrees(beam.major * ip.pixel_size)))
        cards.append(("BMIN", math.degrees(beam.minor * ip.pixel_size)))
        cards.append(("BPA", math.degrees(beam.theta)))
    pol_permute = _fits_polarizations(cards, 3, ip.fixed.polarizations)
    finite = image[np.isfinite(image)]
    if finite.size:
        cards.append(("DATAMIN", float(finite.min())))
        cards.append(("DATAMAX", float(finite.max())))
    if extra_headers:
        for k, v in extra_headers.items():
            cards.append((k, v))

    data = image[pol_permute][np.newaxis, :, :, ::-1]
    dtype = np.dtype(">f4") if bitpix == -32 else np.dtype(">f8")
    raw = np.ascontiguousarray(data, dtype)

    with open(filename, "wb") as f:
        buf = b"".join(_format_card(*c) for c in cards) + _format_card("END", None)
        pad = (-len(buf)) % _BLOCK
        f.write(buf + b" " * pad)
        payload = raw.tobytes()
        f.write(payload)
        f.write(b"\0" * ((-len(payload)) % _BLOCK))


def write_fits_grid(grid: np.ndarray, image_parameters, filename: str):
    """Write a UV grid (P, N, N complex) to FITS with a COMPLEX axis
    splitting real/imaginary parts and a metre-scaled UV WCS (parity with
    reference io.py:228-270)."""
    ip = image_parameters
    grid = np.asarray(grid)
    P, N = grid.shape[0], grid.shape[-1]
    real_dtype = np.float32 if grid.dtype == np.complex64 else np.float64
    split = grid.view(real_dtype).reshape(P, N, N, 2).transpose(3, 0, 1, 2)

    cards = [("SIMPLE", True)]
    bitpix = -32 if real_dtype == np.float32 else -64
    cards.append(("BITPIX", bitpix))
    cards.append(("NAXIS", 4))
    cards.append(("NAXIS1", N))
    cards.append(("NAXIS2", N))
    cards.append(("NAXIS3", P))
    cards.append(("NAXIS4", 2))
    cards.append(("BUNIT", "Jy"))
    cards.append(("ORIGIN", "katsdpimager-tpu"))
    for axis in (1, 2):
        cards.append((f"CUNIT{axis}", "m"))
        cards.append((f"CRPIX{axis}", N // 2 + 1.0))
        cards.append((f"CRVAL{axis}", 0.0))
        cards.append((f"CDELT{axis}", ip.cell_size))
    pol_permute = _fits_polarizations(cards, 3, ip.fixed.polarizations)
    cards.append(("CTYPE4", "COMPLEX"))
    cards.append(("CRPIX4", 1.0))
    cards.append(("CRVAL4", 1.0))
    cards.append(("CDELT4", 1.0))

    data = split[:, pol_permute, :, :]
    dtype = np.dtype(">f4") if bitpix == -32 else np.dtype(">f8")
    raw = np.ascontiguousarray(data, dtype)
    with open(filename, "wb") as f:
        buf = b"".join(_format_card(*c) for c in cards) + _format_card("END", None)
        f.write(buf + b" " * ((-len(buf)) % _BLOCK))
        payload = raw.tobytes()
        f.write(payload)
        f.write(b"\0" * ((-len(payload)) % _BLOCK))


def read_fits(filename: str):
    """Minimal FITS reader for round-trip tests: returns (header dict, data)."""
    with open(filename, "rb") as f:
        raw = f.read()
    header = {}
    pos = 0
    while True:
        card = raw[pos:pos + 80].decode("ascii")
        pos += 80
        key = card[:8].strip()
        if key == "END":
            pos = (pos + _BLOCK - 1) // _BLOCK * _BLOCK
            break
        if key in ("HISTORY", "COMMENT", ""):
            header.setdefault(key, []).append(card[8:].strip())
            continue
        if card[8:10] == "= ":
            value = card[10:].split(" / ")[0].strip()
            if value.startswith("'"):
                header[key] = value.strip("'").strip()
            elif value == "T":
                header[key] = True
            elif value == "F":
                header[key] = False
            else:
                try:
                    header[key] = int(value)
                except ValueError:
                    header[key] = float(value)
    bitpix = header["BITPIX"]
    shape = tuple(header[f"NAXIS{i}"] for i in range(header["NAXIS"], 0, -1))
    count = int(np.prod(shape))
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    data = np.frombuffer(raw[pos:pos + count * np.dtype(dtype).itemsize],
                         dtype=dtype).reshape(shape)
    return header, data
