"""CASA Measurement Set loader.

Behavioural parity with the reference ``loader_ms.py:35-489``: reads DATA
(or a ``-i data=COLUMN`` override) with unit-checked column access, converts
FLAG/FLAG_ROW to dropped/zero-weight samples, uses WEIGHT_SPECTRUM when
present (detecting the degenerate 0x0-shaped column some writers produce),
filters on FIELD_ID/DATA_DESC_ID and removes autocorrelations, orders rows
by baseline for compression, reads the phase centre from FIELD and
frequencies from SPECTRAL_WINDOW, and emits DATE-OBS/DATE-AVG/OBSGEO/
SPECSYS/TELESCOP/OBSERVER provenance FITS headers.

``-i pol-frame=feed`` computes per-visibility feed angles (parallactic
angle at each antenna plus the FEED table's RECEPTOR_ANGLE) driving the
rotated-Mueller preprocessing path.  The reference does this with astropy
CIRS/AltAz transforms (``loader_ms.py:377-476``); this build has no
astropy, so the angles come from :mod:`.ephem` with apparent-place terms
(precession/nutation/aberration) applied.

Unit checking mirrors the reference's vectorised manual scaling
(``loader_ms.py:35-105``): a column's ``QuantumUnits`` keyword is
validated against the expected unit and the data scaled; ``MEASINFO``
type/Ref are validated when specified.  Unitless columns are assumed to be
in the expected unit (not all writers record units).

Requires ``python-casacore``; in environments without it (such as this
build's), construction raises ImportError with a clear message — the native
HDF5 format (:mod:`.loader_hdf5`) is the supported interchange path.

The port's own copy of :mod:`katsdpimager_tpu.loader_ms` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import os
import time as _time
from typing import Iterator, Optional

import numpy as np

from . import arguments, ephem, loader_core

logger = logging.getLogger(__name__)

#: MS MEAS_FREQ_REF codes -> FITS SPECSYS values (MS v2 definition; same
#: mapping as reference loader_ms.py:22-32).
_SPECSYS = {0: "SOURCE", 1: "LSRK", 2: "LSRD", 3: "BARYCENT",
            4: "GEOCENTR", 5: "TOPOCENT", 6: "GALACTOC", 7: "LOCALGRP",
            8: "CMBDIPOL"}

#: Scale factors to the canonical unit of each dimension we read.
_UNIT_SCALE = {
    "m": ("m", 1.0), "cm": ("m", 1e-2), "mm": ("m", 1e-3), "km": ("m", 1e3),
    "s": ("s", 1.0), "ms": ("s", 1e-3), "min": ("s", 60.0), "h": ("s", 3600.0),
    "d": ("s", 86400.0),
    "Hz": ("Hz", 1.0), "kHz": ("Hz", 1e3), "MHz": ("Hz", 1e6),
    "GHz": ("Hz", 1e9),
    "Jy": ("Jy", 1.0), "mJy": ("Jy", 1e-3), "uJy": ("Jy", 1e-6),
    "rad": ("rad", 1.0), "deg": ("rad", np.pi / 180.0),
    "arcmin": ("rad", np.pi / 180.0 / 60.0),
    "arcsec": ("rad", np.pi / 180.0 / 3600.0),
}

#: UNIX epoch in MJD days (MS epochs are MJD seconds).
_MJD_UNIX_EPOCH = 40587.0


def _casacore():
    try:
        import casacore.tables  # type: ignore
    except ImportError as exc:
        raise ImportError(
            "python-casacore is required to read Measurement Sets; install "
            "python-casacore or convert the MS to the native HDF5 format "
            "(see katsdpimager_tpu_torch.loader_hdf5)") from exc
    return casacore.tables


def _col_keywords(table, name) -> dict:
    try:
        return table.getcolkeywords(name) or {}
    except (AttributeError, RuntimeError):
        return {}


def _unit_factor(found: str, expected: str, column: str) -> float:
    """Scale factor converting ``found`` units to ``expected`` units."""
    if found == expected:
        return 1.0
    f = _UNIT_SCALE.get(found)
    e = _UNIT_SCALE.get(expected)
    if f is None or e is None or f[0] != e[0]:
        raise ValueError(
            f"Expected {expected} in column {column} but found {found}")
    return f[1] / e[1]


def _checked(table, name, data, unit=None, measinfo_type=None,
             measinfo_ref=None):
    """Validate units/MEASINFO of column ``name`` and scale ``data``.

    Columns without a ``QuantumUnits`` keyword are assumed to already be in
    ``unit`` (many writers omit units); mismatched or unexpected units
    raise ValueError.
    """
    keywords = _col_keywords(table, name)
    qu = keywords.get("QuantumUnits")
    if qu is not None:
        if unit is None:
            raise ValueError(f"Found unexpected QuantumUnits for column "
                             f"{name}: {qu}")
        qu_arr = np.asarray(qu)
        factors = np.array([_unit_factor(str(u), unit, name)
                            for u in qu_arr.ravel()]).reshape(qu_arr.shape)
        if not np.all(factors == 1.0):
            if factors.size == 1 or data.ndim == 1:
                # scalar column (or one unit total)
                data = data * float(factors.ravel()[0])
            else:
                # per-axis units (e.g. one per receptor): broadcast the
                # factor array over the leading row axis (reference
                # loader_ms.py:83-95 nditer does the same per-slice)
                shape = (1,) * (data.ndim - factors.ndim) + factors.shape
                data = data * factors.reshape(shape)
    measinfo = keywords.get("MEASINFO")
    if measinfo is not None:
        if ((measinfo_type is not None
             and measinfo.get("type") != measinfo_type)
                or (measinfo_ref is not None
                    and measinfo.get("Ref") != measinfo_ref)):
            raise ValueError(
                f"Unsupported MEASINFO for {name}: {measinfo}")
    return data


def _getcol(table, name, start=0, nrow=None, unit=None, measinfo_type=None,
            measinfo_ref=None):
    data = table.getcol(name, start, nrow) if nrow is not None \
        else table.getcol(name)
    return _checked(table, name, np.asarray(data), unit, measinfo_type,
                    measinfo_ref)


def _getcell(table, name, row, unit=None, measinfo_type=None,
             measinfo_ref=None):
    data = np.asarray(table.getcell(name, row))
    return _checked(table, name, data, unit, measinfo_type, measinfo_ref)


def _mjdsec_to_fits(mjd_sec: float) -> str:
    """MJD seconds (UTC) -> FITS ISO-8601 string (millisecond-rounded
    before the integer/fraction split so .9996 s rolls into seconds)."""
    unix = float(mjd_sec) - _MJD_UNIX_EPOCH * 86400.0
    ms = round(unix * 1000.0)
    sec, frac_ms = divmod(ms, 1000)
    base = _time.strftime("%Y-%m-%dT%H:%M:%S", _time.gmtime(sec))
    return base + f".{frac_ms:03d}"


class LoaderMS(loader_core.LoaderBase):
    @classmethod
    def match(cls, filename: str) -> bool:
        return filename.lower().endswith(".ms") and os.path.isdir(filename)

    def __init__(self, filename, options, start_channel=0, stop_channel=None):
        super().__init__(filename, options, start_channel, stop_channel)
        tables = _casacore()
        parser = argparse.ArgumentParser(
            prog="Measurement set options",
            usage="Measurement set options: [-i data=COLUMN] "
                  "[-i field=FIELD] ...")
        parser.add_argument("--data", default="DATA", metavar="COLUMN",
                            help="Column containing visibilities "
                                 "[%(default)s]")
        parser.add_argument("--data-desc", type=int, default=0,
                            help="Data description ID to image [%(default)s]")
        parser.add_argument("--field", type=int, default=0,
                            help="Field to image [%(default)s]")
        parser.add_argument("--pol-frame", choices=["sky", "feed"],
                            default="sky",
                            help="Reference frame for polarization "
                                 "[%(default)s]")
        parser.add_argument("--uvw", choices=["casa", "strict"],
                            default="casa",
                            help="UVW sign convention (the casa default "
                                 "negates the Measurement Set definition, "
                                 "matching CASA and most imagers)")
        args = parser.parse_args(options,
                                 namespace=arguments.SmartNamespace())
        self._strict_uvw = args.uvw == "strict"
        self._feed_frame = args.pol_frame == "feed"
        self._options = args
        self._main = tables.table(filename, ack=False)
        self._data_col = args.data
        self._field = args.field
        self._data_desc = args.data_desc
        if self._data_col not in self._main.colnames():
            raise ValueError(f"{filename} has no column named "
                             f"{self._data_col}")

        self._tables = tables
        self._filename = filename
        self._antenna = tables.table(filename + "::ANTENNA", ack=False)
        self._spw = tables.table(filename + "::SPECTRAL_WINDOW", ack=False)
        self._field_table = tables.table(filename + "::FIELD", ack=False)
        self._pol_table = tables.table(filename + "::POLARIZATION", ack=False)
        self._ddesc = tables.table(filename + "::DATA_DESCRIPTION", ack=False)
        if args.field < 0 or args.field >= self._field_table.nrows():
            raise ValueError(f"Field {args.field} is out of range")
        if args.data_desc < 0 or args.data_desc >= self._ddesc.nrows():
            raise ValueError(f"Data description {args.data_desc} is out of "
                             f"range")

        self._spw_id = int(self._ddesc.getcell("SPECTRAL_WINDOW_ID",
                                               self._data_desc))
        pol_id = self._ddesc.getcell("POLARIZATION_ID", self._data_desc)
        self._frequencies = np.asarray(
            _getcell(self._spw, "CHAN_FREQ", self._spw_id, "Hz"), np.float64)
        self._corr_types = [int(x) for x in
                            self._pol_table.getcell("CORR_TYPE", pol_id)]
        self._positions = np.asarray(
            _getcol(self._antenna, "POSITION", unit="m",
                    measinfo_type="position", measinfo_ref="ITRF"),
            np.float64)
        diffs = self._positions[:, None, :] - self._positions[None, :, :]
        self._longest = float(np.sqrt((diffs ** 2).sum(axis=-1)).max())
        self._diameters = np.asarray(
            _getcol(self._antenna, "DISH_DIAMETER", unit="m"), np.float64)
        self._has_weight_spectrum = self._detect_weight_spectrum()

        if self._feed_frame:
            # Constant receptor angle per antenna from the FEED table (the
            # reference supports exactly this case, loader_ms.py:280-295).
            feed = tables.table(filename + "::FEED", ack=False)
            try:
                ant_id = np.asarray(feed.getcol("ANTENNA_ID"))
                rec = _getcol(feed, "RECEPTOR_ANGLE", unit="rad")
                angle = np.full(int(ant_id.max()) + 1, np.nan)
                for i, a in enumerate(ant_id):
                    for r in np.ravel(rec[i]):
                        if (not np.isnan(angle[a])
                                and abs(angle[a] - r) > 1e-8):
                            raise ValueError(
                                "Multiple feed angles for one antenna is "
                                "not supported")
                        angle[a] = r
            finally:
                feed.close()
            self._antenna_angle = angle
            lat, lon, _h = ephem.ecef_to_geodetic(self._positions)
            self._ant_latlon = np.stack([lat, lon], axis=-1)
        else:
            self._antenna_angle = None

        self._average_time = None    # MJD seconds; set while iterating
        self._observation_ids: set = set()

        unparsed = arguments.unparse_args(args)
        self._command_line_options = []
        for arg in unparsed:
            self._command_line_options.append("-i")
            self._command_line_options.append(arg[2:])

    def _detect_weight_spectrum(self) -> bool:
        """WEIGHT_SPECTRUM present AND usable (some writers create the
        column with 0x0 cells; reference loader_ms.py:270-277)."""
        if "WEIGHT_SPECTRUM" not in self._main.colnames():
            return False
        if self._main.nrows() == 0:
            return False
        try:
            cell = self._main.getcell("WEIGHT_SPECTRUM", 0)
        except RuntimeError:
            return False
        return np.asarray(cell).size > 0

    def command_line_options(self):
        return self._command_line_options

    def antenna_diameters(self):
        return self._diameters

    def antenna_positions(self):
        return self._positions

    def antenna_diameter(self) -> float:
        return float(self._diameters.min())

    def longest_baseline(self) -> float:
        return self._longest

    def num_channels(self) -> int:
        return len(self._frequencies)

    def frequency(self, channel: int) -> float:
        return float(self._frequencies[channel])

    def band(self) -> Optional[str]:
        try:
            name = self._spw.getcell("NAME", self._spw_id)
        except (KeyError, RuntimeError):
            return None
        if not name or str(name).lower() == "none":
            return None
        return str(name)

    def phase_centre(self):
        direction = np.asarray(_getcell(
            self._field_table, "PHASE_DIR", self._field, "rad",
            measinfo_type="direction", measinfo_ref="J2000"))
        if direction.shape != (1, 2):
            raise ValueError(f"Unsupported shape for PHASE_DIR: "
                             f"{direction.shape}")
        return float(direction[0, 0]), float(direction[0, 1])

    def polarizations(self):
        return list(self._corr_types)

    def has_feed_angles(self) -> bool:
        return self._feed_frame

    def data_iter(self, start_channel: int, stop_channel: int,
                  max_chunk_vis: Optional[int] = None) -> Iterator[dict]:
        total = self._main.nrows()
        C = stop_channel - start_channel
        step = total if max_chunk_vis is None \
            else max(1, max_chunk_vis // max(C, 1))
        n_ant = self._antenna.nrows()
        if self._feed_frame:
            ra, dec = self.phase_centre()
        # Accumulate the set of distinct dump times across chunks: a dump
        # whose rows straddle a chunk boundary must not be counted twice
        # in the DATE-AVG mean.
        times_seen: set = set()
        for start in range(0, total, step):
            nrow = min(total - start, step)
            ant1 = np.asarray(self._main.getcol("ANTENNA1", start, nrow))
            ant2 = np.asarray(self._main.getcol("ANTENNA2", start, nrow))
            field = np.asarray(self._main.getcol("FIELD_ID", start, nrow))
            ddid = np.asarray(self._main.getcol("DATA_DESC_ID", start, nrow)) \
                if "DATA_DESC_ID" in self._main.colnames() \
                else np.full(nrow, self._data_desc)
            flag_row = np.asarray(self._main.getcol("FLAG_ROW", start, nrow))
            if "OBSERVATION_ID" in self._main.colnames():
                self._observation_ids.update(
                    np.asarray(self._main.getcol("OBSERVATION_ID", start,
                                                 nrow)).tolist())
            keep = ((ant1 != ant2) & (field == self._field)
                    & (ddid == self._data_desc) & ~flag_row.astype(bool))

            uvw = _getcol(self._main, "UVW", start, nrow, "m",
                          measinfo_type="uvw").astype(np.float64)
            if not self._strict_uvw:
                # CASA convention: negate relative to the MS definition
                # (reference loader_ms.py:452-453)
                uvw = -uvw
            data = _getcol(self._main, self._data_col, start, nrow, "Jy")
            data = data[:, start_channel:stop_channel, :]  # (rows, C, Q)
            flag = np.asarray(self._main.getcol("FLAG", start, nrow))[
                :, start_channel:stop_channel, :]
            if self._has_weight_spectrum:
                weights = np.asarray(self._main.getcol(
                    "WEIGHT_SPECTRUM", start, nrow))[
                    :, start_channel:stop_channel, :]
            else:
                weights = np.repeat(
                    np.asarray(self._main.getcol(
                        "WEIGHT", start, nrow))[:, None, :], C, axis=1)
            weights = np.where(flag, 0.0, weights)

            if "TIME_CENTROID" in self._main.colnames():
                # Units default to MJD seconds when unrecorded (reference
                # loader_ms.py:430-434 makes the same assumption).
                tc = _getcol(self._main, "TIME_CENTROID", start, nrow, "s",
                             measinfo_type="epoch", measinfo_ref="UTC")
                tc = tc[keep]
                # average over unique dump times, not rows (each time
                # repeats per baseline; reference loader_ms.py:423-429)
                times_seen.update(np.unique(tc).tolist())
                if times_seen:
                    self._average_time = (sum(times_seen)
                                          / len(times_seen))
            else:
                tc = None

            ant1 = ant1[keep]
            ant2 = ant2[keep]
            uvw = uvw[keep]
            data = data[keep]
            weights = weights[keep]
            # baseline-major order so consecutive rows move slowly in UV
            # (helps compression; reference loader_ms.py:466-470)
            order = np.argsort(ant1 * n_ant + ant2, kind="stable")
            ret = dict(
                uvw=uvw[order].astype(np.float32),
                vis=np.ascontiguousarray(
                    data[order].transpose(1, 0, 2).astype(np.complex64)),
                weights=np.ascontiguousarray(
                    weights[order].transpose(1, 0, 2).astype(np.float32)),
                progress=start + nrow,
                total=total)
            if self._feed_frame:
                if tc is None:
                    raise ValueError("pol-frame=feed requires TIME_CENTROID")
                # Per-unique-time parallactic angles at each antenna; the
                # feed angle adds the fixed receptor angle (reference
                # loader_ms.py:436-451, computed here via .ephem instead of
                # astropy AltAz).
                ut, inverse = np.unique(tc, return_inverse=True)
                unix = ut - _MJD_UNIX_EPOCH * 86400.0
                pa = np.stack([
                    ephem.parallactic_angle(lat, lon, ra, dec, unix,
                                            apparent=True)
                    for lat, lon in self._ant_latlon])      # (A, T)
                fa = pa + self._antenna_angle[:, None]
                ret["feed_angle1"] = fa[ant1[order],
                                        inverse[order]].astype(np.float32)
                ret["feed_angle2"] = fa[ant2[order],
                                        inverse[order]].astype(np.float32)
            yield ret

    def observation(self):
        out = {"antenna_positions": self._positions,
               "phase_centre": np.asarray(self.phase_centre())}
        nrow = self._main.nrows()
        if nrow:
            stride = max(1, nrow // 20000)
            try:
                # casacore getcol supports a row increment: sample without
                # materializing the whole column
                uvw = np.asarray(self._main.getcol("UVW", 0, -1, stride))
            except TypeError:
                uvw = np.asarray(self._main.getcol("UVW"))[::stride]
            if not self._strict_uvw:
                uvw = -uvw
            out["uvw_samples"] = np.asarray(uvw, np.float64)
            if "TIME_CENTROID" in self._main.colnames():
                # MS rows need not be time-ordered: take min/max over a
                # strided sample of the (unit-checked) column rather than
                # the first/last rows.
                try:
                    tc = np.asarray(self._main.getcol(
                        "TIME_CENTROID", 0, -1, stride))
                except TypeError:
                    tc = np.asarray(
                        self._main.getcol("TIME_CENTROID"))[::stride]
                tc = _checked(self._main, "TIME_CENTROID", tc, "s",
                              measinfo_type="epoch", measinfo_ref="UTC")
                out["time_range"] = (
                    float(tc.min()) - _MJD_UNIX_EPOCH * 86400.0,
                    float(tc.max()) - _MJD_UNIX_EPOCH * 86400.0)
        return out

    def extra_fits_headers(self) -> dict:
        headers = {}
        obsgeo = self._positions.mean(axis=0)
        comment = "Average of antenna positions"
        headers["OBSGEO-X"] = (float(obsgeo[0]), comment)
        headers["OBSGEO-Y"] = (float(obsgeo[1]), comment)
        headers["OBSGEO-Z"] = (float(obsgeo[2]), comment)
        if self._average_time is not None:
            headers["DATE-AVG"] = _mjdsec_to_fits(self._average_time)
        try:
            ref = int(self._spw.getcell("MEAS_FREQ_REF", self._spw_id))
        except (KeyError, RuntimeError):
            ref = None
        if ref in _SPECSYS:
            headers["SPECSYS"] = _SPECSYS[ref]
        if len(self._observation_ids) == 1:
            row = next(iter(self._observation_ids))
            try:
                obs = self._tables.table(self._filename + "::OBSERVATION",
                                         ack=False)
            except (RuntimeError, KeyError):
                obs = None
            if obs is not None:
                try:
                    time_range = _getcell(obs, "TIME_RANGE", row, "s",
                                          measinfo_type="epoch",
                                          measinfo_ref="UTC")
                    headers["DATE-OBS"] = _mjdsec_to_fits(
                        float(np.ravel(time_range)[0]))
                    headers["TELESCOP"] = str(obs.getcell("TELESCOPE_NAME",
                                                          row))
                    headers["OBSERVER"] = str(obs.getcell("OBSERVER", row))
                finally:
                    obs.close()
        elif len(self._observation_ids) > 1:
            logger.warning("Multiple OBSERVATION_IDs; will not add FITS "
                           "headers for observation")
        return headers

    @property
    def raw_data(self):
        return self._main

    def close(self):
        for t in (self._main, self._antenna, self._spw, self._field_table,
                  self._pol_table, self._ddesc):
            t.close()
