"""MeerKAT katdal (MVFv4 / ``.rdb``) loader.

Behavioural parity with the reference ``loader_katdal.py:65-480``: target
selection by tag/name/index, correlation-product → (baseline, polarization)
permutation with missing-product flagging, RFI/band channel masks, per-dump
UVW coordinates and parallactic feed angles, telstate CLEAN-component sky
models, and MeerKAT provenance FITS headers.

The katdal package is not part of this build, so the loader is written
against the small **dataset protocol** below (the subset of the katdal
``VisibilityDataV4`` surface the reference actually uses).  When katdal is
installed, :func:`open_dataset` uses ``katdal.open`` directly; tests (and
other data sources) inject datasets via :data:`dataset_opener` — the same
fake-backend seam the reference uses with ``mock.patch('katdal.open')``
(reference ``test/test_loader_katdal.py:47-120``).

Dataset protocol (attribute names follow katdal):

- ``shape`` (dumps, channels, corr_products); ``timestamps`` (T,) UNIX
  seconds; ``freqs`` (C,) Hz; ``dump_period`` s; ``start_time`` UNIX;
  ``observer`` str
- ``spectral_windows``: list with ``.band`` and ``.product``
- ``catalogue``: iterable of targets, plus ``.targets`` list.  Targets
  expose ``name``, ``tags``, ``aliases``, ``description``, ``body_type``
  and ``astrometric_radec()`` (radians)
- ``ants``: list with ``.name``, ``.diameter``, ``.position_ecef``
- ``corr_products``: (CP, 2) array of input labels like ``'m000h'``
- ``vis``, ``weights``, ``flags``: lazily indexable as
  ``arr[t0:t1, c0:c1, :]`` returning numpy
- ``select(**kwargs)``: katdal dataset selection (targets/scans/corrprods)
- ``source``: with ``.telstate`` (katsdptelstate-shaped mapping),
  ``.capture_block_id``, ``.stream_name``

Deviations from the reference (doc/DEVIATIONS.md): UVW and parallactic
angles come from :mod:`.ephem` instead of katpoint (apparent-place terms
dropped), and RFI/band masks are read from a telstate-embedded boolean
array (key ``model_rfi_mask_<mode>``) instead of fetching katsdpmodels
over HTTP.

The port's own copy of :mod:`katsdpimager_tpu.loader_katdal` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import math
import time
import urllib.parse
from typing import Iterator, List, Optional

import numpy as np

from . import arguments, ephem, loader_core, polarization, sky_model

logger = logging.getLogger(__name__)

#: Test seam: callable(filename, **kwargs) -> dataset, or None to use katdal.
dataset_opener = None


def open_dataset(filename: str, **kwargs):
    if dataset_opener is not None:
        return dataset_opener(filename, **kwargs)
    try:
        import katdal  # type: ignore
    except ImportError as exc:
        raise ImportError(
            "katdal is required to read MVFv4 (.rdb) datasets; install "
            "katdal, or convert the observation to the native HDF5 format "
            "(katsdpimager_tpu_torch.loader_hdf5)") from exc
    return katdal.open(filename, **kwargs)


class SimpleTelstate:
    """Minimal katsdptelstate-shaped view over a plain dict.

    Implements the ``view``/``join``/``get``/``__getitem__`` subset used by
    :func:`..sky_model.catalogue_from_telstate` and the channel-mask
    lookup.  Views are prefix namespaces separated by ``_`` with fallback
    to the root, like katsdptelstate."""

    SEPARATOR = "_"

    def __init__(self, data: dict, prefixes=("",)):
        self._data = data
        self._prefixes = tuple(prefixes)

    @classmethod
    def join(cls, *parts) -> str:
        return cls.SEPARATOR.join(parts)

    def view(self, name: str, exclusive: bool = False) -> "SimpleTelstate":
        prefix = name + self.SEPARATOR
        prefixes = (prefix,) if exclusive else (prefix,) + self._prefixes
        return SimpleTelstate(self._data, prefixes)

    def __getitem__(self, key: str):
        for prefix in self._prefixes:
            full = prefix + key
            if full in self._data:
                return self._data[full]
        raise KeyError(key)

    def get(self, key: str, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key: str) -> bool:
        return self.get(key, _MISSING) is not _MISSING


_MISSING = object()


def _timestamp_to_fits(timestamp: float) -> str:
    """UNIX time -> FITS ISO-8601 UTC string (reference
    loader_katdal.py:53-55).  Rounds to milliseconds BEFORE splitting
    integer/fraction so 0.9996 s carries into the seconds field instead
    of formatting as "1.000"."""
    ms = round(float(timestamp) * 1000.0)
    sec, frac_ms = divmod(ms, 1000)
    base = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(sec))
    return base + f".{frac_ms:03d}"


def _unique(seq) -> list:
    """Sorted unique list preserving object types (reference :33-50)."""
    out = []
    for item in sorted(seq):
        if not out or item != out[-1]:
            out.append(item)
    return out


class LoaderKatdal(loader_core.LoaderBase):
    @classmethod
    def match(cls, filename: str) -> bool:
        if filename.lower().endswith(".rdb"):
            return True
        try:
            url = urllib.parse.urlsplit(filename)
            return url.scheme == "redis" or url.path.endswith(".rdb")
        except ValueError:
            return False

    def _find_target(self, target) -> int:
        """Tag/name/index target resolution (reference :66-104)."""
        catalogue = list(self._file.catalogue)
        if not catalogue:
            raise ValueError("The file does not contain any targets")
        if target is None:
            for i, trg in enumerate(catalogue):
                if "target" in trg.tags:
                    return i
            for i, trg in enumerate(catalogue):
                if "bpcal" not in trg.tags and "gaincal" not in trg.tags:
                    return i
            return 0
        try:
            idx = int(target)
        except ValueError:
            for i, trg in enumerate(catalogue):
                if target in [trg.name, trg.description] + list(trg.aliases):
                    return i
            raise ValueError(f"Target {target} not found in catalogue")
        if idx < 0 or idx >= len(catalogue):
            raise ValueError(f"Target index {idx} is out of range")
        return idx

    def __init__(self, filename, options, start_channel=0,
                 stop_channel=None):
        super().__init__(filename, options, start_channel, stop_channel)
        parser = argparse.ArgumentParser(
            prog="katdal options",
            usage="katdal options: [-i target=NAME] ...")
        parser.add_argument("--target", type=str,
                            help="Target to image (index or name) [auto]")
        parser.add_argument("--ref-ant", type=str, default="",
                            help="Reference antenna for identifying scans")
        parser.add_argument("--apply-cal", type=str, default="all",
                            help="Calibration solutions to pre-apply")
        parser.add_argument("--rfi-mask", type=str, default="none",
                            choices=("none", "fixed", "config"),
                            help="Use RFI/band masks to skip channels")
        parser.add_argument("--access-key", type=str, help="S3 access key")
        parser.add_argument("--secret-key", type=str, help="S3 secret key")
        args = parser.parse_args(options,
                                 namespace=arguments.SmartNamespace())
        open_args = dict(ref_ant=args.ref_ant, applycal=args.apply_cal)
        if (args.access_key is None) != (args.secret_key is None):
            raise ValueError("access-key and secret-key must be used "
                             "together")
        if args.access_key is not None:
            open_args["credentials"] = (args.access_key, args.secret_key)
        self._file = open_dataset(filename, **open_args)
        self._start_channel = 0   # channel indices are file-global here
        self._spectral_window = self._file.spectral_windows[0]
        target_idx = self._find_target(args.target)
        self._file.select(targets=[target_idx], scans=["track"],
                          corrprods="cross")
        self._target = self._file.catalogue.targets[target_idx]
        logger.info("Selected target %r", self._target.description)
        if self._target.body_type != "radec":
            raise ValueError("Target does not have fixed RA/DEC")
        self._frequencies = np.asarray(self._file.freqs, np.float64)

        # Correlation products -> (baseline, pol) permutation with missing
        # products flagged (reference :152-185).
        corr_products = [(str(a), str(b)) for a, b in
                         self._file.corr_products]
        pols = _unique(a[-1] + b[-1] for a, b in corr_products)
        self._polarizations = pols
        inverse = {cp: i for i, cp in enumerate(corr_products)}
        baselines = _unique((a[:-1], b[:-1]) for a, b in corr_products
                            if a[:-1] != b[:-1])
        permutation: List[int] = []
        missing = []
        for a, b in baselines:
            for pol in pols:
                idx = inverse.get((a + pol[0], b + pol[1]))
                missing.append(idx is None)
                permutation.append(0 if idx is None else idx)
        self._corr_product_permutation = np.asarray(permutation, np.int64)
        self._missing_corr_products_mask = (
            np.asarray(missing, bool) if any(missing) else None)

        ant_inverse = {ant.name: i for i, ant in enumerate(self._file.ants)}
        try:
            self._baselines = [(ant_inverse[a], ant_inverse[b])
                               for a, b in baselines]
        except KeyError:
            raise ValueError("File does not contain antenna specifications "
                             "for all antennas")
        self._positions = np.asarray(
            [ant.position_ecef for ant in self._file.ants], np.float64)
        lat, lon, _h = ephem.ecef_to_geodetic(self._positions)
        self._ant_latlon = np.stack([lat, lon], axis=-1)
        self._ref_position = self._array_reference_position()

        # Channel mask from telstate (deviation: boolean array under
        # model_rfi_mask_<mode> instead of a katsdpmodels HTTP fetch;
        # reference :206-230).
        self._channel_mask = None
        if args.rfi_mask != "none":
            telstate = self._telstate()
            if telstate is not None:
                key = SimpleTelstate.join("model", "rfi_mask", args.rfi_mask)
                mask = telstate.get(key)
                if mask is not None:
                    self._channel_mask = np.asarray(mask, bool)
                else:
                    logger.warning("No channel mask found under %r", key)

        unparsed = arguments.unparse_args(
            args, exclude={"access_key", "secret_key"})
        self._command_line_options = []
        for arg in unparsed:
            self._command_line_options.append("-i")
            self._command_line_options.append(arg[2:])

    # -- helpers ---------------------------------------------------------

    def _telstate(self):
        source = getattr(self._file, "source", None)
        ts = getattr(source, "telstate", None)
        if isinstance(ts, dict):
            ts = SimpleTelstate(ts)
        return ts

    def _array_reference_position(self) -> np.ndarray:
        """ECEF position of the array reference (reference :197 uses the
        'Antennas/array/antenna' sensor; fall back to the mean antenna
        position)."""
        sensor = getattr(self._file, "sensor", None)
        if sensor is not None:
            try:
                ants = sensor.get("Antennas/array/antenna")
                if ants:
                    return np.asarray(ants[0].position_ecef, np.float64)
            except (KeyError, AttributeError):
                pass
        return self._positions.mean(axis=0)

    def command_line_options(self):
        return self._command_line_options

    # -- LoaderBase ------------------------------------------------------

    def antenna_diameters(self):
        return np.asarray([ant.diameter for ant in self._file.ants],
                          np.float32)

    def antenna_positions(self):
        return self._positions

    def antenna_diameter(self) -> float:
        return float(self.antenna_diameters().min())

    def longest_baseline(self) -> float:
        diffs = self._positions[:, None, :] - self._positions[None, :, :]
        return float(np.sqrt((diffs ** 2).sum(axis=-1)).max())

    def num_channels(self) -> int:
        return int(self._file.shape[1])

    def frequency(self, channel: int) -> float:
        return float(self._frequencies[channel])

    def band(self) -> Optional[str]:
        return getattr(self._spectral_window, "band", None)

    def phase_centre(self):
        ra, dec = self._target.astrometric_radec()
        return float(ra), float(dec)

    def polarizations(self):
        out_map = {"hh": polarization.STOKES_XX,
                   "hv": polarization.STOKES_XY,
                   "vh": polarization.STOKES_YX,
                   "vv": polarization.STOKES_YY}
        return [out_map[pol] for pol in self._polarizations]

    def has_feed_angles(self) -> bool:
        return True

    def weight_scale(self) -> float:
        # katdal weight-1 visibilities have E|v|^2 = 1, so each part has
        # variance 1/2 (reference :288-292).
        return math.sqrt(0.5)

    def channel_enabled(self, channel: int) -> bool:
        return (self._channel_mask is None
                or not bool(self._channel_mask[channel]))

    def data_iter(self, start_channel: int, stop_channel: int,
                  max_chunk_vis: Optional[int] = None) -> Iterator[dict]:
        n_times, n_file_chans, n_cp = self._file.shape
        assert 0 <= start_channel < stop_channel <= n_file_chans
        n_chans = stop_channel - start_channel
        n_pols = len(self._polarizations)
        n_bl = len(self._baselines)
        if max_chunk_vis is None:
            load_times = n_times
        else:
            load_times = max(1, max_chunk_vis // (n_chans * n_cp))
        timestamps = np.asarray(self._file.timestamps, np.float64)
        ra, dec = self.phase_centre()
        perm = self._corr_product_permutation
        csel = np.s_[start_channel:stop_channel]

        start = 0
        while start < n_times:
            end = min(n_times, start + load_times)
            vis = np.asarray(self._file.vis[start:end, csel, :])
            weights = np.asarray(self._file.weights[start:end, csel, :],
                                 np.float32)
            flags = np.asarray(self._file.flags[start:end, csel, :], bool)
            # permute corr products into (baseline, pol) order, flag the
            # missing ones and the masked channels, apply flags to weights
            vis = vis[:, :, perm]
            weights = weights[:, :, perm]
            flags = flags[:, :, perm]
            if self._missing_corr_products_mask is not None:
                flags |= self._missing_corr_products_mask[None, None, :]
            if self._channel_mask is not None:
                flags |= self._channel_mask[csel][None, :, None]
            weights = weights * ~flags

            # Geometry: per-antenna UVW toward the target and per-antenna
            # feed angles (parallactic angle minus pi/2: H is mapped to x,
            # reference :386-389).
            ts_chunk = timestamps[start:end]
            ant_uvw = ephem.antenna_uvw(self._positions, ra, dec, ts_chunk,
                                        ref_position=self._ref_position,
                                        apparent=True)
            ant_pa = np.stack([
                ephem.parallactic_angle(lat, lon, ra, dec, ts_chunk,
                                        apparent=True)
                for lat, lon in self._ant_latlon]) - np.pi / 2

            nt = end - start
            uvw = np.empty((n_bl, nt, 3), np.float32)
            feed_angle1 = np.empty((n_bl, nt), np.float32)
            feed_angle2 = np.empty_like(feed_angle1)
            for i, (a, b) in enumerate(self._baselines):
                uvw[i] = ant_uvw[b] - ant_uvw[a]
                feed_angle1[i] = ant_pa[a]
                feed_angle2[i] = ant_pa[b]

            def reorder(data):
                # (t, c, bl*pol) -> (c, bl*t, pol): follow baseline tracks
                # so consecutive rows move slowly in UV (reference
                # :399-406).
                data = data.reshape(nt, n_chans, n_bl, n_pols)
                data = np.moveaxis(data, 0, 2)
                return np.ascontiguousarray(
                    data.reshape(n_chans, n_bl * nt, n_pols))

            yield dict(
                uvw=uvw.reshape(-1, 3),
                weights=reorder(weights).astype(np.float32),
                vis=reorder(vis).astype(np.complex64),
                feed_angle1=feed_angle1.reshape(-1),
                feed_angle2=feed_angle2.reshape(-1),
                progress=end,
                total=n_times)
            start = end

    def observation(self):
        timestamps = np.asarray(self._file.timestamps, np.float64)
        out = {"antenna_positions": self._positions,
               "phase_centre": np.asarray(self.phase_centre())}
        if len(timestamps):
            out["time_range"] = (float(timestamps[0]), float(timestamps[-1]))
            ra, dec = self.phase_centre()
            stride = max(1, len(timestamps) // 64)
            ant_uvw = ephem.antenna_uvw(
                self._positions, ra, dec, timestamps[::stride],
                ref_position=self._ref_position,
                apparent=True)                          # (A, T, 3)
            samples = [ant_uvw[b] - ant_uvw[a] for a, b in self._baselines]
            out["uvw_samples"] = np.concatenate(samples)
        return out

    def sky_model(self):
        telstate = self._telstate()
        source = getattr(self._file, "source", None)
        if telstate is None or source is None:
            raise sky_model.NoSkyModelError(
                "Dataset does not carry a telescope state")
        return sky_model.catalogue_from_telstate(
            telstate, source.capture_block_id, None,
            self._target.description)

    def extra_fits_headers(self) -> dict:
        timestamps = np.asarray(self._file.timestamps, np.float64)
        avg = (float(np.mean(timestamps)) if len(timestamps)
               else float(self._file.start_time))
        headers = {
            "OBJECT": self._target.name,
            "SPECSYS": "TOPOCENT",
            "DATE-OBS": _timestamp_to_fits(self._file.start_time),
            "DATE-AVG": _timestamp_to_fits(avg),
            "ONTIME": (len(timestamps) * float(self._file.dump_period),
                       "[s] Time tracking the target"),
        }
        observer = getattr(self._file, "observer", None)
        if observer:
            headers["OBSERVER"] = observer
        product = getattr(self._spectral_window, "product", None)
        if product:
            headers["INSTRUME"] = product
        pos = self._ref_position
        headers["OBSGEO-X"] = float(pos[0])
        headers["OBSGEO-Y"] = float(pos[1])
        headers["OBSGEO-Z"] = float(pos[2])
        history = []
        source = getattr(self._file, "source", None)
        if getattr(source, "capture_block_id", None):
            history.append(f"Capture block id: {source.capture_block_id}")
        if getattr(source, "stream_name", None):
            history.append(f"Stream name: {source.stream_name}")
        if history:
            headers["HISTORY"] = history
        return headers

    @property
    def raw_data(self):
        return self._file

    @property
    def raw_target(self):
        return self._target

    def close(self):
        self._file = None
