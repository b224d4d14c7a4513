"""Native HDF5 visibility dataset.

This framework's own simple interchange format (``.vis.h5``), produced by
:mod:`.simulate` and usable for converted data.  Layout:

- ``uvw``: (N, 3) float32, metres (position2 - position1)
- ``vis``: (C, N, Q) complex64
- ``weights``: (C, N, Q) float32 (optional; ones if absent)
- ``frequencies``: (C,) float64 Hz
- ``feed_angle1``/``feed_angle2``: (N,) float32 radians (optional)
- attrs: ``phase_centre`` = [ra, dec] radians, ``antenna_diameter`` m,
  ``longest_baseline`` m, ``polarizations`` = CASA enum codes,
  ``weight_scale`` (optional), ``band`` (optional)

The reference has no equivalent (it reads Measurement Sets and katdal); this
format exists because python-casacore is not available in this environment
and gives tests/benchmarks a fully controlled input path.

The port's own copy of :mod:`katsdpimager_tpu.loader_hdf5` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from . import loader_core


class LoaderHDF5(loader_core.LoaderBase):
    @classmethod
    def match(cls, filename: str) -> bool:
        return filename.endswith(".h5") or filename.endswith(".hdf5")

    def __init__(self, filename, options, start_channel=0, stop_channel=None):
        super().__init__(filename, options, start_channel, stop_channel)
        import h5py

        self._file = h5py.File(filename, "r")
        self._uvw = self._file["uvw"]
        self._vis = self._file["vis"]
        self._weights = self._file.get("weights")
        self._freqs = np.asarray(self._file["frequencies"])
        self._attrs = dict(self._file.attrs)

    def antenna_diameter(self) -> float:
        return float(self._attrs["antenna_diameter"])

    def longest_baseline(self) -> float:
        return float(self._attrs["longest_baseline"])

    def num_channels(self) -> int:
        return len(self._freqs)

    def frequency(self, channel: int) -> float:
        return float(self._freqs[channel])

    def band(self):
        return self._attrs.get("band")

    def phase_centre(self):
        pc = self._attrs["phase_centre"]
        return float(pc[0]), float(pc[1])

    def polarizations(self):
        return [int(p) for p in self._attrs["polarizations"]]

    def has_feed_angles(self) -> bool:
        return "feed_angle1" in self._file

    def weight_scale(self):
        ws = self._attrs.get("weight_scale")
        return None if ws is None else float(ws)

    def channel_enabled(self, channel: int) -> bool:
        mask = self._attrs.get("channel_mask")
        if mask is None:
            return True
        return bool(np.asarray(mask)[channel])

    def data_iter(self, start_channel: int, stop_channel: int,
                  max_chunk_vis: Optional[int] = None) -> Iterator[dict]:
        total = self._uvw.shape[0]
        C = stop_channel - start_channel
        step = total if max_chunk_vis is None else max(1, max_chunk_vis // max(C, 1))
        for start in range(0, total, step):
            stop = min(total, start + step)
            chunk = {
                "uvw": np.asarray(self._uvw[start:stop], np.float32),
                "vis": np.asarray(self._vis[start_channel:stop_channel, start:stop]),
                "progress": stop,
                "total": total,
            }
            if self._weights is not None:
                chunk["weights"] = np.asarray(
                    self._weights[start_channel:stop_channel, start:stop])
            else:
                chunk["weights"] = np.ones(chunk["vis"].shape, np.float32)
            if self.has_feed_angles():
                chunk["feed_angle1"] = np.asarray(self._file["feed_angle1"][start:stop])
                chunk["feed_angle2"] = np.asarray(self._file["feed_angle2"][start:stop])
            yield chunk

    def observation(self):
        n = self._uvw.shape[0]
        if n == 0:
            return None
        stride = max(1, n // 20000)
        return {"uvw_samples": np.asarray(self._uvw[::stride],
                                          np.float64)}

    def extra_fits_headers(self):
        return {"TELESCOP": self._attrs.get("telescope", "simulated")}

    @property
    def raw_data(self):
        return self._file

    def close(self):
        self._file.close()
