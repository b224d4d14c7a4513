"""Abstract dataset interface.

API parity with the reference ``loader_core.py:14-241``.  Sign conventions
(documented there and relied on throughout): UVW is ``position2 -
position1`` in metres; visibility phase increases with time (Hamaker &
Bregman 1996); the UVW sign matches the Measurement Set definition (opposite
to CASA's actual behaviour).

``data_iter`` yields dict chunks ``{uvw (N,3 m), vis (C,N,P), weights
(C,N,P), feed_angle1 (N), feed_angle2 (N), progress, total}`` where flagged
samples carry zero weight.

The port's own copy of :mod:`katsdpimager_tpu.loader_core` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Iterator, Optional

from . import parameters


class LoaderBase(ABC):
    def __init__(self, filename: str, options, start_channel: int = 0,
                 stop_channel: Optional[int] = None):
        self.filename = filename

    @classmethod
    def match(cls, filename: str) -> bool:
        """Whether this loader can handle the file."""
        return False

    def antenna_diameters(self):
        raise NotImplementedError

    def antenna_positions(self):
        raise NotImplementedError

    @abstractmethod
    def antenna_diameter(self) -> float:
        """Effective antenna diameter in metres."""

    @abstractmethod
    def longest_baseline(self) -> float:
        """Longest baseline in metres."""

    def array_parameters(self) -> parameters.ArrayParameters:
        return parameters.ArrayParameters(self.antenna_diameter(),
                                          self.longest_baseline())

    @abstractmethod
    def num_channels(self) -> int:
        ...

    @abstractmethod
    def frequency(self, channel: int) -> float:
        """Frequency of the channel in Hz."""

    def band(self) -> Optional[str]:
        return None

    @abstractmethod
    def phase_centre(self):
        """(ra, dec) of the phase centre in radians."""

    @abstractmethod
    def polarizations(self):
        """List of CASA polarization enums present in the data."""

    def has_feed_angles(self) -> bool:
        return False

    def weight_scale(self) -> Optional[float]:
        """Scale factor from weights to inverse variance (Jy^-2), or None."""
        return None

    def channel_enabled(self, channel: int) -> bool:
        return True

    @abstractmethod
    def data_iter(self, start_channel: int, stop_channel: int,
                  max_chunk_vis: Optional[int] = None) -> Iterator[dict]:
        ...

    def observation(self) -> Optional[dict]:
        """Observation-geometry summary for QA reporting, or None.

        Optional keys (reference report.py:163-521 derives the same plots
        from katdal datasets):

        - ``uvw_samples``: (M, 3) float metres, subsampled baseline tracks
          (UV-coverage plot);
        - ``antenna_positions`` (A, 3) ECEF metres, ``phase_centre``
          (ra, dec) radians, ``time_range`` (t0, t1) UNIX seconds —
          elevation / parallactic-angle plots via :mod:`.ephem`.
        """
        return None

    def sky_model(self):
        from .sky_model import NoSkyModelError

        raise NoSkyModelError("This input format does not support sky models")

    def extra_fits_headers(self) -> dict:
        return {}

    def command_line_options(self):
        return []

    @property
    def raw_data(self):
        raise NotImplementedError

    def close(self):
        pass
