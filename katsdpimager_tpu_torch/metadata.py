"""Archive metadata for pipeline products (parity with reference
``metadata.py``: the MeerKAT archive ``metadata.json`` fields, minus the
katdal-specific observation introspection which is gated on that loader).

The port's own copy of :mod:`katsdpimager_tpu.metadata` (host code, no
kernel); the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import time
from typing import List, Optional

from . import __version__


def format_timestamp(t: Optional[float] = None) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


def make_metadata(dataset, image_parameters, channels: List[int],
                  product_type: str = "spectral_image") -> dict:
    """Build the metadata dictionary for a set of imaged channels."""
    ra, dec = dataset.phase_centre()
    freqs = [dataset.frequency(ch) for ch in channels]
    return {
        "ProductType": {
            "ProductTypeName": "FITSImageProduct",
            "ReductionName": product_type,
        },
        "CaptureBlockId": getattr(dataset, "capture_block_id", lambda: None)(),
        "Description": f"TPU spectral-line image ({len(channels)} channels)",
        "ProposalId": None,
        "Observer": None,
        "StartTime": format_timestamp(),
        "RightAscension": math.degrees(ra),
        "Declination": math.degrees(dec),
        "MinFreq": min(freqs) if freqs else None,
        "MaxFreq": max(freqs) if freqs else None,
        "Channels": list(channels),
        "ImagerVersion": __version__,
    }


def write_metadata(path: str, metadata: dict) -> None:
    with open(path, "w") as f:
        json.dump(metadata, f, indent=2)
