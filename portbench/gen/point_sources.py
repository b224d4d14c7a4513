"""Bright point sources for CLEAN to find, drawn from a seed.

A frozen copy of the draws of
``katsdpimager_tpu_torch.parallel.cube.with_point_sources``:
:data:`NUM_SOURCES` positions inside the central half of the image, at
least ``2 * patch`` pixels apart (Chebyshev distance), and each source's
flux in units of the channel's expected dirty-image RMS, uniform in
:data:`SNR`.  The visibilities they add are the caller's to predict.
"""

from __future__ import annotations

import numpy as np

NUM_SOURCES = 5
SNR = (10.0, 100.0)


def draw(seed: int, *, pixels: int, patch: int):
    """(positions (S, 2) int [y, x], flux ratios (S,))."""
    rng = np.random.default_rng(seed)
    sep = 2 * patch
    lo, hi = pixels // 4, pixels - pixels // 4
    positions: list = []
    while len(positions) < NUM_SOURCES:
        y, x = (int(v) for v in rng.integers(lo, hi, size=2))
        if all(max(abs(y - py), abs(x - px)) >= sep for py, px in positions):
            positions.append((y, x))
    ratios = rng.uniform(*SNR, size=NUM_SOURCES)
    return np.array(positions), ratios


def dirty_rms(vis: np.ndarray, weights: np.ndarray) -> float:
    """The expected RMS of the PSF-normalised natural-weight dirty image
    of noise visibilities: sqrt(sum |vis|^2 / 2) / sum(weights)."""
    return float(np.sqrt((np.abs(vis.astype(np.complex128)) ** 2).sum() / 2)
                 / weights.astype(np.float64).sum())
