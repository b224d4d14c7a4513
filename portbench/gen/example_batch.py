"""The production batch's random visibilities, drawn from a seed.

A frozen copy of the draws of
``katsdpimager_tpu_torch.parallel.multichannel.make_example_batch``: the
same generator, the same draws in the same order, and the same rule that
halves the number of visibilities of a (channel, slice) and draws again
when the planner cannot pack them.  Given the same packing, it yields
exactly the visibilities that function grids; the copy lives here so that
a change to the program cannot move the benchmark's inputs.

Each (channel, W slice) gets ``M`` visibilities: a UV cell clustered
around the grid centre (normal, sigma a third of the usable half-width,
clipped to it), a sub-cell position, a W plane of the slice, complex
values per polarisation (standard normal parts) and statistical weights
in [0.5, 2).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


class SliceDraws(NamedTuple):
    """One (channel, W slice)'s visibilities, as the planner takes them."""

    uv: np.ndarray       # (M, 2) int16, centred UV cell (u, v)
    sub_uv: np.ndarray   # (M, 2) int16, sub-cell position in [0, O)
    w_plane: np.ndarray  # (M,) int16, W plane in [0, w_planes)
    vis: np.ndarray      # (M, P) complex64
    weights: np.ndarray  # (M, P) float32


def draw_slices(seed: int, *, channels: int, w_slices: int, pixels: int,
                kernel_width: int, oversample: int, w_planes: int,
                num_pols: int, vis_per_slice: int,
                pack: Callable[[int, int, SliceDraws], None]) -> list:
    """Draw every (channel, slice)'s visibilities in ``make_example_batch``'s
    order and hand each to ``pack(c, s, draws)``.  Where ``pack`` raises
    :class:`ValueError` (the layout cannot hold them), the number of
    visibilities is halved, for this and every later slice, and the slice
    is drawn again.  Returns the accepted draws, ``[c][s]``."""
    rng = np.random.default_rng(seed)
    lim = pixels // 2 - kernel_width - 1
    m = vis_per_slice
    out = []
    for c in range(channels):
        row = []
        for s in range(w_slices):
            while True:
                uv = np.clip(rng.normal(scale=lim / 3, size=(m, 2)),
                             -lim, lim).astype(np.int16)
                sub = rng.integers(0, oversample, size=(m, 2)).astype(
                    np.int16)
                wp = rng.integers(0, w_planes, size=m).astype(np.int16)
                vis = (rng.normal(size=(m, num_pols))
                       + 1j * rng.normal(size=(m, num_pols))).astype(
                           np.complex64)
                wt = rng.uniform(0.5, 2.0, size=(m, num_pols)).astype(
                    np.float32)
                draws = SliceDraws(uv, sub, wp, vis, wt)
                try:
                    pack(c, s, draws)
                    break
                except ValueError:
                    m //= 2
                    if m == 0:
                        raise
            row.append(draws)
        out.append(row)
    return out


def channel_frequencies(channels: int, base_frequency: float,
                        step: float) -> np.ndarray:
    """Channel c's frequency, ``base * (1 + step * c)`` in Hz."""
    return base_frequency * (1 + step * np.arange(channels))
