r"""Imaging-density weights: natural, uniform, robust (Briggs).

Counterpart of :mod:`katsdpimager_tpu.ops.weights`:

1. statistical weights are scatter-added onto a per-cell grid (no
   convolution); cells outside the grid are dropped;
2. robust weighting computes the mean weight :math:`\overline W =
   \sum W^2 / \sum W` over cells of the first polarization;
3. cell weights become density weights ``d = 1 / (a W + b)`` with
   ``(a, b) = (1, 0)`` for uniform and ``(S^2, 1)`` for robust where
   :math:`S^2 = (5\cdot10^{-R})^2/\overline W`; empty cells get ``d = 0``;
4. the thermal-RMS estimates returned are
   ``rms = sqrt(sum(d^2 W)) / sum(d W)`` and ``rms * sqrt(sum(W))``
   over the first polarization.

Natural weighting fills the density grid with ones and reports
``(None, 1.0)``.  The grid stays on its device; ``finalize`` reads the two
RMS values back (one sync per channel).
"""

from __future__ import annotations

import enum

import torch


class WeightType(enum.Enum):
    NATURAL = 0
    UNIFORM = 1
    ROBUST = 2


def grid_weights(weights_grid, uv, weights):
    """Scatter-add statistical weights at their (unconvolved) cells, in
    place.  weights_grid (P, N, N) f32; uv (n, 2) centred cells; weights
    (n, P).  Cells outside the grid are dropped (the JAX ``mode="drop"``).
    Returns ``weights_grid``."""
    pixels = weights_grid.shape[-1]
    half = pixels // 2
    uq = uv[:, 0].long() + half
    vq = uv[:, 1].long() + half
    keep = (uq >= 0) & (uq < pixels) & (vq >= 0) & (vq < pixels)
    w = weights.to(weights_grid.dtype)
    for p in range(weights_grid.shape[0]):
        weights_grid[p].index_put_((vq[keep], uq[keep]), w[keep, p],
                                   accumulate=True)
    return weights_grid


def mean_weight(weights_grid):
    """Briggs eq 3.17 over the first polarization (a 0-d tensor)."""
    w = weights_grid[0]
    return (w * w).sum() / w.sum()


def density_weights(weights_grid, a, b):
    """``W -> 1/(aW + b)`` (0 for empty cells) plus the RMS sums.
    Returns (new grid, rms, normalized_rms), the last two 0-d tensors."""
    w0 = weights_grid[0]
    pos = weights_grid > 0
    d = torch.where(pos, 1.0 / torch.where(pos, a * weights_grid + b, 1.0),
                    0.0)
    d0 = d[0]
    sum_w = w0.sum()
    sum_dw = (d0 * w0).sum()
    sum_d2w = (d0 * d0 * w0).sum()
    rms = torch.sqrt(sum_d2w) / sum_dw
    return d, rms, rms * torch.sqrt(sum_w)


class Weights:
    """Per-channel weight computation, holding the density grid as a
    (P, N, N) f32 tensor on ``device``."""

    def __init__(self, weight_type: WeightType, num_polarizations: int,
                 pixels: int, robustness: float = 0.0, device="cpu"):
        self.weight_type = weight_type
        self.robustness = robustness
        self.pixels = pixels
        self.grid = torch.zeros((num_polarizations, pixels, pixels),
                                dtype=torch.float32, device=device)

    def clear(self):
        if self.weight_type != WeightType.NATURAL:
            self.grid.zero_()

    def accumulate(self, uv, weights):
        """Add a block of (n, 2) cells and (n, P) weights (tensors or
        numpy arrays)."""
        if self.weight_type != WeightType.NATURAL:
            dev = self.grid.device
            grid_weights(self.grid, torch.as_tensor(uv, device=dev),
                         torch.as_tensor(weights, device=dev))

    def finalize(self):
        """Convert summed weights to density weights; returns
        ``(rms, normalized_rms)``."""
        if self.weight_type == WeightType.NATURAL:
            self.grid = torch.ones_like(self.grid)
            return None, 1.0
        if self.weight_type == WeightType.ROBUST:
            s2 = (5.0 * 10.0 ** (-self.robustness)) ** 2 / mean_weight(
                self.grid)
            self.grid, rms, norm = density_weights(self.grid, s2, 1.0)
        else:  # UNIFORM
            self.grid, rms, norm = density_weights(self.grid, 1.0, 0.0)
        return float(rms), float(norm)
