r"""Convolutional gridding and degridding by scatter and gather.

Counterpart of :mod:`katsdpimager_tpu.ops.gridder`, whose XLA scatter is
no Pallas kernel, so this is plain PyTorch on any device: for each kernel
tap row ``j``, every visibility scatters a ``kernel_width``-wide row of
weighted kernel values with one ``index_put_(..., accumulate=True)``;
degridding is the transposed gather, contracted against the separable
taps.  It backs :meth:`..imaging.Imaging.grid_chunk` and
:meth:`~..imaging.Imaging.degrid_chunk`; the fused gridder (K1, K2) and
degridder (K5) are the fast paths.

Conventions (those of the JAX module):

- ``uv`` is centred (0 = grid centre); the first grid index of the kernel
  footprint is ``uv - uv_bias`` with ``uv_bias = (K-1)//2 - pixels//2``;
- gridding multiplies by the *conjugate* of the separable kernel value
  ``kernel[w_plane, sub_v, j] * kernel[w_plane, sub_u, k]``; degridding
  uses the unconjugated value;
- the imaging (density) weight is looked up at the visibility's cell
  ``(uv + pixels//2)`` and multiplied into the visibility before gridding;
  degridding subtracts ``weights * predicted`` from the stored
  visibilities.

Footprint cells outside the grid are dropped (the JAX scatter drops cells
past the edge but wraps negative indices; preprocessing makes neither).
"""

from __future__ import annotations

import numpy as np
import torch


def _footprint(kernel, uv, sub_uv, w_plane, pixels: int):
    """(u0, v0, ku, kv, cols): the first footprint row and column of each
    visibility, its (N, K) u and v taps and its (N, K) footprint
    columns."""
    K = kernel.shape[-1]
    uv_bias = (K - 1) // 2 - pixels // 2
    u0 = uv[:, 0].long() - uv_bias
    v0 = uv[:, 1].long() - uv_bias
    wp = w_plane.long()
    ku = kernel[wp, sub_uv[:, 0].long(), :]
    kv = kernel[wp, sub_uv[:, 1].long(), :]
    cols = u0[:, None] + torch.arange(K, device=uv.device)[None, :]
    return u0, v0, ku, kv, cols


def grid_vis(grid, kernel, weights_grid, uv, sub_uv, w_plane, vis, *,
                  pixels: int):
    """Accumulate visibilities onto the UV grid, in place.

    grid (P, pixels, pixels) complex; kernel (w_planes, oversample, K)
    complex64; weights_grid (P, pixels, pixels) float32 imaging-density
    weights; uv, sub_uv (N, 2) and w_plane (N,) integer; vis (N, P)
    complex, statistically weighted (padding entries must be zero).
    Returns ``grid``; a caller that keeps the old grid passes a clone."""
    K = kernel.shape[-1]
    half = pixels // 2
    _, v0, ku, kv, cols = _footprint(kernel, uv, sub_uv, w_plane, pixels)
    uq = uv[:, 0].long() + half
    vq = uv[:, 1].long() + half
    sample = vis.transpose(0, 1).to(grid.dtype) * weights_grid[:, vq, uq]
    ku_conj = ku.conj()
    col_ok = (cols >= 0) & (cols < pixels)
    cols_c = cols.clamp(0, pixels - 1)
    for j in range(K):
        rows = (v0 + j)[:, None].expand_as(cols)
        keep = col_ok & (rows >= 0) & (rows < pixels)
        rows_c = rows.clamp(0, pixels - 1)
        vals = (sample[:, :, None] * kv[:, j].conj()[None, :, None]
                * ku_conj[None, :, :])                       # (P, N, K)
        vals = torch.where(keep[None], vals, 0)
        for p in range(grid.shape[0]):
            grid[p].index_put_((rows_c, cols_c), vals[p].to(grid.dtype),
                               accumulate=True)
    return grid


def degrid_vis(grid, kernel, uv, sub_uv, w_plane, weights, vis, *,
                    pixels: int):
    """``vis - weights * predicted``: the visibilities less the weighted
    prediction from the (P, pixels, pixels) complex ``grid``.  Padding
    entries (zero weights) are unaffected.  Footprints must lie inside
    the grid."""
    K = kernel.shape[-1]
    _, v0, ku, kv, cols = _footprint(kernel, uv, sub_uv, w_plane, pixels)
    P = vis.shape[1]
    acc = torch.zeros((vis.shape[0], P), dtype=grid.dtype, device=vis.device)
    ku = ku.to(grid.dtype)
    kv = kv.to(grid.dtype)
    for j in range(K):
        rows = grid[:, (v0 + j)[:, None], cols]                # (P, N, K)
        acc = acc + torch.einsum("pnk,nk->np", rows, ku) * kv[:, j][:, None]
    return vis - weights * acc.to(vis.dtype)


def grid_vis_reference(grid, kernel, weights_grid, uv, sub_uv, w_plane, vis):
    """Slow numpy oracle for the tests: every footprint cell of every
    visibility in a Python loop."""
    K = kernel.shape[-1]
    pixels = grid.shape[-1]
    uv_bias = (K - 1) // 2 - pixels // 2
    for row in range(len(uv)):
        u0 = int(uv[row, 0]) - uv_bias
        v0 = int(uv[row, 1]) - uv_bias
        sub_u, sub_v = int(sub_uv[row, 0]), int(sub_uv[row, 1])
        uq = int(uv[row, 0]) + pixels // 2
        vq = int(uv[row, 1]) + pixels // 2
        sample = vis[row] * weights_grid[:, vq, uq]
        for j in range(K):
            for k in range(K):
                ks = (kernel[w_plane[row], sub_v, j]
                      * kernel[w_plane[row], sub_u, k])
                grid[:, v0 + j, u0 + k] += sample * np.conj(ks)
    return grid


def degrid_vis_reference(grid, kernel, uv, sub_uv, w_plane, weights, vis):
    """Slow numpy oracle for the tests (the transposed loop)."""
    K = kernel.shape[-1]
    pixels = grid.shape[-1]
    uv_bias = (K - 1) // 2 - pixels // 2
    out = vis.copy()
    for row in range(len(uv)):
        u0 = int(uv[row, 0]) - uv_bias
        v0 = int(uv[row, 1]) - uv_bias
        sub_u, sub_v = int(sub_uv[row, 0]), int(sub_uv[row, 1])
        sample = np.zeros(vis.shape[1], grid.dtype)
        for j in range(K):
            for k in range(K):
                wgt = (kernel[w_plane[row], sub_v, j]
                       * kernel[w_plane[row], sub_u, k])
                sample += wgt * grid[:, v0 + j, u0 + k]
        out[row] -= weights[row] * sample
    return out
