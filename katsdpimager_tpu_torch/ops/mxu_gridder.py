"""Host-side chunk planning and the gridder dispatch.

Counterpart of the host half of :mod:`katsdpimager_tpu.ops.mxu_gridder`
(numpy, no JAX): the tile-aligned chunk plan that both packages grid from
(the layout is bit-identical, so one batch feeds both), the padded grid
extent, :func:`grid_chunks_parts` (a slice to fresh grid planes) and
:func:`grid_chunks_onto` (onto a running grid), which split a call into
polarization groups that fit the accumulator cap and run the fused
gridder (:mod:`.fused_gridder`, kernels K1 and K2) on each, the fused
degridder's dispatch, and the per-channel path's :class:`MxuGridder`.

Visibilities are sorted by UV tile and cut into chunks of at most ``mc``
visibilities that share one tile anchor (a multiple of ``ts``), so every
chunk's kernel footprints fit the ``2 ts`` square window at its anchor,
and the chunks of one anchor form one consecutive run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .. import native


class ChunkPlan(NamedTuple):
    """Static-shape chunked visibility layout (numpy, host-resident).

    All per-vis arrays are gathered into ``(n_chunks, Mc)`` layout; padding
    entries have ``valid == False`` and zeroed payloads.
    """

    uv: np.ndarray         # (C, Mc, 2) int32 centred cell coords
    sub_uv: np.ndarray     # (C, Mc, 2) int32
    w_plane: np.ndarray    # (C, Mc) int32
    vis: np.ndarray        # (C, Mc, P) complex64 (pre-weighted)
    weights: np.ndarray    # (C, Mc, P) float32
    anchor: np.ndarray     # (C, 2) int32: (v_row0, u_col0) of the window
    valid: np.ndarray      # (C, Mc) bool
    row_chunk: np.ndarray  # (Nvis,) chunk index of each ORIGINAL input row
    row_slot: np.ndarray   # (Nvis,) slot within that chunk


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def plan_chunks_tiled_coords(uv, *, pixels: int, kernel_width: int,
                             ts: int = 64, mc: int = 256) -> dict:
    """Tile-aligned chunk assignment from coordinates alone.

    Returns a dict: ``order`` (sorted permutation), ``chunk_of``/
    ``slot_of`` (per SORTED position), ``row_chunk``/``row_slot`` (per
    ORIGINAL row), ``anchor`` (n_padded, 2), ``valid`` (n_padded, mc),
    ``n_chunks``, ``n_padded`` (the chunk count rounded up to a power of
    two).
    """
    K = kernel_width
    if K > ts:
        raise ValueError(f"tile size {ts} must cover the kernel width {K}")
    n = len(uv)
    uv_bias = (K - 1) // 2 - pixels // 2
    if n == 0:
        return dict(order=np.zeros(0, np.int64),
                    chunk_of=np.zeros(0, np.int64),
                    slot_of=np.zeros(0, np.int64),
                    row_chunk=np.zeros(0, np.int64),
                    row_slot=np.zeros(0, np.int64),
                    anchor=np.zeros((0, 2), np.int32),
                    valid=np.zeros((0, mc), bool),
                    n_chunks=0, n_padded=0)

    u0 = uv[:, 0].astype(np.int64) - uv_bias
    v0 = uv[:, 1].astype(np.int64) - uv_bias
    tv = v0 // ts
    tu = u0 // ts
    ntu = -(-pixels // ts) + 1
    key = tv * ntu + tu
    # numpy's stable integer sort is a radix sort whose pass count grows
    # with the dtype width: narrow the key to the range it spans.
    key_max = (ntu - 1) * ntu + ntu - 1
    if key_max < np.iinfo(np.int16).max:
        key = key.astype(np.int16)
    elif key_max < np.iinfo(np.int32).max:
        key = key.astype(np.int32)
    order = np.argsort(key, kind="stable")
    key_s = key[order]

    # group boundaries per tile; chunks of <= mc within each tile
    starts = np.concatenate([[0], 1 + np.nonzero(np.diff(key_s))[0]])
    counts = np.diff(np.concatenate([starts, [n]]))
    chunks_per_tile = -(-counts // mc)
    chunk_base = np.concatenate([[0], np.cumsum(chunks_per_tile)])
    n_chunks = int(chunk_base[-1])
    n_padded = _pow2_at_least(n_chunks)

    local = np.arange(n) - np.repeat(starts, counts)
    group_of = np.repeat(np.arange(len(counts)), counts)
    chunk_of = chunk_base[group_of] + local // mc
    slot_of = local % mc

    anchor = np.zeros((n_padded, 2), np.int32)
    valid = np.zeros((n_padded, mc), bool)
    valid[chunk_of, slot_of] = True
    anchor[chunk_of, 0] = (tv[order] * ts).astype(np.int32)
    anchor[chunk_of, 1] = (tu[order] * ts).astype(np.int32)

    row_chunk = np.empty(n, np.int64)
    row_slot = np.empty(n, np.int64)
    row_chunk[order] = chunk_of
    row_slot[order] = slot_of
    return dict(order=order, chunk_of=chunk_of, slot_of=slot_of,
                row_chunk=row_chunk, row_slot=row_slot, anchor=anchor,
                valid=valid, n_chunks=n_chunks, n_padded=n_padded)


def plan_chunks_tiled_count(uv, *, pixels: int, kernel_width: int,
                            ts: int = 64, mc: int = 256) -> int:
    """Number of chunks :func:`plan_chunks_tiled_coords` would produce
    (a bincount over tile keys: no sort)."""
    n = len(uv)
    if n == 0:
        return 0
    K = kernel_width
    uv_bias = (K - 1) // 2 - pixels // 2
    tv = (uv[:, 1].astype(np.int64) - uv_bias) // ts
    tu = (uv[:, 0].astype(np.int64) - uv_bias) // ts
    ntu = -(-pixels // ts) + 1
    counts = np.bincount(tv * ntu + tu)
    return int(np.sum(-(-counts[counts > 0] // mc)))


def plan_chunks_tiled(uv, sub_uv, w_plane, vis, weights, *, pixels: int,
                      kernel_width: int, ts: int = 64,
                      mc: int = 256) -> ChunkPlan:
    """Tile-aligned chunk plan.  Anchors are multiples of ``ts``.

    Uses the JAX package's native counting-sort packer when it builds
    (its layout is bitwise identical to the numpy planner's), as the JAX
    planner does.
    """
    n = len(uv)
    P = vis.shape[1]
    if n == 0:
        zero = np.zeros
        return ChunkPlan(zero((0, mc, 2), np.int32), zero((0, mc, 2), np.int32),
                         zero((0, mc), np.int32), zero((0, mc, P), np.complex64),
                         zero((0, mc, P), np.float32), zero((0, 2), np.int32),
                         zero((0, mc), bool), zero((0,), np.int32),
                         zero((0,), np.int32))

    if native.available():
        n_padded = _pow2_at_least(plan_chunks_tiled_count(
            uv, pixels=pixels, kernel_width=kernel_width, ts=ts, mc=mc))
        c_uv = np.zeros((n_padded, mc, 2), np.int32)
        c_sub = np.zeros((n_padded, mc, 2), np.int32)
        c_wp = np.zeros((n_padded, mc), np.int32)
        anchor = np.zeros((n_padded, 2), np.int32)
        valid = np.zeros((n_padded, mc), bool)
        _, row_chunk, row_slot = native.pack_slice_coords(
            uv, sub_uv, w_plane, pixels=pixels, kernel_width=kernel_width,
            ts=ts, mc=mc, out_uv=c_uv, out_sub=c_sub, out_wp=c_wp,
            out_anchor=anchor, out_valid=valid)
        c_vis = np.zeros((n_padded, mc, P), np.complex64)
        c_wt = np.zeros((n_padded, mc, P), np.float32)
        native.place_payload(row_chunk, row_slot,
                             np.ascontiguousarray(weights, np.float32),
                             np.ascontiguousarray(vis, np.complex64),
                             c_wt, c_vis)
        return ChunkPlan(c_uv, c_sub, c_wp, c_vis, c_wt, anchor, valid,
                         row_chunk, row_slot)

    asg = plan_chunks_tiled_coords(uv, pixels=pixels,
                                   kernel_width=kernel_width, ts=ts, mc=mc)
    order, chunk_of, slot_of = asg["order"], asg["chunk_of"], asg["slot_of"]
    n_padded = asg["n_padded"]

    c_uv = np.zeros((n_padded, mc, 2), np.int32)
    c_sub = np.zeros((n_padded, mc, 2), np.int32)
    c_wp = np.zeros((n_padded, mc), np.int32)
    c_vis = np.zeros((n_padded, mc, P), np.complex64)
    c_wt = np.zeros((n_padded, mc, P), np.float32)
    c_uv[chunk_of, slot_of] = uv[order]
    c_sub[chunk_of, slot_of] = sub_uv[order]
    c_wp[chunk_of, slot_of] = w_plane[order]
    c_vis[chunk_of, slot_of] = vis[order]
    c_wt[chunk_of, slot_of] = weights[order]
    return ChunkPlan(c_uv, c_sub, c_wp, c_vis, c_wt, asg["anchor"],
                     asg["valid"], asg["row_chunk"].astype(np.int32),
                     asg["row_slot"].astype(np.int32))


def colour_tiles(pixels: int, ts: int) -> int:
    """``nt2``: tiles per side of one colour plane of the fused gridder."""
    ntv = -(-pixels // ts) + 1
    return -(-ntv // 2) + 1


def dense_pad_size(pixels: int, ts: int) -> int:
    """Padded grid extent that every anchor's ``2 ts`` window fits in."""
    return ts + colour_tiles(pixels, ts) * 2 * ts


def occupied_chunks(valid: torch.Tensor) -> int:
    """Number of occupied chunks of an occupied-first (NC, Mc) valid mask
    (synchronises with the device when ``valid`` lies on one)."""
    return int(valid.any(dim=-1).sum())


#: Visibilities per chunk of the per-channel plans (the JAX ``Mc``).
CHUNK_SIZE = 256

#: Cap on the fused gridder's colour-plane accumulators, in GB (the JAX
#: package's ``KTPU_PALLAS_MAX_ACC_GB`` default).
MAX_ACC_GB = 5.0


def pol_groups(num_pols: int, pixels: int, ts: int,
               max_acc_gb: float = MAX_ACC_GB) -> list[tuple[int, int]]:
    """Split polarizations into groups whose colour-plane accumulators
    (four re/im planes of ``ext2**2`` f32 per polarization) fit
    ``max_acc_gb``.  Returns ``[(start, stop), ...]``; raises when one
    polarization alone does not fit."""
    ext2 = colour_tiles(pixels, ts) * 2 * ts
    per_pol_gb = 4 * ext2 * ext2 * 4 * 2 / 1e9
    if per_pol_gb * num_pols <= max_acc_gb:
        return [(0, num_pols)]
    if per_pol_gb > max_acc_gb:
        raise ValueError(
            f"one polarization's accumulators need {per_pol_gb:.2f} GB "
            f"> cap {max_acc_gb} GB")
    pg = max(1, int(max_acc_gb / per_pol_gb))
    return [(p, min(p + pg, num_pols)) for p in range(0, num_pols, pg)]


def grid_chunks_parts(kernel, weights_grid, plan_uv, plan_sub, plan_wp,
                      plan_vis, plan_anchor, plan_valid, dw_chunks=None,
                      n_chunks=None, *, pixels: int, ts: int,
                      max_acc_gb: float = MAX_ACC_GB, plain: bool = False):
    """Grid one slice's chunks straight to cropped (P, N, N) f32
    ``(gr, gi)`` planes (the FFT's input layout), zero base grid.

    Counterpart of ``mxu_gridder.grid_chunks_parts_impl(...,
    assembly="pallas")``.  Kernels wider than ``ts + 1`` have no kernel
    (the JAX package falls back to an XLA assembly there): they raise.
    ``plain`` runs the kernels' plain versions whatever the device.
    """
    from .fused_gridder import grid_chunks_fused_parts

    K = kernel.shape[-1]
    if K + ts - 1 > 2 * ts:
        raise NotImplementedError(
            f"kernel width {K} > ts + 1 = {ts + 1}: the fused gridder's "
            "2-tile window cannot hold it, and no other gridder is ported")
    groups = pol_groups(plan_vis.shape[-1], pixels, ts, max_acc_gb)
    if n_chunks is None:
        n_chunks = occupied_chunks(plan_valid)
    outs = [grid_chunks_fused_parts(
        kernel, None if weights_grid is None else weights_grid[p0:p1],
        plan_uv, plan_sub, plan_wp, plan_vis[..., p0:p1], plan_anchor,
        plan_valid, None if dw_chunks is None else dw_chunks[..., p0:p1],
        n_chunks, pixels=pixels, ts=ts, plain=plain) for p0, p1 in groups]
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def degrid_chunks_parts(grid, kernel, plan_uv, plan_sub, plan_wp, plan_wt,
                        plan_vis, plan_anchor, plan_valid, n_chunks=None, *,
                        pixels: int, rv: int, ru: int, plain: bool = False):
    """Predict and subtract: one slice's visibilities less the weighted
    model prediction, ``vis - wt * (pred * valid)`` (NC, Mc, P).

    ``grid`` is the (P, N, N) f32 ``(gr, gi)`` pair of grid planes
    (:func:`..fourier.image_to_grid_parts`).  Counterpart of
    ``mxu_gridder.degrid_chunks_impl(..., assembly="pallas",
    tile_aligned=True)`` (tile-aligned plans, :func:`plan_chunks_tiled`):
    the fused degridder, kernel K5 (:mod:`.fused_degrid`).  Where the
    JAX package falls back to an XLA assembly (``rv != ru``, or a kernel
    wider than ``rv + 1``) this raises.  ``n_chunks`` (host int) bounds
    the chunks predicted; None counts the occupied chunks (a device
    sync).  Padding chunks pass their visibilities through unchanged.
    ``plain`` runs K5's plain version whatever the device."""
    from .fused_degrid import degrid_chunks_fused

    K = kernel.shape[-1]
    if rv != ru or K + rv - 1 > 2 * rv:
        raise NotImplementedError(
            f"the fused degridder takes rv == ru and K <= rv + 1, not "
            f"rv={rv}, ru={ru}, K={K}; no other degridder is ported")
    if n_chunks is None:
        n_chunks = occupied_chunks(plan_valid)
    gr, gi = grid
    pred = degrid_chunks_fused(gr, gi, kernel, plan_uv, plan_sub, plan_wp,
                               plan_anchor, n_chunks, pixels=pixels, ts=rv,
                               plain=plain)
    pred = torch.where(plan_valid[..., None], pred, 0)
    return plan_vis - plan_wt * pred


def grid_chunks_onto(grid, kernel, weights_grid, plan_uv, plan_sub, plan_wp,
                     plan_vis, plan_anchor, plan_valid, dw_chunks=None,
                     n_chunks=None, *, pixels: int, ts: int,
                     max_acc_gb: float = MAX_ACC_GB, plain: bool = False):
    """Grid one slice's chunks ONTO a running grid, in place: ``grid`` is
    the ``(gr, gi)`` pair of (P, N, N) f32 planes; returns it.

    Counterpart of the JAX ``grid_chunks_fused`` (the fused gridder onto
    the padded complex working grid): K1 fills the colour planes, then
    K2's accumulating form adds them onto the grid in the JAX order
    ``(((g + p00) + p01) + p10) + p11``, select-masked.  Polarizations
    run in groups that fit the accumulator cap (:func:`pol_groups`).
    ``plain`` runs both kernels' plain versions whatever the device."""
    from .fused_gridder import (combine_planes, combine_planes_plain,
                                grid_chunks_planes)

    K = kernel.shape[-1]
    if K + ts - 1 > 2 * ts:
        raise NotImplementedError(
            f"kernel width {K} > ts + 1 = {ts + 1}: the fused gridder's "
            "2-tile window cannot hold it, and no other gridder is ported")
    if n_chunks is None:
        n_chunks = occupied_chunks(plan_valid)
    gr, gi = grid
    k2 = combine_planes_plain if plain else combine_planes
    for p0, p1 in pol_groups(plan_vis.shape[-1], pixels, ts, max_acc_gb):
        accr, acci, occ = grid_chunks_planes(
            kernel, None if weights_grid is None else weights_grid[p0:p1],
            plan_uv, plan_sub, plan_wp, plan_vis[..., p0:p1], plan_anchor,
            plan_valid, None if dw_chunks is None else dw_chunks[..., p0:p1],
            n_chunks, pixels=pixels, ts=ts, plain=plain)
        k2(accr, acci, occ, pixels=pixels, ts=ts, out=(gr[p0:p1], gi[p0:p1]))
    return grid


def tile_size(pixels: int, kernel_width: int) -> int:
    """The per-channel path's square tile size: ``max(min(64, max(8,
    N // 8)), K)`` (the JAX ``Imaging`` window, raised to cover the
    kernel as its dense mode does).  64 at 4096 px with K = 60, 32 at
    256 px with K = 16; K1 takes 32 and 64, K5 up to 80."""
    return max(min(64, max(8, pixels // 8)), kernel_width)


class MxuGridder:
    """Plan on the host, grid and degrid on the device (dense mode).

    Counterpart of :class:`katsdpimager_tpu.ops.mxu_gridder.MxuGridder`
    for a (channel, w_slice) visibility set whose coordinates are fixed
    across major cycles.  Plans are the tile-aligned layout of
    :func:`plan_chunks_tiled` at the tile size of :func:`tile_size`;
    :meth:`upload_plan` moves one to ``device`` once (None: the CUDA
    device, which must exist).  ``plain`` runs every kernel's plain
    version whatever the device."""

    def __init__(self, *, pixels: int, kernel_width: int, device=None,
                 plain: bool = False):
        self.pixels = pixels
        self.K = kernel_width
        self.ts = tile_size(pixels, kernel_width)
        self.device = device_mod.resolve(device)
        self.plain = plain

    def plan(self, uv, sub_uv, w_plane, vis, weights) -> ChunkPlan:
        """The host plan of one block of visibilities (numpy)."""
        return plan_chunks_tiled(
            np.asarray(uv), np.asarray(sub_uv), np.asarray(w_plane),
            np.asarray(vis), np.asarray(weights), pixels=self.pixels,
            kernel_width=self.K, ts=self.ts, mc=CHUNK_SIZE)

    def upload_plan(self, plan: ChunkPlan) -> ChunkPlan:
        """The plan's coordinate fields, weights and row mapping as
        tensors on the device, uploaded once (the vis payload stays
        behind: grid and degrid take ``vis_chunked``)."""
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return plan._replace(
            uv=dev(plan.uv), sub_uv=dev(plan.sub_uv),
            w_plane=dev(plan.w_plane), vis=None, weights=dev(plan.weights),
            anchor=dev(plan.anchor), valid=dev(plan.valid),
            row_chunk=dev(np.asarray(plan.row_chunk, np.int64)),
            row_slot=dev(np.asarray(plan.row_slot, np.int64)))

    def grid(self, grid, kernel, weights_grid, plan: ChunkPlan, vis_chunked,
             dw_chunks=None, n_chunks=None):
        """Add the planned chunks onto ``grid`` (a ``(gr, gi)`` pair of
        (P, N, N) f32 planes) in place; returns it.  ``dw_chunks``
        (NC, Mc, P) gives each visibility's density weight (skipping the
        gather from ``weights_grid``); ``n_chunks`` (host int) the
        occupied chunks, else counted with a device sync."""
        if plan.uv.shape[0] == 0:
            return grid
        return grid_chunks_onto(
            grid, kernel, weights_grid, plan.uv, plan.sub_uv, plan.w_plane,
            vis_chunked, plan.anchor, plan.valid, dw_chunks, n_chunks,
            pixels=self.pixels, ts=self.ts, plain=self.plain)

    def degrid(self, grid, kernel, plan: ChunkPlan, vis_chunked,
               n_chunks=None):
        """``vis_chunked - weights * prediction`` (NC, Mc, P) from the
        ``(gr, gi)`` model grid planes.  The JAX method pads the grid by
        (ts, ts) first; K5 reads cells outside the planes as zero, which
        is what that padding gave."""
        if plan.uv.shape[0] == 0:
            return vis_chunked
        return degrid_chunks_parts(
            grid, kernel, plan.uv, plan.sub_uv, plan.w_plane, plan.weights,
            vis_chunked, plan.anchor, plan.valid, n_chunks,
            pixels=self.pixels, rv=self.ts, ru=self.ts, plain=self.plain)

    def chunk_vis(self, plan: ChunkPlan, vis):
        """A flat (n, P) complex64 vis tensor in the (NC, Mc, P) chunk
        layout (zero in padding slots)."""
        out = torch.zeros(plan.weights.shape, dtype=torch.complex64,
                          device=vis.device)
        out[plan.row_chunk, plan.row_slot] = vis.to(torch.complex64)
        return out

    def unchunk_vis(self, plan: ChunkPlan, vis_chunked):
        """Inverse of :meth:`chunk_vis`: the flat (n, P) vis."""
        return vis_chunked[plan.row_chunk, plan.row_slot]
