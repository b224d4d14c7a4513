"""Host-side chunk planning and the fused gridder's layout helpers.

Counterpart of the host half of :mod:`katsdpimager_tpu.ops.mxu_gridder`
(numpy, no JAX): the tile-aligned chunk plan that both packages grid from
(the layout is bit-identical, so one batch feeds both), the padded grid
extent, the colour-plane tiles, the per-channel tile size and the
polarization groups that fit the accumulator cap.  The kernel modules
(:mod:`.fused_gridder`, :mod:`.fused_degrid`) import these helpers; this
module imports no kernel module.

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

    Uses the port's own native counting-sort packer (:mod:`..native`)
    when it builds (its layout is bitwise identical to the numpy
    planner's), as the JAX planner uses its package's.
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


def plan_chunks_tiled_device(uv, sub_uv, w_plane, vis, weights, *,
                             pixels: int, kernel_width: int, ts: int,
                             mc: int, nc: int, device=None) -> dict:
    """The tiled chunk plan made by device ops, with no host sync.

    Counterpart of the JAX ``plan_chunks_tiled_device``: the layout of
    :func:`plan_chunks_tiled` (a stable sort by tile key, groups started
    by ``cummax``, chunks of at most ``mc`` within each tile), scattered
    into ``nc`` chunks; chunks past ``nc`` are dropped.  The inputs
    (tensors or arrays) go to ``device`` (None: the CUDA device, which
    must exist).  Returns a dict of tensors: the :class:`ChunkPlan`
    fields (``row_chunk`` unclipped for dropped rows, as in JAX) and the
    0-d int32 ``n_chunks``, the true chunk count, which the caller reads
    when it needs it.  Plain PyTorch: the JAX function is XLA ops, not a
    Pallas kernel.
    """
    dev = device_mod.resolve(device)
    uv, sub_uv, w_plane, vis, weights = (
        torch.as_tensor(x, device=dev)
        for x in (uv, sub_uv, w_plane, vis, weights))
    K = kernel_width
    n, P = vis.shape
    uv_bias = (K - 1) // 2 - pixels // 2
    u0 = uv[:, 0].to(torch.int32) - uv_bias
    v0 = uv[:, 1].to(torch.int32) - uv_bias
    tv = torch.div(v0, ts, rounding_mode="floor")
    tu = torch.div(u0, ts, rounding_mode="floor")
    ntu = -(-pixels // ts) + 1
    key_s, order = torch.sort(tv * ntu + tu, stable=True)

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    new_group = torch.ones(n, dtype=torch.bool, device=dev)
    new_group[1:] = key_s[1:] != key_s[:-1]
    # the start index of each element's group: cummax of group starts
    start = torch.cummax(torch.where(new_group, idx, 0), 0).values
    local = idx - start
    slot_of = local % mc
    chunk_of = torch.cumsum(new_group | (slot_of == 0), 0,
                            dtype=torch.int32) - 1
    n_chunks = (chunk_of[-1] + 1 if n
                else torch.zeros((), dtype=torch.int32, device=dev))

    # Rows past nc land in one spare chunk that is cut off (the JAX
    # scatter's mode="drop", without a host sync to count them).
    at = (torch.where(chunk_of < nc, chunk_of, nc), slot_of)

    def scat(values, *tail):
        out = torch.zeros((nc + 1, mc, *tail), dtype=values.dtype,
                          device=dev)
        out.index_put_(at, values)
        return out[:nc]

    anchor = torch.zeros((nc + 1, 2), dtype=torch.int32, device=dev)
    anchor[at[0]] = torch.stack([tv[order], tu[order]], 1) * ts
    row_chunk = torch.empty(n, dtype=torch.int32, device=dev)
    row_slot = torch.empty(n, dtype=torch.int32, device=dev)
    row_chunk[order] = chunk_of
    row_slot[order] = slot_of
    return dict(uv=scat(uv[order].to(torch.int32), 2),
                sub_uv=scat(sub_uv[order].to(torch.int32), 2),
                w_plane=scat(w_plane[order].to(torch.int32)),
                vis=scat(vis[order], P), weights=scat(weights[order], P),
                anchor=anchor[:nc],
                valid=scat(torch.ones(n, dtype=torch.bool, device=dev)),
                row_chunk=row_chunk, row_slot=row_slot, n_chunks=n_chunks)


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


def pol_groups(num_pols: int, pixels: int, ts: int) -> list[tuple[int, int]]:
    """Split polarizations into groups whose colour-plane accumulators
    (four re/im planes of ``ext2**2`` f32 per polarization) fit
    :data:`MAX_ACC_GB` (read at the call).  Returns ``[(start, stop),
    ...]``; raises when one polarization alone does not fit."""
    max_acc_gb = MAX_ACC_GB
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


def tile_size(pixels: int, kernel_width: int) -> int:
    """The per-channel path's square tile size: ``max(min(64, max(8,
    N // 8)), K)`` (the JAX ``Imaging`` window, raised to cover the
    kernel as its dense mode does).  64 at 4096 px with K = 60, 32 at
    256 px with K = 16, 50 at 400 px, 8-31 below 256 px and K for every
    K > 64; K1 and K5 take every ts up to 256 with K <= ts + 1."""
    return max(min(64, max(8, pixels // 8)), kernel_width)
