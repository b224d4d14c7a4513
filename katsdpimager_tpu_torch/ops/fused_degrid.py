r"""Fused degridder: kernel K5 and its prep.

Counterpart of :func:`katsdpimager_tpu.ops.pallas_gridder.degrid_chunks_fused`,
with one entry point for a slice, :func:`degrid_slice`.  For each of the
first ``count[c]`` slots ``m`` of every occupied chunk ``c`` (its valid
slots: the planner puts them first), the model prediction

    pred[p, m] = sum_j sum_k kv[m, j] G[p, av + sv[m] + j, au + su[m] + k] ku[m, k]

from the (P, N, N) f32 grid planes that K7 emits, with the UNCONJUGATED
taps ``kv[m, j] = kernel[iv[m], j]``, ``ku[m, k] = kernel[iu[m], k]``
(``j, k < K``); the other slots predict zero.  The prep is plain
PyTorch: tap rows ``iu/iv = wp O + sub`` and in-window shifts ``su/sv``
as the gridder's (:func:`.fused_gridder.tap_indices`, clamped to ``[0, ts
- 1]``, where a tile-aligned plan's valid shifts lie), and window anchors
clamped to ``[0, ext - 2ts]`` with ``ext = dense_pad_size``.  So a
chunk's taps reach at most a ``(K + ts - 1)^2`` window, inside the JAX
kernel's ``2ts x 2ts`` one (``K <= ts + 1``).  Window cells outside the
unpadded planes read as zero, which is what the JAX path's zero re-pad to
``ext`` gave.

The kernel is hand-written CUDA (``csrc/degrid.cu``): valid slots only,
sorted by row shift, the footprint streamed through a ring of row blocks
whose layout ``csrc/degrid_layout.h`` chooses from (ts, K, Mc, P).  Its
plain PyTorch version here gathers the windows in groups of chunks, as
the plain K1 does, and runs where :func:`..device.runs_plain` says.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import runs_plain
from . import _build
from .fused_gridder import _shifted_rows, tap_indices, valid_counts
from .mxu_gridder import dense_pad_size, occupied_chunks

#: Chunks per group in the plain K5 (bounds its (P, G, Mc, W) products).
_PLAIN_GROUP = 256


def degrid_taps(kernel, plan_uv, plan_sub, plan_wp, plan_anchor, *,
                pixels: int, ts: int):
    """K5's per-chunk inputs: window anchors ``(av, au)`` (NC,) int32 and
    tap rows / shifts ``(iu, iv, su, sv)`` (NC, Mc) int32, the shifts in
    ``[0, ts - 1]``."""
    iu, iv, su, sv = tap_indices(kernel, plan_uv, plan_sub, plan_wp,
                                 plan_anchor, pixels=pixels, ts=ts)
    anc = plan_anchor.to(torch.int32)
    hi = dense_pad_size(pixels, ts) - 2 * ts
    av = anc[:, 0].clamp(0, hi).contiguous()
    au = anc[:, 1].clamp(0, hi).contiguous()
    return av, au, iu, iv, su, sv


def degrid_table(kernel):
    """The UNCONJUGATED kernel rows (W*O, K) complex64 that K5 reads."""
    W, O, K = kernel.shape
    return kernel.reshape(W * O, K).to(torch.complex64).contiguous()


def degrid_planes_plain(gr, gi, av, au, count, iu, iv, su, sv, table,
                        n: int, *, ts: int):
    """Plain PyTorch version of K5 (same arguments as
    :func:`degrid_planes`): per group of chunks, the ``K + ts - 1``
    windows gathered from the zero-padded planes, ``B = ku @ window^T``,
    the sum of ``kv * B`` over the tap rows, and zero for the slots at or
    past each chunk's ``count``."""
    NC, Mc = iu.shape
    P, N, _ = gr.shape
    K = table.shape[1]
    Wd = K + ts - 1
    pred = torch.zeros((NC, Mc, P), dtype=torch.complex64, device=gr.device)
    if n == 0:
        return pred
    ext = dense_pad_size(N, ts)
    pad = (0, ext - N, 0, ext - N)
    g = torch.complex(F.pad(gr, pad), F.pad(gi, pad))      # (P, ext, ext)
    tab = F.pad(torch.view_as_real(table), (0, 0, 0, Wd - K))
    tab = torch.view_as_complex(tab.contiguous())          # (W*O, Wd)
    offs = torch.arange(Wd, device=gr.device)
    slots = torch.arange(Mc, device=gr.device)
    for g0 in range(0, n, _PLAIN_GROUP):
        g1 = min(n, g0 + _PLAIN_GROUP)
        rows = av[g0:g1, None].long() + offs                # (G, Wd)
        cols = au[g0:g1, None].long() + offs
        win = g[:, rows[:, :, None], cols[:, None, :]]      # (P, G, Wd, Wd)
        kv = _shifted_rows(tab, iv[g0:g1], sv[g0:g1], Wd)   # (G, Mc, Wd)
        ku = _shifted_rows(tab, iu[g0:g1], su[g0:g1], Wd)
        b = ku[None] @ win.transpose(-1, -2)                # (P, G, Mc, Wd)
        live = slots < count[g0:g1, None].long()            # (G, Mc)
        pred[g0:g1] = torch.where(live[..., None],
                                  (b * kv[None]).sum(-1).permute(1, 2, 0), 0)
    return pred


def degrid_planes(gr, gi, av, au, count, iu, iv, su, sv, table, n: int, *,
                  ts: int):
    """K5: predict the first ``count[c]`` slots of each of the first ``n``
    chunks from the grid planes.  Returns (NC, Mc, P) complex64, zero for
    the other slots and for chunks past ``n``.

    gr/gi (P, N, N) f32, the unpadded grid planes (cells outside read as
    zero); av/au (NC,) int32 window anchors in ``[0, ext - 2ts]``; count
    (NC,) int32 valid slots per chunk (:func:`.fused_gridder.valid_counts`);
    iu/iv/su/sv (NC, Mc) int32 tap rows and shifts in ``[0, ts - 1]``;
    table (W*O, K) complex64, the unconjugated kernel rows.  The ranges
    are :func:`degrid_taps`' invariants; the kernel does not check them.

    Runs :func:`degrid_planes_plain` where :func:`..device.runs_plain`
    holds; otherwise launches ``ktt_degrid_planes`` (``csrc/degrid.cu``)
    or raises, also where no layout fits: K > ts + 1, K > 256, or Mc * P
    accumulators beyond a CUDA block's shared memory.

    Replaces ``katsdpimager_tpu/ops/pallas_gridder.py:_make_degrid_kernel``.
    Bound by shared-memory reads (one 8-byte window value per complex
    MAC, K^2 per valid visibility); one CTA per chunk sorts its valid
    slots by row shift and streams the chunk's tap footprint through a
    ring of row blocks, a warp per visibility with all its rows present
    (details in the CUDA source).
    """
    if runs_plain(gr):
        return degrid_planes_plain(gr, gi, av, au, count, iu, iv, su, sv,
                                   table, n, ts=ts)
    dev = gr.device
    NC, Mc = iu.shape
    P, N, _ = gr.shape
    WO, K = table.shape
    _build.expect(gr, "gr", torch.float32, (P, N, N), dev)
    _build.expect(gi, "gi", torch.float32, (P, N, N), dev)
    _build.expect(av, "av", torch.int32, (NC,), dev)
    _build.expect(au, "au", torch.int32, (NC,), dev)
    _build.expect(count, "count", torch.int32, (NC,), dev)
    for name, t in (("iu", iu), ("iv", iv), ("su", su), ("sv", sv)):
        _build.expect(t, name, torch.int32, (NC, Mc), dev)
    _build.expect(table, "table", torch.complex64, (WO, K), dev)
    if not 0 <= n <= NC:
        raise ValueError(f"n = {n} outside [0, {NC}]")
    pred = torch.empty((NC, Mc, P), dtype=torch.complex64, device=dev)
    pred[n:].zero_()
    if n == 0:
        return pred
    err = _build.load().ktt_degrid_planes(
        gr.data_ptr(), gi.data_ptr(), av.data_ptr(), au.data_ptr(),
        count.data_ptr(), iu.data_ptr(), iv.data_ptr(), su.data_ptr(),
        sv.data_ptr(), table.data_ptr(), pred.data_ptr(), n, Mc, P, N, K,
        ts, _build.stream_of(gr))
    _build.check(err, "ktt_degrid_planes")
    degrid_planes.launches += 1
    return pred


degrid_planes.launches = 0


def degrid_slice(grid, kernel, plan_uv, plan_sub, plan_wp, plan_wt,
                 plan_vis, plan_anchor, plan_valid, n_chunks=None, *,
                 pixels: int, ts: int):
    """Predict and subtract: one slice's visibilities less the weighted
    model prediction, ``vis - wt * (pred * valid)`` (NC, Mc, P).

    ``grid`` is the (P, N, N) f32 ``(gr, gi)`` pair of grid planes
    (:func:`..fourier.image_to_grid_parts`).  Counterpart of
    ``mxu_gridder.degrid_chunks_impl(..., assembly="pallas",
    tile_aligned=True)`` (tile-aligned plans of square ``ts`` tiles,
    :func:`.mxu_gridder.plan_chunks_tiled`): the prep plus K5.  Where the
    JAX package falls back to an XLA assembly (a kernel wider than
    ``ts + 1``) this raises.  ``n_chunks`` (host int) bounds the chunks
    predicted; None counts the occupied chunks (a device sync).  Padding
    chunks pass their visibilities through unchanged."""
    K = kernel.shape[-1]
    if K > ts + 1:
        raise NotImplementedError(
            f"the fused degridder takes K <= ts + 1, not ts={ts}, K={K}; "
            f"no other degridder is ported")
    if n_chunks is None:
        n_chunks = occupied_chunks(plan_valid)
    gr, gi = grid
    av, au, iu, iv, su, sv = degrid_taps(kernel, plan_uv, plan_sub, plan_wp,
                                         plan_anchor, pixels=pixels, ts=ts)
    pred = degrid_planes(gr, gi, av, au, valid_counts(plan_valid), iu, iv,
                         su, sv, degrid_table(kernel), n_chunks, ts=ts)
    pred = torch.where(plan_valid[..., None], pred, 0)
    return plan_vis - plan_wt * pred
