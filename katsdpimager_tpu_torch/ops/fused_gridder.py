r"""Fused gridder: kernels K1 (band accumulation) and K2 (colour combine).

Counterpart of :mod:`katsdpimager_tpu.ops.pallas_gridder`'s gridding half
(``_grid_chunks_planes``, ``combine_planes_fused``,
``grid_chunks_fused_parts``, ``grid_chunks_fused``), with one entry
point for a slice, :func:`grid_slice`, and :func:`slice_planes`, its
colour planes without K2 (for :func:`.fused_fft.combine_cb_col_fft`,
which the slice loop takes in place of K2 then K3).  The wrapper prep is plain
PyTorch: tap row indices ``iu/iv`` and in-window shifts ``su/sv``, the sample
``vis * valid * density``, each chunk's valid ``count`` (its valid slots
are a prefix, the planner's invariant, so K1 grids slots below the count
and nothing else), the colour-plane ``slot`` of each chunk and the
per-tile occupancy mask.  The two kernels are hand-written CUDA
(``csrc/gridder.cu``); each has a plain PyTorch version here, which runs
where :func:`..device.runs_plain` says.

Geometry.  A chunk anchored at tile ``(tv, tu)`` (pixels ``(tv ts,
tu ts)``) contributes a ``2ts x 2ts`` band

    band[j, k] = sum_m conj(K_v[m, j]) sample[m] conj(K_u[m, k])

with ``K_v[m, j] = kernel[iv[m], j - sv[m]]`` (zero outside ``[0, K)``),
and likewise ``K_u``.  Same-colour tiles (tile parities ``a = tv & 1``,
``b = tu & 1``) never overlap, so each anchor's band is written once into
colour plane ``(a, b)`` at ``(tv >> 1, tu >> 1) * 2ts``; plane ``(a, b)``
starts at grid pixel ``(a ts, b ts)``.  ``slot`` packs (colour, tile)
into one index, as the JAX kernel's scalar prefetch does.

The colour planes come from :func:`torch.empty`: slots no chunk wrote
hold garbage, which K2 masks with a select (never a multiply, so a NaN
there cannot leak) and K23 never reads.

The JAX kernel's bf16-split selection table (``_stack_tab``,
``_select_shift``) worked around the MXU's bf16 inputs; K1 reads the f32
conjugated kernel rows ``(W*O, K)`` directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import runs_plain
from ..profiling import profile
from . import _build
from .mxu_gridder import colour_tiles, occupied_chunks, pol_groups

#: Chunks per group in the plain K1 (bounds its (G, P, Mc, 2ts) factors).
_PLAIN_GROUP = 256

#: Slots per chunk K1 takes (it holds a chunk's slot data in shared memory).
MAX_CHUNK = 256

#: The largest tile size K1 takes (every ts up to it with K <= ts + 1).
MAX_TILE = 256

#: The ``wgmma`` k-steps of 8 visibilities that K1's tensor cores sum
#: before the sums are promoted into FP32 totals (``kPromoteSteps`` in
#: ``csrc/wgmma.cuh``); the visibilities K1 stages and sums in one round,
#: one such stretch (``kKB`` in ``csrc/gridder.cu``); and the stretches
#: whose sums a segment's total takes before the run's does
#: (``kSegment``).
PROMOTE_STEPS = 2
BATCH = 8 * PROMOTE_STEPS
SEGMENT = 32


# ---------------------------------------------------------------------------
# K1: per-anchor band accumulation into the colour planes


def _shifted_rows(tab, idx, sh, ts2: int):
    """``tab[idx]`` shifted ``sh`` places right, zero-filled: (..., ts2)
    complex from the (W*O, ts2) zero-padded row table."""
    cols = torch.arange(ts2, device=tab.device, dtype=torch.int32)
    rows = tab[idx.long()]                               # (G, Mc, ts2)
    src = (cols - sh[..., None]).clamp(0, ts2 - 1).long()
    keep = cols >= sh[..., None]
    return torch.where(keep, torch.gather(rows, -1, src),
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def grid_planes_plain(slot, n: int, count, iu, iv, su, sv, sre, sim, table,
                      accr, acci, *, ts: int) -> None:
    """Plain PyTorch version of K1 (same arguments as :func:`grid_planes`).

    Per chunk, the band over all its slots as a complex matmul (invalid
    slots carry a zero sample); consecutive chunks of one slot summed
    with ``index_add_``; each run's sum written into its colour-plane
    block.  Unwritten blocks are left as they were.  ``count`` is not
    read: the reference does not share K1's assumption that the valid
    slots are a prefix, so a plan that breaks it shows as a difference.
    It sums in the samples' dtype (float64 samples, a complex128 table
    and float64 planes give a float64 reference)."""
    if n == 0:
        return
    P = sre.shape[1]
    TS2 = 2 * ts
    K = table.shape[1]
    nt2 = accr.shape[-1] // TS2
    tab = F.pad(torch.view_as_real(table), (0, 0, 0, TS2 - K))
    tab = torch.view_as_complex(tab.contiguous())        # (W*O, TS2)
    slot_n = slot[:n].long()
    first = torch.ones(n, dtype=torch.bool, device=slot.device)
    first[1:] = slot_n[1:] != slot_n[:-1]
    run = torch.cumsum(first.long(), 0) - 1
    nruns = int(first.sum())
    runs = torch.zeros((nruns, P, TS2, TS2, 2), dtype=sre.dtype,
                       device=accr.device)
    for g0 in range(0, n, _PLAIN_GROUP):
        g1 = min(n, g0 + _PLAIN_GROUP)
        a = _shifted_rows(tab, iv[g0:g1], sv[g0:g1], TS2)   # (G, Mc, TS2)
        b = _shifted_rows(tab, iu[g0:g1], su[g0:g1], TS2)
        s = torch.complex(sre[g0:g1], sim[g0:g1])           # (G, P, Mc)
        a_s = a[:, None] * s[..., None]                     # (G, P, Mc, TS2)
        band = a_s.transpose(-1, -2) @ b[:, None]           # (G, P, TS2, TS2)
        runs.index_add_(0, run[g0:g1], torch.view_as_real(band))
    rslot = slot_n[first]
    colour = rslot // (nt2 * nt2)
    rem = rslot - colour * (nt2 * nt2)
    tv2, tu2 = rem // nt2, rem % nt2
    ca, cb = colour // 2, colour % 2
    for plane, part in ((accr, 0), (acci, 1)):
        p7 = plane.view(2, 2, P, nt2, TS2, nt2, TS2)
        p7[ca, cb, :, tv2, :, tu2, :] = runs[..., part]


def grid_planes(slot, n: int, count, iu, iv, su, sv, sre, sim, table, accr,
                acci, *, ts: int, stats=None) -> None:
    """K1: grid the first ``count[c]`` slots of each of the first ``n``
    chunks into the colour planes, in place.

    slot (NC,) i32; count (NC,) i32 in [0, Mc]; iu/iv/su/sv (NC, Mc) i32;
    sre/sim (NC, P, Mc) f32;
    table (W*O, K) complex64, the conjugated kernel rows; accr/acci
    (2, 2, P, ext2, ext2) f32 with ``ext2 = nt2 * 2 ts``.  Writes each
    occupied slot's block once; leaves every other block untouched.
    Index ranges (``iu/iv < W*O``, slots inside the planes) are the
    planner's invariants; the kernel does not check them.  ``stats``, a
    diagnostic of the kernel alone: None, or an int32 tensor of (2 x the
    card's SMs, 2) into which each worker of the schedule (lane l of CTA
    b is worker l x SMs + b) writes the items and the batches it took.

    Runs :func:`grid_planes_plain` where :func:`..device.runs_plain`
    holds; otherwise launches ``ktt_grid_planes`` (``csrc/gridder.cu``)
    or raises.

    Replaces ``katsdpimager_tpu/ops/pallas_gridder.py:_make_kernel``.
    Bound by the band products (a dense 2ts x 2ts window per valid
    visibility).  The window, padded to a multiple of 64, is cut into
    tiles of 64 rows by 128 or 64 columns; each tile of each anchor run is
    a work item, and a persistent CTA per SM takes a contiguous share of
    the items by weight: a producer warpgroup stages the valid slots,
    :data:`BATCH` at a time, into a ring of shared-memory stages, and
    two consumer warpgroups form each 64 x 64 sub-block on
    the tensor cores in 3xTF32 (``wgmma`` m64n64k8, each operand split
    into TF32 hi and lo).  The tensor cores' truncating sums take one
    batch (:data:`PROMOTE_STEPS` k-steps of 8) and are then promoted by
    IEEE adds into a segment's FP32 totals in registers and those, every
    :data:`SEGMENT` batches and at the run's end, into the run's totals
    in its block of the plane, so the planes keep FP32 accuracy (2.7-4.3e-7
    of the peak from a float64 run on an H100, the JAX gridder's class);
    one owner per value, no atomics, so the planes do not depend on the
    schedule (details in the CUDA source).  Takes every ``ts`` up to
    :data:`MAX_TILE` with ``K <= ts + 1``; chunks hold at most
    :data:`MAX_CHUNK` slots.
    """
    with profile("k1.launch"):
        if runs_plain(accr):
            if stats is not None:
                raise NotImplementedError(
                    "stats come from the CUDA kernel only")
            grid_planes_plain(slot, n, count, iu, iv, su, sv, sre, sim,
                              table, accr, acci, ts=ts)
            return
        dev = accr.device
        NC, Mc = iu.shape
        P = sre.shape[1]
        WO, K = table.shape
        if not 1 <= ts <= MAX_TILE:
            raise NotImplementedError(
                f"K1 takes ts in [1, {MAX_TILE}], not {ts}")
        if K + ts - 1 > 2 * ts:
            raise NotImplementedError(f"K1: kernel width {K} > ts + 1")
        if Mc > MAX_CHUNK:
            raise NotImplementedError(f"K1 takes chunks of at most "
                                      f"{MAX_CHUNK} slots, not {Mc}")
        ext2 = accr.shape[-1]
        nt2 = ext2 // (2 * ts)
        _build.expect(slot, "slot", torch.int32, (NC,), dev)
        _build.expect(count, "count", torch.int32, (NC,), dev)
        for name, t in (("iu", iu), ("iv", iv), ("su", su), ("sv", sv)):
            _build.expect(t, name, torch.int32, (NC, Mc), dev)
        _build.expect(sre, "sre", torch.float32, (NC, P, Mc), dev)
        _build.expect(sim, "sim", torch.float32, (NC, P, Mc), dev)
        _build.expect(table, "table", torch.complex64, (WO, K), dev)
        _build.expect(accr, "accr", torch.float32, (2, 2, P, ext2, ext2), dev)
        _build.expect(acci, "acci", torch.float32, (2, 2, P, ext2, ext2), dev)
        if not 0 <= n <= NC:
            raise ValueError(f"n = {n} outside [0, {NC}]")
        if stats is not None:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            _build.expect(stats, "stats", torch.int32, (2 * sms, 2), dev)
        if n == 0:
            return
        lib = _build.load()
        err = lib.ktt_grid_planes(
            slot.data_ptr(), n, count.data_ptr(), iu.data_ptr(), iv.data_ptr(),
            su.data_ptr(), sv.data_ptr(), sre.data_ptr(), sim.data_ptr(),
            table.data_ptr(), accr.data_ptr(), acci.data_ptr(),
            None if stats is None else stats.data_ptr(), NC, Mc, P, K, ts, nt2,
            _build.stream_of(accr))
        _build.check(err, "ktt_grid_planes")
        grid_planes.launches += 1


grid_planes.launches = 0


# ---------------------------------------------------------------------------
# K2: colour-plane combine into the cropped grid


def combine_planes_plain(accr, acci, occ, *, pixels: int, ts: int,
                         out=None):
    """Plain PyTorch version of K2 (same arguments as
    :func:`combine_planes`): masked, placed colour planes summed in the
    order ``((p00 + p01) + p10) + p11``, or onto ``out`` in the order
    ``(((g + p00) + p01) + p10) + p11``."""
    _, _, P, ext2, _ = accr.shape
    n = pixels
    TS2 = 2 * ts

    def placed(plane, a, b):
        m = occ[a, b].repeat_interleave(TS2, 0).repeat_interleave(TS2, 1)
        sel = torch.where(m, plane[a, b], 0.0)
        out = torch.zeros((P, n, n), dtype=torch.float32, device=plane.device)
        out[:, a * ts:, b * ts:] = sel[:, :n - a * ts, :n - b * ts]
        return out

    def combine(plane, base):
        g = placed(plane, 0, 0)
        g = g + placed(plane, 0, 1) if base is None else (
            (base + g) + placed(plane, 0, 1))
        return (g + placed(plane, 1, 0)) + placed(plane, 1, 1)

    if out is None:
        return combine(accr, None), combine(acci, None)
    out[0].copy_(combine(accr, out[0]))
    out[1].copy_(combine(acci, out[1]))
    return out


def combine_planes(accr, acci, occ, *, pixels: int, ts: int, out=None):
    """K2: ``(accr, acci, occ)`` -> cropped (P, N, N) f32 ``(gr, gi)``.

    Adds the four colour planes at offsets ``(a ts, b ts)``, selecting
    zero for tiles that ``occ`` (2, 2, nt2, nt2) bool marks unwritten.
    Bitwise equal to :func:`combine_planes_plain` and to the JAX
    ``combine_planes_fused``: same add order, select not multiply.

    With ``out``, a ``(gr, gi)`` pair of running grid planes, the colour
    planes are added onto it in place, in the order of the JAX running-grid
    combine ``grid_chunks_fused``: ``(((g + p00) + p01) + p10) + p11``;
    ``out`` is returned.

    Runs the plain version where :func:`..device.runs_plain` holds;
    otherwise launches ``ktt_combine_planes`` (``csrc/gridder.cu``) or
    raises.

    Replaces ``katsdpimager_tpu/ops/pallas_gridder.py:_make_combine_kernel``.
    Bound by device memory bandwidth; one thread per output pixel,
    coalesced.  CUDA rather than Triton so all four kernels share one
    ``nvcc`` build.
    """
    with profile("k2.launch"):
        if runs_plain(accr):
            return combine_planes_plain(accr, acci, occ, pixels=pixels, ts=ts,
                                        out=out)
        dev = accr.device
        _, _, P, ext2, _ = accr.shape
        nt2 = ext2 // (2 * ts)
        # One thread per output pixel: any N whose shifted planes cover it
        # (the JAX kernel's ts-row strips also needed N % ts == 0).
        if pixels + ts > ext2:
            raise ValueError(f"K2: pixels {pixels} incompatible with ts {ts} "
                             f"and plane extent {ext2}")
        _build.expect(accr, "accr", torch.float32, (2, 2, P, ext2, ext2), dev)
        _build.expect(acci, "acci", torch.float32, (2, 2, P, ext2, ext2), dev)
        _build.expect(occ, "occ", torch.bool, (2, 2, nt2, nt2), dev)
        if out is None:
            gr = torch.empty((P, pixels, pixels), dtype=torch.float32,
                             device=dev)
            gi = torch.empty_like(gr)
        else:
            gr, gi = out
            _build.expect(gr, "gr", torch.float32, (P, pixels, pixels), dev)
            _build.expect(gi, "gi", torch.float32, (P, pixels, pixels), dev)
        lib = _build.load()
        err = lib.ktt_combine_planes(
            accr.data_ptr(), acci.data_ptr(), occ.data_ptr(), gr.data_ptr(),
            gi.data_ptr(), P, pixels, ts, nt2, int(out is not None),
            _build.stream_of(accr))
        _build.check(err, "ktt_combine_planes")
        combine_planes.launches += 1
        return gr, gi


combine_planes.launches = 0


# ---------------------------------------------------------------------------
# Wrapper prep and the composite entry point


def tap_indices(kernel, plan_uv, plan_sub, plan_wp, plan_anchor, *,
                pixels: int, ts: int):
    """Tap row indices ``iu/iv`` into the (W*O, K) table and in-window
    shifts ``su/sv``, each (NC, Mc) int32."""
    K, O = kernel.shape[-1], kernel.shape[1]
    uv_bias = (K - 1) // 2 - pixels // 2
    wp = plan_wp.to(torch.int32)
    sub = plan_sub.to(torch.int32)
    uv = plan_uv.to(torch.int32)
    anc = plan_anchor.to(torch.int32)
    iu = wp * O + sub[..., 0]
    iv = wp * O + sub[..., 1]
    su = (uv[..., 0] - uv_bias - anc[:, None, 1]).clamp(0, ts - 1)
    sv = (uv[..., 1] - uv_bias - anc[:, None, 0]).clamp(0, ts - 1)
    return (iu.contiguous(), iv.contiguous(), su.contiguous(),
            sv.contiguous())


def samples(plan_vis, plan_valid, weights_grid, dw_chunks, plan_anchor, su,
            sv, *, kernel_width: int, ts: int):
    """``sample = vis * valid * density`` as (NC, P, Mc) f32 re/im.

    The density comes from ``dw_chunks`` (NC, Mc, P) when given, else is
    looked up in ``weights_grid`` (P, N, N) at each visibility's cell
    through its anchor window (the JAX ``dw_of``, including
    ``dynamic_slice``'s clamp of the window start), else is 1."""
    sample = plan_vis * plan_valid[..., None]
    if dw_chunks is not None:
        sample = sample * dw_chunks
    elif weights_grid is not None:
        N = weights_grid.shape[-1]
        kb = (kernel_width - 1) // 2
        wg_pad = F.pad(weights_grid, (0, ts, 0, ts))
        anc = plan_anchor.long()
        r0 = (anc[:, 0] + kb).clamp(0, N)
        c0 = (anc[:, 1] + kb).clamp(0, N)
        rows = r0[:, None] + sv.long()
        cols = c0[:, None] + su.long()
        sample = sample * wg_pad[:, rows, cols].permute(1, 2, 0)
    sample = sample.transpose(-1, -2)                    # (NC, P, Mc)
    return (sample.real.to(torch.float32).contiguous(),
            sample.imag.to(torch.float32).contiguous())


def chunk_slots(plan_anchor, n: int, *, ts: int, nt2: int):
    """Colour-plane slot of each chunk (NC,) int32; chunks past ``n``
    (padding) get slot 0, as in the JAX wrapper."""
    tv = plan_anchor[:, 0].to(torch.int32) // ts
    tu = plan_anchor[:, 1].to(torch.int32) // ts
    slot = (((tv & 1) * 2 + (tu & 1)) * (nt2 * nt2)
            + (tv >> 1) * nt2 + (tu >> 1))
    live = torch.arange(slot.shape[0], device=slot.device) < n
    return torch.where(live, slot, 0).to(torch.int32).contiguous()


def valid_counts(plan_valid):
    """Each chunk's valid slot count (NC,) int32: K1 grids the slots below
    it.  The planner puts every chunk's valid slots first
    (:func:`check_valid_prefix`)."""
    return plan_valid.sum(-1, dtype=torch.int32).contiguous()


def check_valid_prefix(plan_valid, count) -> None:
    """Raise unless every chunk's valid slots are the first ``count``
    (the planner's invariant, which K1 relies on; a device sync).
    ``plan_valid`` (..., Mc) bool, ``count`` (...) its valid counts."""
    slots = torch.arange(plan_valid.shape[-1], device=plan_valid.device)
    if not torch.equal(plan_valid, slots < count[..., None].long()):
        raise ValueError("valid slots are not a prefix of every chunk")


def occupancy(slot, n: int, nt2: int):
    """(2, 2, nt2, nt2) bool: which colour-plane tiles K1 writes.

    Filled by ``index_fill_``, whose value is a kernel argument: an index
    assignment (``occ[idx] = True``) copies its value from pageable host
    memory, which waits for the stream to drain, once a slice, and so
    ties every slice's enqueue to the device (the ``k1.occupancy``
    span)."""
    with profile("k1.occupancy"):
        occ = torch.zeros(4 * nt2 * nt2, dtype=torch.bool,
                          device=slot.device)
        occ.index_fill_(0, slot[:n].long(), True)
        return occ.view(2, 2, nt2, nt2)


def tf32_rna(x):
    """``x`` rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero: PTX ``cvt.rna.tf32.f32``), held in f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_table(table):
    """K1's split of its B operand's values for 3xTF32 (its producer
    splits each table value it stages), the whole table at once: the (W*O,
    K) complex64 table as (W*O, K, 4) f32 ``[re hi, re lo, im hi, im
    lo]``, ``hi = tf32_rna(x)``, ``lo = tf32_rna(x - hi)``."""
    parts = []
    for x in (table.real, table.imag):
        x = x.to(torch.float32)
        hi = tf32_rna(x)
        parts += [hi, tf32_rna(x - hi)]
    return torch.stack(parts, dim=-1).contiguous()


def conj_table(kernel):
    """The conjugated kernel rows (W*O, K) complex64 that K1 reads."""
    W, O, K = kernel.shape
    return kernel.reshape(W * O, K).conj().resolve_conj().to(
        torch.complex64).contiguous()


def grid_chunks_planes(kernel, weights_grid, plan_uv, plan_sub, plan_wp,
                       plan_vis, plan_anchor, plan_valid, dw_chunks,
                       n_chunks: int, *, pixels: int, ts: int):
    """Prep plus K1: returns ``(accr, acci, occ)`` — the colour planes
    (unwritten blocks uninitialised) and their occupancy mask.  On the
    CPU the valid slots are checked to be a prefix of every chunk.  The
    prep, every input of K1 and the occupancy mask, is the ``k1.prep``
    span; in it, the part that no polarization changes (tap indices,
    chunk slots, counts, occupancy, the table) is the ``k1.prep_shared``
    span."""
    Pp = plan_vis.shape[-1]
    K = kernel.shape[-1]
    nt2 = colour_tiles(pixels, ts)
    ext2 = nt2 * 2 * ts
    dev = plan_vis.device
    with profile("k1.prep"):
        with profile("k1.prep_shared"):
            iu, iv, su, sv = tap_indices(kernel, plan_uv, plan_sub, plan_wp,
                                         plan_anchor, pixels=pixels, ts=ts)
            slot = chunk_slots(plan_anchor, n_chunks, ts=ts, nt2=nt2)
            count = valid_counts(plan_valid)
            if dev.type == "cpu":
                check_valid_prefix(plan_valid, count)
            occ = occupancy(slot, n_chunks, nt2)
            table = conj_table(kernel)
        sre, sim = samples(plan_vis, plan_valid, weights_grid, dw_chunks,
                           plan_anchor, su, sv, kernel_width=K, ts=ts)
        accr = torch.empty((2, 2, Pp, ext2, ext2), dtype=torch.float32,
                           device=dev)
        acci = torch.empty_like(accr)
    grid_planes(slot, n_chunks, count, iu, iv, su, sv, sre, sim, table, accr,
                acci, ts=ts)
    return accr, acci, occ


def slice_planes(kernel, density, plan_uv, plan_sub, plan_wp, plan_vis,
                 plan_anchor, plan_valid, n_chunks=None, *, pixels: int,
                 ts: int, dw_chunks=None):
    """Grid one slice's chunks into colour planes, one group of
    polarizations at a time (those whose planes fit the accumulator cap,
    :func:`.mxu_gridder.pol_groups`): yields ``(p0, p1, accr, acci,
    occ)`` for polarizations ``p0:p1``, prep plus K1
    (:func:`grid_chunks_planes`, the ``k1.group`` span), each group
    gridded only when the caller asks for it.  The generator holds no
    group's planes while it waits, so a caller that drops each group's
    before asking for the next holds one group's at a time, the peak the
    cap bounds.  Arguments as :func:`grid_slice`'s."""
    K = kernel.shape[-1]
    if K > ts + 1:
        raise NotImplementedError(
            f"kernel width {K} > ts + 1 = {ts + 1}: the fused gridder's "
            "2-tile window cannot hold it, and no other gridder is ported")
    if n_chunks is None:
        n_chunks = occupied_chunks(plan_valid)

    def group(p0, p1):
        with profile("k1.group"):
            return grid_chunks_planes(
                kernel, None if density is None else density[p0:p1],
                plan_uv, plan_sub, plan_wp, plan_vis[..., p0:p1],
                plan_anchor, plan_valid,
                None if dw_chunks is None else dw_chunks[..., p0:p1],
                n_chunks, pixels=pixels, ts=ts)

    for p0, p1 in pol_groups(plan_vis.shape[-1], pixels, ts):
        yield (p0, p1, *group(p0, p1))


def grid_slice(kernel, density, plan_uv, plan_sub, plan_wp, plan_vis,
               plan_anchor, plan_valid, n_chunks=None, *, pixels: int,
               ts: int, dw_chunks=None, out=None):
    """Grid one slice's chunks: :func:`slice_planes` (prep plus K1 for
    each group of polarizations), then K2 for each group.

    ``density`` (P, N, N) or ``dw_chunks`` (NC, Mc, P) gives each
    visibility's density weight (:func:`samples`; neither: natural).
    ``n_chunks`` (host int) bounds the chunks gridded; None counts the
    occupied chunks (a device sync).  With ``out=None`` returns fresh
    cropped (P, N, N) f32 ``(gr, gi)`` planes (the JAX
    ``grid_chunks_parts_impl(..., assembly="pallas")``).  With ``out``, a
    ``(gr, gi)`` pair of (P, N, N) running grid planes, adds onto them in
    place in the JAX order ``(((g + p00) + p01) + p10) + p11`` and
    returns them (the JAX ``grid_chunks_fused``): K2's accumulating form
    at float32, its plain version at float64 (``--precision double``, as
    XLA does it in the JAX package).  Kernels wider than ``ts + 1`` do
    not fit K1's ``2 ts`` window (the JAX package falls back to XLA
    there): they raise."""
    parts = []
    for p0, p1, accr, acci, occ in slice_planes(
            kernel, density, plan_uv, plan_sub, plan_wp, plan_vis,
            plan_anchor, plan_valid, n_chunks, pixels=pixels, ts=ts,
            dw_chunks=dw_chunks):
        if out is None:
            parts.append(combine_planes(accr, acci, occ, pixels=pixels,
                                        ts=ts))
        else:
            k2 = (combine_planes if out[0].dtype == torch.float32
                  else combine_planes_plain)
            k2(accr, acci, occ, pixels=pixels, ts=ts,
               out=(out[0][p0:p1], out[1][p0:p1]))
        del accr, acci, occ     # before the next group's planes are made
    if out is not None:
        return out
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))
