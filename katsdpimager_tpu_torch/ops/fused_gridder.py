r"""Fused gridder: kernels K1 (band accumulation) and K2 (colour combine).

Counterpart of :mod:`katsdpimager_tpu.ops.pallas_gridder`'s gridding half
(``_grid_chunks_planes``, ``combine_planes_fused``,
``grid_chunks_fused_parts``).  The wrapper prep is plain PyTorch: tap
row indices ``iu/iv`` and in-window shifts ``su/sv``, the sample
``vis * valid * density``, each chunk's valid ``count`` (its valid slots
are a prefix, the planner's invariant, so K1 grids slots below the count
and nothing else), the colour-plane ``slot`` of each chunk and the
per-tile occupancy mask.  The two kernels are hand-written CUDA
(``csrc/gridder.cu``); each has a plain PyTorch version here, which CPU
tensors run.

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
there cannot leak).

The JAX kernel's bf16-split selection table (``_stack_tab``,
``_select_shift``) worked around the MXU's bf16 inputs; K1 reads the f32
conjugated kernel rows ``(W*O, K)`` directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .mxu_gridder import colour_tiles, occupied_chunks

#: Chunks per group in the plain K1 (bounds its (G, P, Mc, 2ts) factors).
_PLAIN_GROUP = 256

#: Slots per chunk K1 takes (it holds a chunk's slot data in shared memory).
MAX_CHUNK = 256


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
    slots are a prefix, so a plan that breaks it shows as a difference."""
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
    runs = torch.zeros((nruns, P, TS2, TS2, 2), dtype=torch.float32,
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
                acci, *, ts: int) -> None:
    """K1: grid the first ``count[c]`` slots of each of the first ``n``
    chunks into the colour planes, in place.

    slot (NC,) i32; count (NC,) i32 in [0, Mc]; iu/iv/su/sv (NC, Mc) i32;
    sre/sim (NC, P, Mc) f32;
    table (W*O, K) complex64, the conjugated kernel rows; accr/acci
    (2, 2, P, ext2, ext2) f32 with ``ext2 = nt2 * 2 ts``.  Writes each
    occupied slot's block once; leaves every other block untouched.
    Index ranges (``iu/iv < W*O``, slots inside the planes) are the
    planner's invariants; the kernel does not check them.

    CPU tensors run :func:`grid_planes_plain`; CUDA tensors launch
    ``ktt_grid_planes`` (``csrc/gridder.cu``) or raise.

    Replaces ``katsdpimager_tpu/ops/pallas_gridder.py:_make_kernel``.
    Bound by the band products (a dense 2ts x 2ts window per valid
    visibility).  One CTA per anchor run loops over the valid slots only,
    8 at a time, and forms the band on the tensor cores in 3xTF32
    (``wgmma`` m64n(2ts)k8, each operand split into TF32 hi and lo), FP32
    accurate; the window stays in accumulator registers and is written
    once, with no atomics (details in the CUDA source).  Chunks hold at
    most :data:`MAX_CHUNK` slots.
    """
    if accr.device.type == "cpu":
        grid_planes_plain(slot, n, count, iu, iv, su, sv, sre, sim, table,
                          accr, acci, ts=ts)
        return
    dev = accr.device
    NC, Mc = iu.shape
    P = sre.shape[1]
    WO, K = table.shape
    if ts not in (32, 64):
        raise NotImplementedError(f"K1 is built for ts in (32, 64), not {ts}")
    if K + ts - 1 > 2 * ts:
        raise NotImplementedError(f"K1: kernel width {K} > ts + 1")
    if Mc > MAX_CHUNK:
        raise NotImplementedError(f"K1 takes chunks of at most {MAX_CHUNK} "
                                  f"slots, not {Mc}")
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
    if n == 0:
        return
    tabs = split_table(table)
    lib = _build.load()
    err = lib.ktt_grid_planes(
        slot.data_ptr(), n, count.data_ptr(), iu.data_ptr(), iv.data_ptr(),
        su.data_ptr(), sv.data_ptr(), sre.data_ptr(), sim.data_ptr(),
        table.data_ptr(), tabs.data_ptr(), accr.data_ptr(), acci.data_ptr(),
        NC, Mc, P, K, ts, nt2, _build.stream_of(accr))
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

    CPU tensors run the plain version; CUDA tensors launch
    ``ktt_combine_planes`` (``csrc/gridder.cu``) or raise.

    Replaces ``katsdpimager_tpu/ops/pallas_gridder.py:_make_combine_kernel``.
    Bound by device memory bandwidth; one thread per output pixel,
    coalesced.  CUDA rather than Triton so all four kernels share one
    ``nvcc`` build.
    """
    if accr.device.type == "cpu":
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
        gr = torch.empty((P, pixels, pixels), dtype=torch.float32, device=dev)
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
    """(2, 2, nt2, nt2) bool: which colour-plane tiles K1 writes."""
    occ = torch.zeros(4 * nt2 * nt2, dtype=torch.bool, device=slot.device)
    occ[slot[:n].long()] = True
    return occ.view(2, 2, nt2, nt2)


def tf32_rna(x):
    """``x`` rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero: PTX ``cvt.rna.tf32.f32``), held in f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_table(table):
    """K1's B operand rows, split for 3xTF32 once per call: the (W*O, K)
    complex64 table as (W*O, K, 4) f32 ``[re hi, re lo, im hi, im lo]``,
    ``hi = tf32_rna(x)``, ``lo = tf32_rna(x - hi)``."""
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
                       n_chunks: int, *, pixels: int, ts: int,
                       plain: bool = False):
    """Prep plus K1: returns ``(accr, acci, occ)`` — the colour planes
    (unwritten blocks uninitialised) and their occupancy mask.  On the
    CPU the valid slots are checked to be a prefix of every chunk.
    ``plain`` runs K1's plain version whatever the device (the reference
    that the kernels are checked against on the card)."""
    Pp = plan_vis.shape[-1]
    K = kernel.shape[-1]
    nt2 = colour_tiles(pixels, ts)
    ext2 = nt2 * 2 * ts
    iu, iv, su, sv = tap_indices(kernel, plan_uv, plan_sub, plan_wp,
                                 plan_anchor, pixels=pixels, ts=ts)
    sre, sim = samples(plan_vis, plan_valid, weights_grid, dw_chunks,
                       plan_anchor, su, sv, kernel_width=K, ts=ts)
    slot = chunk_slots(plan_anchor, n_chunks, ts=ts, nt2=nt2)
    count = valid_counts(plan_valid)
    dev = plan_vis.device
    if dev.type == "cpu":
        check_valid_prefix(plan_valid, count)
    accr = torch.empty((2, 2, Pp, ext2, ext2), dtype=torch.float32,
                       device=dev)
    acci = torch.empty_like(accr)
    k1 = grid_planes_plain if plain else grid_planes
    k1(slot, n_chunks, count, iu, iv, su, sv, sre, sim, conj_table(kernel),
       accr, acci, ts=ts)
    return accr, acci, occupancy(slot, n_chunks, nt2)


def grid_chunks_fused_parts(kernel, weights_grid, plan_uv, plan_sub,
                            plan_wp, plan_vis, plan_anchor, plan_valid,
                            dw_chunks=None, n_chunks=None, *, pixels: int,
                            ts: int, plain: bool = False):
    """K1 then K2: one slice's chunks to cropped (P, N, N) f32
    ``(gr, gi)`` planes.  ``n_chunks`` (host int) bounds the chunks
    gridded; None counts the occupied chunks (a device sync).  ``plain``
    runs both kernels' plain versions whatever the device."""
    if n_chunks is None:
        n_chunks = occupied_chunks(plan_valid)
    accr, acci, occ = grid_chunks_planes(
        kernel, weights_grid, plan_uv, plan_sub, plan_wp, plan_vis,
        plan_anchor, plan_valid, dw_chunks, n_chunks, pixels=pixels, ts=ts,
        plain=plain)
    k2 = combine_planes_plain if plain else combine_planes
    return k2(accr, acci, occ, pixels=pixels, ts=ts)
