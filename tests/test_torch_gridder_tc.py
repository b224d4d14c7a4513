"""K1's redesign, on the CPU: the per-chunk valid counts it loops to (the
planner's valid slots are a prefix of every chunk) and the 3xTF32 numerics
of its tensor-core band product.

The emulation splits every staged operand as the kernel does, ``hi =
tf32_rna(x)`` and ``lo = tf32_rna(x - hi)`` (``fused_gridder.tf32_rna``
emulates ``cvt.rna.tf32.f32``), and sums ``lo hi + hi lo + hi hi``;
products of two TF32 values are exact in f32, so only the summation order
differs from the tensor cores.  It must hold K1's gate, 2e-5 of the
largest written value of the f32 ``grid_planes_plain``, on real kernel
rows; plain TF32 must not.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from katsdpimager_tpu_torch.ops import fused_gridder, mxu_gridder
from katsdpimager_tpu_torch.ops.fused_gridder import tf32_rna
from katsdpimager_tpu_torch.parallel import multichannel

CONFIGS = {
    # K=16 at 256 px (ts = 32), K=60 at 512 px (ts = 64, the production
    # tile and kernel width).
    16: dict(pixels=256, num_pols=1, kernel_width=16, oversample=8,
             w_planes=4, w_slices=2, chunks_per_slice=256, chunk_size=256,
             rv=32, ru=32, minor_cycles=0, weight_type="natural"),
    60: dict(pixels=512, num_pols=1, kernel_width=60, oversample=8,
             w_planes=4, w_slices=2, chunks_per_slice=256, chunk_size=256,
             rv=64, ru=64, minor_cycles=0, weight_type="natural"),
}


def _slice(K, seed=11):
    cfg = multichannel.MultiChannelConfig(**CONFIGS[K])
    batch = multichannel.make_example_batch(cfg, 1, seed=seed,
                                            vis_per_slice=6000, device="cpu")
    return cfg, batch


def _k1_args(cfg, batch, s=0):
    N, ts, K = cfg.pixels, cfg.rv, cfg.kernel_width
    kern = batch.kernel[0]
    uv, sub, wp, anc, val, vis = (x[0, s] for x in (
        batch.uv, batch.sub_uv, batch.w_plane, batch.anchor, batch.valid,
        batch.vis))
    n = int(batch.n_chunks[0, s])
    nt2 = mxu_gridder.colour_tiles(N, ts)
    iu, iv, su, sv = fused_gridder.tap_indices(kern, uv, sub, wp, anc,
                                               pixels=N, ts=ts)
    sre, sim = fused_gridder.samples(vis, val, None, None, anc, su, sv,
                                     kernel_width=K, ts=ts)
    slot = fused_gridder.chunk_slots(anc, n, ts=ts, nt2=nt2)
    count = fused_gridder.valid_counts(val)
    return (slot, n, count, iu, iv, su, sv, sre, sim,
            fused_gridder.conj_table(kern)), val, nt2


@pytest.mark.parametrize("K", [16, 60])
def test_valid_counts_are_prefixes(K):
    """On the planner's plan every chunk's valid slots are the first
    ``count``; K1 grids exactly those."""
    cfg, batch = _slice(K)
    for s in range(cfg.w_slices):
        val = batch.valid[0, s]
        count = fused_gridder.valid_counts(val)
        assert count.dtype == torch.int32
        assert torch.equal(count, val.sum(-1).to(torch.int32))
        fused_gridder.check_valid_prefix(val, count)
        n = int(batch.n_chunks[0, s])
        assert bool((count[:n] > 0).all()) and not count[n:].any()
        # real plans do have partly filled chunks
        assert bool((count[:n] < cfg.chunk_size).any())


def test_valid_prefix_violation_raises():
    val = torch.zeros((3, 8), dtype=torch.bool)
    val[0, :5] = True
    val[1, [0, 2]] = True                       # a hole at slot 1
    with pytest.raises(ValueError, match="prefix"):
        fused_gridder.check_valid_prefix(val, fused_gridder.valid_counts(val))


def test_plain_k1_grids_every_valid_slot():
    """The reference K1 is held against grids every slot with a sample,
    whatever ``count`` says: it does not share K1's prefix assumption, so
    a plan that broke it would show as a difference on the card."""
    cfg, batch = _slice(16)
    args, _, nt2 = _k1_args(cfg, batch)
    ext2 = nt2 * 2 * cfg.rv
    planes = []
    for count in (args[2], torch.zeros_like(args[2])):
        pr = torch.zeros((2, 2, 1, ext2, ext2))
        pi = torch.zeros_like(pr)
        fused_gridder.grid_planes_plain(*args[:2], count, *args[3:], pr, pi,
                                        ts=cfg.rv)
        planes.append((pr, pi))
    assert planes[0][0].abs().max().item() > 0
    for a, b in zip(*planes):
        assert torch.equal(a, b)


def _split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _product(x, y, mode):
    """sum_m x[.., m, j] y[.., m, k] over the chunk's slots, f32."""
    xt = x.transpose(-1, -2)
    if mode == "f32":
        return xt @ y
    xh, xl = _split(xt)
    yh, yl = _split(y)
    if mode == "tf32":
        return xh @ yh
    return (xl @ yh + xh @ yl) + xh @ yh         # 3xTF32


def _emulated_planes(args, nt2, *, ts, mode):
    """K1 with its band product emulated in ``mode``, in the layout of
    ``grid_planes_plain`` (blocks no run writes stay zero)."""
    slot, n, count, iu, iv, su, sv, sre, sim, table = args
    TS2 = 2 * ts
    K = table.shape[1]
    P, Mc = sre.shape[1], sre.shape[2]
    tab = torch.view_as_complex(F.pad(torch.view_as_real(table),
                                      (0, 0, 0, TS2 - K)).contiguous())
    a = fused_gridder._shifted_rows(tab, iv[:n], sv[:n], TS2)
    b = fused_gridder._shifted_rows(tab, iu[:n], su[:n], TS2)[:, None]
    live = torch.arange(Mc) < count[:n, None].long()
    s = torch.complex(sre[:n], sim[:n]) * live[:, None]
    A = a[:, None] * s[..., None]                       # (n, P, Mc, TS2)
    re = (_product(A.real, b.real, mode)
          - _product(A.imag, b.imag, mode))
    im = (_product(A.real, b.imag, mode)
          + _product(A.imag, b.real, mode))
    slot_n = slot[:n].long()
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = slot_n[1:] != slot_n[:-1]
    run = torch.cumsum(first.long(), 0) - 1
    nruns = int(first.sum())
    planes = []
    for part in (re, im):
        runs = torch.zeros((nruns, P, TS2, TS2)).index_add_(0, run, part)
        plane = torch.zeros((2, 2, P, nt2 * TS2, nt2 * TS2))
        rslot = slot_n[first]
        colour = rslot // (nt2 * nt2)
        rem = rslot - colour * (nt2 * nt2)
        p7 = plane.view(2, 2, P, nt2, TS2, nt2, TS2)
        p7[colour // 2, colour % 2, :, rem // nt2, :, rem % nt2, :] = runs
        planes.append(plane)
    return planes


@pytest.mark.parametrize("K", [16, 60])
def test_tf32x3_band_holds_the_k1_gate(K):
    cfg, batch = _slice(K)
    ts = cfg.rv
    args, _, nt2 = _k1_args(cfg, batch)
    ext2 = nt2 * 2 * ts
    pr = torch.zeros((2, 2, 1, ext2, ext2))
    pi = torch.zeros_like(pr)
    fused_gridder.grid_planes_plain(*args, pr, pi, ts=ts)
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert scale > 0

    def err(planes):
        return max((planes[0] - pr).abs().max().item(),
                   (planes[1] - pi).abs().max().item())

    assert err(_emulated_planes(args, nt2, ts=ts, mode="f32")) \
        <= 2e-6 * scale
    assert err(_emulated_planes(args, nt2, ts=ts, mode="tf32x3")) \
        <= 2e-5 * scale
    # One TF32 product keeps ~10 mantissa bits: far outside the gate.
    assert err(_emulated_planes(args, nt2, ts=ts, mode="tf32")) \
        > 2e-5 * scale


def test_split_table_is_the_kernels_split():
    """The B operand's split, as K1's producer applies it to each table
    value it stages: hi and lo in TF32 (13 low bits clear), hi + lo within
    2^-22 of each value, zeros kept."""
    rng = torch.Generator().manual_seed(3)
    table = torch.complex(torch.randn((16, 60), generator=rng),
                          torch.randn((16, 60), generator=rng))
    table[0, :4] = 0
    tabs = fused_gridder.split_table(table)
    assert tabs.shape == (16, 60, 4) and tabs.dtype == torch.float32
    bits = tabs.view(torch.int32)
    assert not bool((bits & 0x1FFF).any())
    for part, x in ((0, table.real), (2, table.imag)):
        hi, lo = tabs[..., part], tabs[..., part + 1]
        assert torch.equal(hi, tf32_rna(x))
        assert bool(((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all())
    assert not tabs[0, :4].any()


def _stretch_runs():
    """Runs at K1's stretch of ``PROMOTE_STEPS`` k-steps of 8: the middle
    run holds one k-step fewer, as many and one more, in one chunk (the
    last k-step partial) or over one chunk more with an empty chunk
    first."""
    c = fused_gridder.PROMOTE_STEPS
    runs = {}
    for k in (c - 1, c, c + 1):
        if k >= 1:
            runs[f"{k} in 1 chunk"] = ([1, 1, 1], [100, 8 * k - 3, 7])
            runs[f"{k} in {k + 1} chunks"] = (
                [1, k + 1, 1], [100, 0] + [8] * (k - 1) + [5, 7])
    return runs


#: Anchor runs at K1's promotion boundaries: (chunks per run, valid slots
#: per chunk), the middle run holding the k-steps of 8 valid slots that
#: the case's name gives, between one-chunk runs: at the stretch of
#: PROMOTE_STEPS k-steps (``_stretch_runs``); at 32 and 33, in one or
#: two chunks or over 33 and 34 chunks, one of them empty, where the
#: schedule before (promoted into the plane every 32 k-steps) changed
#: body; and at a segment of the kernel's totals.
_EIGHTS = [8] * 16 + [0] + [8] * 16
BOUNDARY_RUNS = {
    **_stretch_runs(),
    "32 in 1 chunk": ([1, 1, 1], [100, 256, 7]),
    "33 in 2 chunks": ([1, 2, 1], [100, 256, 1, 7]),
    "32 in 33 chunks": ([1, 33, 1], [100] + _EIGHTS + [7]),
    "33 in 34 chunks": ([1, 34, 1], [100] + _EIGHTS + [8, 7]),
    # one segment of totals (kSegment = 32 batches of 16), and one batch
    # more
    "64 in 2 chunks": ([1, 2, 1], [100, 256, 256, 7]),
    "65 in 3 chunks": ([1, 3, 1], [100, 256, 256, 5, 7]),
}


def run_inputs(runs, counts, *, ts, K, seed=5, Mc=256, WO=64):
    """Direct K1 inputs (the arguments of ``grid_planes`` up to the
    planes; CPU) whose anchor runs hold ``runs`` chunks with ``counts``
    valid slots, a prefix of each chunk, taps anywhere in range; and
    nt2."""
    rng = np.random.default_rng(seed)
    nt2 = 3
    NC = sum(runs)
    slots = rng.choice(4 * nt2 * nt2, size=len(runs), replace=False)
    slot = np.repeat(slots, runs).astype(np.int32)
    count = np.asarray(counts, np.int32)
    iu, iv = (rng.integers(0, WO, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    su, sv = (rng.integers(0, ts, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    live = np.arange(Mc)[None, None, :] < count[:, None, None]
    sre, sim = (np.where(live, rng.normal(size=(NC, 1, Mc)), 0.0).astype(
        np.float32) for _ in range(2))
    table = (rng.normal(size=(WO, K))
             + 1j * rng.normal(size=(WO, K))).astype(np.complex64)
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (slot, count, iu, iv, su, sv, sre, sim, table)]
    return (args[0], NC, *args[1:]), nt2


@pytest.mark.parametrize("case", list(BOUNDARY_RUNS))
def test_k1_runs_at_the_promotion_boundary(case):
    """K1 (its plain version on the CPU) on runs at the kernel's
    promotion boundaries (:data:`BOUNDARY_RUNS`): the middle run holds the
    case's k-steps of 8, every run's block is written once, as the float64 sum
    of its chunks gridded one at a time, and nothing else is written.
    ``tests/test_torch_gpu.py`` holds the kernel to this on the card, and
    ``tests/test_torch_k1_accumulation.py`` the kernel's schedule."""
    ts, K = 32, 30
    args, nt2 = run_inputs(*BOUNDARY_RUNS[case], ts=ts, K=K)
    slot, n, count = args[:3]
    runs, _ = BOUNDARY_RUNS[case]
    c0, c1 = runs[0], runs[0] + runs[1]
    ksteps = sum(-(-int(k) // 8) for k in count[c0:c1])
    assert ksteps == int(case.split()[0])
    ext2 = nt2 * 2 * ts
    shape = (2, 2, 1, ext2, ext2)
    kr, ki = (torch.full(shape, float("nan")) for _ in range(2))
    fused_gridder.grid_planes(*args, kr, ki, ts=ts)
    r64, i64 = (torch.zeros(shape, dtype=torch.float64) for _ in range(2))
    for c in range(n):
        one = [a[c:c + 1] for a in args[3:9]]
        pr, pi = (torch.zeros(shape, dtype=torch.float64) for _ in range(2))
        fused_gridder.grid_planes_plain(
            slot[c:c + 1], 1, count[c:c + 1], *one[:4], one[4].double(),
            one[5].double(), args[9].to(torch.complex128), pr, pi, ts=ts)
        r64 += pr
        i64 += pi
    occ = fused_gridder.occupancy(slot, n, nt2)
    assert int(occ.sum()) == len(runs)
    written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
        2 * ts, -1)[:, :, None]
    assert torch.equal(~torch.isnan(kr), written)
    assert torch.equal(~torch.isnan(ki), written)
    scale = max(r64.abs().max().item(), i64.abs().max().item())
    for k, ref in ((kr, r64), (ki, i64)):
        err = (k.double() - ref).abs().where(written, 0.0).max().item()
        assert err <= 1e-6 * scale, err / scale
