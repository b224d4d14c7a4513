"""K23 (K2 fused into K3's load) and the slice loop's route to it, on the
CPU: the plain version against K2's then K3's, and which route
``multichannel.image_slices`` takes (K23 on the column-DFT route with no
vis group; K2 then K3 under a vis split; K2's plain version at float64;
``torch.fft`` at sizes the kernels do not take)."""

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch.ops import fused_fft, fused_gridder, mxu_gridder
from katsdpimager_tpu_torch.parallel import mesh, multichannel

SMALL = dict(num_pols=4, kernel_width=16, oversample=8, w_planes=8,
             w_slices=2, chunks_per_slice=64, chunk_size=256, rv=32, ru=32)


def _batch(pixels=256, weight_type="natural"):
    cfg = multichannel.MultiChannelConfig(pixels=pixels, **SMALL,
                                          weight_type=weight_type)
    return cfg, multichannel.make_example_batch(cfg, 1, seed=5, device="cpu")


def _image(cfg, batch, density=None, mesh=None):
    """Channel 0's image through :func:`multichannel.image_slices`."""
    (kernel, taper, ps, mid_w, uv, sub, wp, anc, val, _, vis,
     nc) = multichannel.channel_args(batch, 0)
    return multichannel.image_slices(
        kernel, density, taper, ps, mid_w, uv, sub, wp, anc, val, vis, nc,
        pixels=cfg.pixels, ts=cfg.rv, mesh=mesh)


def _count(monkeypatch, module, name) -> list:
    """Wrap ``module.name`` so that each call appends to the list
    returned."""
    calls = []
    original = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def _route_counts(monkeypatch) -> dict:
    return {name: _count(monkeypatch, module, name) for module, name in (
        (fused_gridder, "combine_planes"),
        (fused_gridder, "combine_planes_plain"),
        (fused_fft, "cb_col_fft"),
        (fused_fft, "combine_cb_col_fft"))}


class _ViaK2(fused_fft.SliceStack):
    """:class:`fused_fft.SliceStack` by K2 then K3, and K4 once a slice:
    the slice loop's route before K23."""

    def add(self, groups, w):
        gr = torch.empty(self.imageT.shape, device=self.imageT.device)
        gi = torch.empty_like(gr)
        for p0, p1, accr, acci, occ in groups:
            gr[p0:p1], gi[p0:p1] = fused_gridder.combine_planes(
                accr, acci, occ, pixels=self.pixels, ts=self.ts)
        fused_fft.grid_to_image_fused_parts(gr, gi, self.imageT, self.taper,
                                            w, self.pixel_size)


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_plain_k23_is_k2_then_k3():
    """The plain K23 on a slice's colour planes, whose unwritten blocks
    hold NaN, is K2's plain version then K3's, bit for bit; with ``out``
    views it writes those planes of a larger pair and no other."""
    cfg, batch = _batch()
    N, ts = cfg.pixels, cfg.rv
    args = multichannel.channel_args(batch, 0)
    kernel = args[0]
    uv, sub, wp, anc, val, vis = (x[0] for x in args[4:9] + args[10:11])
    [(p0, p1, accr, acci, occ)] = list(fused_gridder.slice_planes(
        kernel, None, uv, sub, wp, vis, anc, val, pixels=N, ts=ts))
    assert (p0, p1) == (0, cfg.num_pols)
    written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
        2 * ts, -1)[:, :, None]
    assert bool(occ.any()) and not bool(written.all())
    accr.masked_fill_(~written, float("nan"))
    acci.masked_fill_(~written, float("nan"))
    got = fused_fft.combine_cb_col_fft(accr, acci, occ, pixels=N, ts=ts)
    want = fused_fft.cb_col_fft_plain(*fused_gridder.combine_planes_plain(
        accr, acci, occ, pixels=N, ts=ts))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(_bits(g), _bits(w))
    P = cfg.num_pols
    yr, yi = (torch.full((P + 2, N, N), 7.0) for _ in range(2))
    out = fused_fft.combine_cb_col_fft(accr, acci, occ, pixels=N, ts=ts,
                                       out=(yr[1:1 + P], yi[1:1 + P]))
    assert out[0].data_ptr() == yr[1].data_ptr()
    for y, w in zip((yr, yi), want):
        assert torch.equal(_bits(y[1:1 + P]), _bits(w))
        assert bool((y[0] == 7.0).all()) and bool((y[-1] == 7.0).all())


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_slice_loop_takes_k23(monkeypatch, weight_type):
    """At a size the column-DFT kernels take, with no mesh, the slice loop
    sends each non-empty slice's colour planes to K23 once and calls
    neither K2 nor K3; its image is bitwise the one through K2 then
    K3."""
    cfg, batch = _batch(weight_type=weight_type)
    density = None
    if weight_type == "uniform":
        c = multichannel.channel_args(batch, 0)
        density = multichannel._density(cfg, c[4], c[7], c[8], c[9])
    counts = _route_counts(monkeypatch)
    got = _image(cfg, batch, density)
    nonempty = sum(int(n) > 0 for n in batch.n_chunks[0])
    assert nonempty > 0
    assert {k: len(v) for k, v in counts.items()} == {
        "combine_planes": 0, "combine_planes_plain": 0, "cb_col_fft": 0,
        "combine_cb_col_fft": nonempty}
    monkeypatch.setattr(fused_fft, "SliceStack", _ViaK2)
    want = _image(cfg, batch, density)
    assert len(counts["combine_planes"]) == nonempty
    assert len(counts["cb_col_fft"]) == nonempty
    assert torch.equal(_bits(got), _bits(want))


def test_slice_loop_k23_by_polarization_groups(monkeypatch):
    """With the accumulator cap forcing several polarization groups, K23
    writes each group's planes of one pair: the image is bitwise the
    joint one, and the one through K2 then K3 with the same groups."""
    cfg, batch = _batch()
    joint = _image(cfg, batch)
    monkeypatch.setattr(mxu_gridder, "MAX_ACC_GB", 0.007)
    groups = len(mxu_gridder.pol_groups(cfg.num_pols, cfg.pixels, cfg.rv))
    assert groups > 1
    calls = _count(monkeypatch, fused_fft, "combine_cb_col_fft")
    split = _image(cfg, batch)
    nonempty = sum(int(n) > 0 for n in batch.n_chunks[0])
    assert len(calls) == groups * nonempty
    monkeypatch.setattr(fused_fft, "SliceStack", _ViaK2)
    via_k2 = _image(cfg, batch)
    assert torch.equal(_bits(split), _bits(joint))
    assert torch.equal(_bits(split), _bits(via_k2))


def test_vis_split_takes_k2_then_k3(monkeypatch):
    """Under a mesh whose vis group has 2 ranks, the slice's grid must be
    summed over the group before the transform: K2 makes it, the group
    sums it (here an identity standing in for the all-reduce), K3 takes
    it; K23 is not called.  With the sum an identity the image is
    bitwise the unsharded one."""
    cfg, batch = _batch()
    want = _image(cfg, batch)
    counts = _route_counts(monkeypatch)
    sums = []

    def psum(x, m):
        assert m is split
        sums.append(x.shape)
        return x

    monkeypatch.setattr(multichannel, "psum", psum)
    split = mesh.Mesh(rank=0, world=2, chan_index=0, chan_size=1,
                      vis_index=0, vis_size=2, vis_group=None,
                      device=torch.device("cpu"))
    got = _image(cfg, batch, mesh=split)
    nonempty = sum(int(n) > 0 for n in batch.n_chunks[0])
    # on the CPU K2 runs its plain version
    assert {k: len(v) for k, v in counts.items()} == {
        "combine_planes": nonempty, "combine_planes_plain": nonempty,
        "cb_col_fft": nonempty, "combine_cb_col_fft": 0}
    assert len(sums) == 2 * nonempty
    assert torch.equal(_bits(got), _bits(want))


def test_double_takes_k2(monkeypatch):
    """At float64 (``--precision double``) K2's plain version adds the
    colour planes onto a float64 grid, once a non-empty slice, without
    the float32 wrapper, and the transform is ``torch.fft``: neither K3
    nor K23 is called."""
    cfg, batch = _batch()
    db = batch._replace(taper1d=batch.taper1d.double(),
                        pixel_size=batch.pixel_size.double(),
                        mid_w=batch.mid_w.double(),
                        vis=batch.vis.to(torch.complex128))
    counts = _route_counts(monkeypatch)
    image = _image(cfg, db)
    nonempty = sum(int(n) > 0 for n in batch.n_chunks[0])
    assert image.dtype == torch.float64
    assert {k: len(v) for k, v in counts.items()} == {
        "combine_planes": 0, "combine_planes_plain": nonempty,
        "cb_col_fft": 0, "combine_cb_col_fft": 0}


def test_size_off_the_kernels_takes_k2(monkeypatch):
    """At 264 px (no power of two) the transform takes ``torch.fft`` by
    rule, so the slice loop grids through K2 and calls neither K3 nor
    K23."""
    cfg, batch = _batch(pixels=264)
    counts = _route_counts(monkeypatch)
    image = _image(cfg, batch)
    nonempty = sum(int(n) > 0 for n in batch.n_chunks[0])
    assert image.shape == (cfg.num_pols, 264, 264)
    assert {k: len(v) for k, v in counts.items()} == {
        "combine_planes": nonempty, "combine_planes_plain": nonempty,
        "cb_col_fft": 0, "combine_cb_col_fft": 0}


# ---------------------------------------------------------------------------
# K23's sums, without the card: a numpy model of how each thread of
# ``combine_cb_col_fft_kernel`` (``csrc/fft.cu``) works out which terms
# of its values are present (each value's tile row from the last one's by
# an add), where it reads each term (a pointer stepped from value to
# value), the sum in K2's order, the checkerboard sign and the tile slot it
# stores the sum in, against K2's grid and the slots that the tile core's
# pass 1 reads each value from.

_COLS, _PER_THREAD = 16, 32

#: (R, R1, Q) of every N the tile kernels take (``with_plan``).
_PLANS = {256: (256, 16, 1), 512: (512, 32, 1), 1024: (512, 32, 2),
          2048: (512, 32, 4), 4096: (512, 32, 8), 8192: (1024, 32, 8)}


def _floor_div(x, d):
    """The kernel's floor division of a row that may lie above the plane."""
    return np.where(x >= 0, x // d, -((d - 1 - x) // d))


def _presence(occ, nt2, ts, pr0, tc, step, items):
    """(items, ...) bool: whether term (a, b) of item k, plane row pr0 +
    k step in planes (a, .), column tile tc, is present, by the kernel's
    stepping (tile row tr, remainder rem, each from the last by an add)."""
    ts2 = 2 * ts
    dq, dr = step // ts2, step % ts2
    tr = _floor_div(pr0, ts2)
    rem = pr0 - tr * ts2
    out = []
    for _ in range(items):
        ok = (tr >= 0) & (tc >= 0)
        out.append(ok & occ[np.maximum(tr, 0), np.maximum(tc, 0)])
        tr, rem = tr + dq, rem + dr
        over = rem >= ts2
        tr, rem = np.where(over, tr + 1, tr), np.where(over, rem - ts2, rem)
    return np.stack(out)


def _k23_slots(planes, occ, N, ts, q, c0):
    """The CTA's tile slots as the kernel's sums leave them: (R kCols,)
    complex64, each slot written once (NaN where none is)."""
    R, R1, Q = _PLANS[N]
    threads = R * _COLS // _PER_THREAD
    kRR = R // R1
    nt2 = occ.shape[-1]
    ext2 = nt2 * 2 * ts
    flat = planes.reshape(2, -1)                     # re, im
    colour = planes.shape[3] * ext2 * ext2
    slots = np.full(R * _COLS, np.nan, np.complex64)
    t = np.arange(threads)
    NB = _PER_THREAD // R1
    # value (u, i) of thread t: local row j + i kRR, j = (t + u threads) / 16
    j = np.concatenate([(t + u * threads) // _COLS for u in range(NB)])
    col = np.tile(c0 + t % _COLS, NB)
    step = Q * kRR
    k = np.arange(R1)[:, None]
    sums = None
    for ab in range(4):
        a, b = ab >> 1, ab & 1
        pr0 = q + Q * j - a * ts
        pc = col - b * ts
        tc = np.where(pc >= 0, pc // (2 * ts), -1)
        here = _presence(occ[a, b], nt2, ts, pr0, tc, step, R1)
        off = np.where(here, ab * colour + (pr0 + k * step) * ext2 + pc, 0)
        x = [np.where(here, part[off], np.float32(0)) for part in flat]
        sums = x if sums is None else [sums[0] + x[0], sums[1] + x[1]]
    r = q + Q * (j + k * kRR)
    sign = np.where((r + col) & 1, np.float32(-1), np.float32(1))
    slot = (j * R1 + k) * _COLS + (col - c0)
    assert len(np.unique(slot)) == slot.size == R * _COLS
    slots[slot] = (sign * sums[0]) + 1j * (sign * sums[1])
    return slots


@pytest.mark.parametrize("N,ts", [(256, 1), (256, 3), (256, 8), (256, 128),
                                  (512, 50), (1024, 16), (1024, 64),
                                  (2048, 50), (2048, 64), (2048, 256)])
def test_k23_sums_model(N, ts):
    """For the CTAs of a few column tiles at every cluster rank, the tile
    slots the kernel's sums leave are each written once, hold K2's grid
    value at their row and column in K2's add order and the checkerboard
    sign, bit for bit (NaN in every unwritten block, which must never be
    read), and are the slots pass 1 reads each value from: value i of the
    thread at (j, c) is plane row q + Q (j + i R / R1), slot (j R1 + i) 16
    + c.  (N = 4096 and 8192 differ only in the plan's Q and R; the
    card tests hold the kernel bitwise there.)"""
    rng = np.random.default_rng(N + ts)
    nt2 = mxu_gridder.colour_tiles(N, ts)
    ext2 = nt2 * 2 * ts
    assert ext2 >= N + ts
    occ = rng.random((2, 2, nt2, nt2)) < 0.6
    planes = rng.standard_normal((2, 2, 2, 1, ext2, ext2), np.float32)
    written = occ.repeat(2 * ts, -2).repeat(2 * ts, -1)[:, :, None]
    for part in planes:
        part[~written] = np.nan
    gr, gi = fused_gridder.combine_planes_plain(
        torch.from_numpy(planes[0]), torch.from_numpy(planes[1]),
        torch.from_numpy(occ), pixels=N, ts=ts)
    gr, gi = gr.numpy()[0], gi.numpy()[0]
    cb = np.where((np.arange(N)[:, None] + np.arange(N)[None]) & 1,
                  np.float32(-1), np.float32(1))
    R, R1, Q = _PLANS[N]
    kRR = R // R1
    tiles = N // _COLS
    for c0 in sorted({0, 1, tiles - 1, *rng.integers(0, tiles, 1).tolist()}):
        c0 *= _COLS
        r2, c = np.divmod(np.arange(R * _COLS), _COLS)
        j, i = r2 % kRR, r2 // kRR
        for q in range(Q):
            r = q + Q * (j + i * kRR)
            want = cb[r, c0 + c] * gr[r, c0 + c] \
                + 1j * (cb[r, c0 + c] * gi[r, c0 + c])
            want = want.astype(np.complex64)
            slot = (j * R1 + i) * _COLS + c
            got = _k23_slots(planes, occ, N, ts, q, c0)
            np.testing.assert_array_equal(got[slot].view(np.int32),
                                          want.view(np.int32))
