"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device.  Run them on a
machine with one, without the JAX test configuration (that machine has
no JAX): ``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``.
"""

import contextlib

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch import device
from katsdpimager_tpu_torch.ops import (clean, fused_degrid, fused_fft,
                                        fused_gridder, mxu_gridder)
from katsdpimager_tpu_torch.parallel import cube, multichannel
from test_torch_k1_schedule import k1_schedule
from test_torch_k23 import _ViaK2
from test_torch_weight_grid import add_at

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _plan_case(seed, *, pixels, K, ts, P, n, mc=256, w_planes=4, O=8):
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=(w_planes, O, K))
              + 1j * rng.normal(size=(w_planes, O, K))).astype(np.complex64)
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, O, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, P))
           + 1j * rng.normal(size=(n, P))).astype(np.complex64)
    wg = rng.uniform(0.5, 2.0, size=(P, pixels, pixels)).astype(np.float32)
    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub, wp, vis, np.ones_like(vis, np.float32), pixels=pixels,
        kernel_width=K, ts=ts, mc=mc)
    return kernel, wg, plan


def _versions(plain):
    """The block in which the plain versions run (``plain``), or the
    kernels."""
    return device.plain_versions() if plain else contextlib.nullcontext()


def _planes(dev, kernel, wg, plan, *, pixels, ts, plain):
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
         (kernel, wg, plan.uv, plan.sub_uv, plan.w_plane, plan.vis,
          plan.anchor, plan.valid)]
    n = int(plan.valid.any(axis=1).sum())
    with _versions(plain):
        return fused_gridder.grid_chunks_planes(*t, None, n, pixels=pixels,
                                                ts=ts)


#: K1's tile sizes beyond 32 and 64, each with K = ts + 1 (K <= 256) and
#: a smaller K (the ``tiles`` phase of ``chip_smoke.py``): 8-31 below
#: 256 px, 33-63 at 264-504 px, ts = K above 64 per channel, 128 and 256
#: in the cube.
TILE_CASES = [(8, 9), (8, 5), (16, 17), (16, 12), (33, 34), (33, 20),
              (50, 51), (50, 30), (96, 97), (96, 60), (128, 129),
              (128, 100), (256, 256), (256, 200)]


@pytest.mark.parametrize("ts,K,P", [(64, 60, 1), (64, 16, 2), (32, 16, 1)]
                         + [(ts, min(K, ts), 1) for ts, K in TILE_CASES])
def test_k1_k2_match_plain(cuda, ts, K, P):
    """K1's written blocks within 2e-5 of peak of the plain version (f32
    summation order); K2 bitwise on the same planes.  Planner inputs
    (the planner takes K <= ts)."""
    pixels = 1024
    kernel, wg, plan = _plan_case(1, pixels=pixels, K=K, ts=ts, P=P,
                                  n=20000)
    ar, ai, occ = _planes(cuda, kernel, wg, plan, pixels=pixels, ts=ts,
                          plain=False)
    pr, pi, pocc = _planes(cuda, kernel, wg, plan, pixels=pixels, ts=ts,
                           plain=True)
    torch.cuda.synchronize()
    assert torch.equal(occ, pocc)
    gk = fused_gridder.combine_planes(ar, ai, occ, pixels=pixels, ts=ts)
    gp = fused_gridder.combine_planes_plain(pr, pi, occ, pixels=pixels,
                                            ts=ts)
    scale = max(gp[0].abs().max().item(), gp[1].abs().max().item())
    for k, p in zip(gk, gp):
        assert torch.isfinite(k).all()
        assert (k - p).abs().max().item() <= 2e-5 * scale
    # K2 on identical inputs is bitwise equal to its plain version
    same = fused_gridder.combine_planes_plain(ar, ai, occ, pixels=pixels,
                                              ts=ts)
    for k, p in zip(gk, same):
        assert torch.equal(k, p)


def test_cli_at_ts_50_matches_host(cuda):
    """The per-channel CLI at 400 px, K = 16 (tile size 50, which K1 took
    no time before) on the card against the same run on the CPU
    (``--host``, the plain versions): images within 1e-4 of the dirty
    peak inside the anti-aliased field, the same components there; K1
    and K5 launched."""
    import chip_smoke
    from katsdpimager_tpu_torch import arguments, frontend, imager
    from katsdpimager_tpu_torch.ops import wkernel

    pixels = 400
    assert mxu_gridder.tile_size(pixels, 16) == 50
    dataset, _ = chip_smoke.sim_dataset(16, 128, 1, noise_jy=0.5)
    argv = ["simulated", "unused_%c.fits", "--pixels", str(pixels),
            "--kernel-width", "16", "--major", "2", "--degrid",
            "--no-tmp-file", "--vis-block", "1024"]

    def run(device):
        args = imager.get_parser().parse_args(
            argv, namespace=arguments.SmartNamespace())
        cap = {}

        class Capture(frontend.Writer):
            def needs_fits_image(self, name):
                return name in ("dirty", "model", "clean")

            def needs_fits_grid(self, name):
                return False

            def write_fits_image(self, name, desc, ds, image, ip, ch,
                                 beam=None, bunit=None):
                cap[name] = np.array(image)

            def write_fits_grid(self, *a, **k):
                pass

        frontend.run(args, dataset, Capture(), device=device)
        return cap

    fused_gridder.grid_planes.launches = 0
    fused_degrid.degrid_planes.launches = 0
    got = run(cuda)
    assert fused_gridder.grid_planes.launches > 0
    assert fused_degrid.degrid_planes.launches > 0
    ref = run(torch.device("cpu"))
    taper = wkernel.taper(pixels, 7.0, 8, wkernel.default_beta(7.0))
    t2 = np.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    peak = np.abs(ref["dirty"]).max()
    for name in ("dirty", "model", "clean"):
        assert np.isfinite(got[name]).all()
        assert np.abs(got[name] - ref[name])[:, inside].max() <= 1e-4 * peak
    np.testing.assert_array_equal((got["model"] != 0)[:, inside],
                                  (ref["model"] != 0)[:, inside])


def test_k2_masks_nan(cuda):
    """Unwritten colour-plane blocks poisoned with NaN never reach the
    combined grid."""
    pixels, ts, K = 512, 64, 16
    kernel, wg, plan = _plan_case(2, pixels=pixels, K=K, ts=ts, P=1, n=300)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in
         (kernel, plan.uv, plan.sub_uv, plan.w_plane, plan.vis,
          plan.anchor, plan.valid)]
    kern, uv, sub, wp, vis, anc, val = t
    n = int(plan.valid.any(axis=1).sum())
    nt2 = mxu_gridder.colour_tiles(pixels, ts)
    iu, iv, su, sv = fused_gridder.tap_indices(kern, uv, sub, wp, anc,
                                               pixels=pixels, ts=ts)
    sre, sim = fused_gridder.samples(vis, val, None, None, anc, su, sv,
                                     kernel_width=K, ts=ts)
    slot = fused_gridder.chunk_slots(anc, n, ts=ts, nt2=nt2)
    ext2 = nt2 * 2 * ts
    accr = torch.full((2, 2, 1, ext2, ext2), float("nan"), device=cuda)
    acci = torch.full_like(accr, float("nan"))
    fused_gridder.grid_planes(slot, n, fused_gridder.valid_counts(val),
                              iu, iv, su, sv, sre, sim,
                              fused_gridder.conj_table(kern), accr, acci,
                              ts=ts)
    occ = fused_gridder.occupancy(slot, n, nt2)
    gr, gi = fused_gridder.combine_planes(accr, acci, occ, pixels=pixels,
                                          ts=ts)
    assert torch.isfinite(gr).all() and torch.isfinite(gi).all()
    assert gr.abs().max().item() > 0


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192])
def test_k3_k4_match_plain(cuda, n):
    """K3 and K4 on the tile core at every size it takes (two planes up
    to 2048, clusters of 2 and 4 among them) within 1e-5 of the largest
    output of their plain versions (f32 transforms in another order)."""
    gen = torch.Generator(device="cpu").manual_seed(n)
    P = 1 if n > 2048 else 2
    gr = torch.randn((P, n, n), generator=gen).to(cuda)
    gi = torch.randn((P, n, n), generator=gen).to(cuda)
    img = torch.randn((P, n, n), generator=gen).to(cuda)
    taper = (0.5 + torch.rand(n, generator=gen)).to(cuda)
    scal = torch.tensor([700.0, 1.0 / (n * 16)], device=cuda)
    kr, ki = fused_fft.cb_col_fft(gr, gi)
    pr, pi = fused_fft.cb_col_fft_plain(gr, gi)
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert (kr - pr).abs().max().item() <= 1e-5 * scale
    assert (ki - pi).abs().max().item() <= 1e-5 * scale
    out_k = fused_fft.epi_col_fft(pr, pi, img.clone(), taper, scal)
    out_p = fused_fft.epi_col_fft_plain(pr, pi, img.clone(), taper, scal)
    scale = out_p.abs().max().item()
    assert (out_k - out_p).abs().max().item() <= 1e-5 * scale


def _nan_unwritten(accr, acci, occ, ts):
    """Fill the colour-plane blocks that ``occ`` marks unwritten with NaN,
    in place: whatever reads them shows."""
    written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
        2 * ts, -1)[:, :, None]
    for plane in (accr, acci):
        plane.masked_fill_(~written, float("nan"))


def _k2_then_k3(accr, acci, occ, *, pixels, ts):
    """K3 on K2's grid, the route K23 replaces."""
    return fused_fft.cb_col_fft(*fused_gridder.combine_planes(
        accr, acci, occ, pixels=pixels, ts=ts))


def _bitwise(got, want):
    """Each pair of f32 tensors equal bit for bit (signed zeros and NaNs
    too)."""
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


#: K23's sizes: every N of the column-DFT kernels, at tile sizes 8, 50
#: (a ts that is no multiple of 16: a 16-column segment crosses colour
#: tiles), 64 and 128.
K23_CASES = [(n, ts) for n in (256, 512, 1024, 2048, 4096, 8192)
             for ts in (8, 50, 64, 128)]


@pytest.mark.parametrize("n,ts", K23_CASES)
def test_k23_is_k2_then_k3(cuda, n, ts):
    """K23 bitwise equal to K3 on K2's grid, on planner output whose
    unwritten colour-plane blocks hold NaN, and to its plain version
    within 1e-5 of the peak; with ``out`` views of a larger pair it writes
    only those planes."""
    P = 2 if n <= 2048 else 1
    K = min(16, ts)
    kernel, wg, plan = _plan_case(n + ts, pixels=n, K=K, ts=ts, P=P,
                                  n=20000)
    accr, acci, occ = _planes(cuda, kernel, wg, plan, pixels=n, ts=ts,
                              plain=False)
    _nan_unwritten(accr, acci, occ, ts)
    launches = fused_fft.combine_cb_col_fft.launches
    got = fused_fft.combine_cb_col_fft(accr, acci, occ, pixels=n, ts=ts)
    assert fused_fft.combine_cb_col_fft.launches == launches + 1
    want = _k2_then_k3(accr, acci, occ, pixels=n, ts=ts)
    torch.cuda.synchronize()
    assert bool(occ.any()) and not bool(occ.all())
    assert all(torch.isfinite(g).all() for g in got)
    assert _bitwise(got, want)
    with device.plain_versions():
        plain = fused_fft.combine_cb_col_fft(accr, acci, occ, pixels=n,
                                             ts=ts)
    scale = max(p.abs().max().item() for p in plain)
    assert max((g - p).abs().max().item()
               for g, p in zip(got, plain)) <= 1e-5 * scale
    # Into planes 1 : 1 + P of a (P + 2)-plane pair: the others untouched.
    yr, yi = (torch.full((P + 2, n, n), 7.0, device=cuda) for _ in range(2))
    fused_fft.combine_cb_col_fft(accr, acci, occ, pixels=n, ts=ts,
                                 out=(yr[1:1 + P], yi[1:1 + P]))
    assert _bitwise((yr[1:1 + P], yi[1:1 + P]), want)
    for y in (yr, yi):
        assert bool((y[0] == 7.0).all()) and bool((y[-1] == 7.0).all())


def _production_batch(dev, P, weight_type="natural", channels=1):
    """The production batch (``chip_smoke.py``'s step: 4096 px, K = 60,
    ts 64, 4 slices of 2^19 visibilities a channel) and its config."""
    cfg = multichannel.MultiChannelConfig(
        pixels=4096, num_pols=P, kernel_width=60, oversample=8,
        w_planes=32, w_slices=4, chunks_per_slice=8192, chunk_size=256,
        rv=64, ru=64, minor_cycles=0, weight_type=weight_type)
    return cfg, multichannel.make_example_batch(
        cfg, channels, vis_per_slice=1 << 19, device=dev)


@pytest.mark.parametrize("P", [1, 4])
def test_k23_production_slices_are_k2_then_k3(cuda, P):
    """K23 bitwise equal to K3 on K2's grid at the production batch's four
    slices of channel 0, in Stokes I and in full Stokes, with NaN in the
    unwritten colour-plane blocks."""
    cfg, batch = _production_batch(cuda, P)
    N, ts = cfg.pixels, cfg.rv
    for s in range(cfg.w_slices):
        n = int(batch.n_chunks[0, s])
        accr, acci, occ = fused_gridder.grid_chunks_planes(
            batch.kernel[0], None, batch.uv[0, s], batch.sub_uv[0, s],
            batch.w_plane[0, s], batch.vis[0, s], batch.anchor[0, s],
            batch.valid[0, s], None, n, pixels=N, ts=ts)
        _nan_unwritten(accr, acci, occ, ts)
        got = fused_fft.combine_cb_col_fft(accr, acci, occ, pixels=N, ts=ts)
        want = _k2_then_k3(accr, acci, occ, pixels=N, ts=ts)
        torch.cuda.synchronize()
        assert n > 0 and got[0].shape == (P, N, N)
        assert _bitwise(got, want), s


@pytest.mark.parametrize("weight_type,P", [("natural", 1), ("uniform", 1),
                                           ("natural", 4)])
def test_k23_steps_are_k2_then_k3(cuda, monkeypatch, weight_type, P):
    """The 8-channel production steps (natural, uniform and IQUV) through
    K23 and K4 over each channel's slices give images bitwise equal to the
    same steps with the slice loop routed through K2 then K3 and K4 once a
    slice (the route before K23); the step launches K23 once a non-empty
    slice, K4 once a channel over all its non-empty slices, and K2 and K3
    not at all."""
    cfg, batch = _production_batch(cuda, P, weight_type, channels=8)
    step = multichannel.single_channel_step(cfg)
    counters = (fused_gridder.combine_planes, fused_fft.cb_col_fft,
                fused_fft.combine_cb_col_fft, fused_fft.epi_col_fft)
    for fn in counters:
        fn.launches = 0
    fused_fft.epi_col_fft.slices = 0
    got = [step(*multichannel.channel_args(batch, c))[0] for c in range(8)]
    torch.cuda.synchronize()
    nonempty = int((batch.n_chunks > 0).sum())
    channels = int((batch.n_chunks > 0).any(dim=1).sum())
    assert [fn.launches for fn in counters] == [0, 0, nonempty, channels]
    assert fused_fft.epi_col_fft.slices == nonempty
    monkeypatch.setattr(fused_fft, "SliceStack", _ViaK2)
    want = [step(*multichannel.channel_args(batch, c))[0] for c in range(8)]
    assert fused_gridder.combine_planes.launches == nonempty
    assert fused_fft.cb_col_fft.launches == nonempty
    assert fused_fft.epi_col_fft.launches == channels + nonempty
    for c, (g, w) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all())
        assert _bitwise((g,), (w,)), c


@pytest.mark.parametrize("n", [512, 4096])
def test_k4_accumulates(cuda, n):
    """K4 applied twice to the same image adds both updates, as its plain
    version does twice."""
    gen = torch.Generator(device="cpu").manual_seed(n + 1)
    P = 2
    ar, ai, img = (torch.randn((P, n, n), generator=gen).to(cuda)
                   for _ in range(3))
    taper = (0.5 + torch.rand(n, generator=gen)).to(cuda)
    scal = torch.tensor([300.0, 1.0 / (n * 16)], device=cuda)
    out_k, out_p = img.clone(), img.clone()
    for _ in range(2):
        fused_fft.epi_col_fft(ar, ai, out_k, taper, scal)
        fused_fft.epi_col_fft_plain(ar, ai, out_p, taper, scal)
    torch.cuda.synchronize()
    scale = (out_p - img).abs().max().item()
    assert (out_k - out_p).abs().max().item() <= 1e-5 * scale


#: (N, P, S) of the one-launch K4 against S one-slice launches: every N
#: of the kernels, P 1 and 4, S 1-6.
K4_SLICES_CASES = [(256, 1, 6), (256, 4, 3), (512, 1, 5), (512, 4, 2),
                   (1024, 1, 4), (1024, 4, 1), (2048, 1, 3), (2048, 4, 6),
                   (4096, 1, 4), (4096, 4, 4), (4096, 1, 1), (8192, 4, 6),
                   (8192, 1, 2), (8192, 4, 1)]


@pytest.mark.parametrize("n,P,S", K4_SLICES_CASES)
def test_k4_slices_are_one_slice_launches(cuda, n, P, S):
    """K4 over S slices in one launch is bitwise S one-slice launches in
    slice order (the route of one launch a slice), from a zero image and
    from a random one, with a w of its own a slice; it counts one launch
    and S slices."""
    gen = torch.Generator(device="cpu").manual_seed(n + 10 * P + S)
    xr, xi = (torch.randn((S, P, n, n), generator=gen).to(cuda)
              for _ in range(2))
    start = torch.randn((P, n, n), generator=gen).to(cuda)
    taper = (0.5 + torch.rand(n, generator=gen)).to(cuda)
    scal = torch.tensor([[150.0 * s - 400.0, 1.0 / (n * 16)]
                         for s in range(S)], device=cuda)
    for img0 in (torch.zeros_like(start), start):
        launches = fused_fft.epi_col_fft.launches
        slices = fused_fft.epi_col_fft.slices
        got = fused_fft.epi_col_fft(xr, xi, img0.clone(), taper, scal)
        assert (fused_fft.epi_col_fft.launches - launches,
                fused_fft.epi_col_fft.slices - slices) == (1, S)
        want = img0.clone()
        for s in range(S):
            fused_fft.epi_col_fft(xr[s], xi[s], want, taper, scal[s])
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert _bitwise((got,), (want,))


def test_kernels_reject_unsupported(cuda):
    x = torch.zeros((1, 384, 384), device=cuda)
    taper = torch.ones(384, device=cuda)
    scal = torch.tensor([0.0, 1e-4], device=cuda)
    with pytest.raises(NotImplementedError):
        fused_fft.cb_col_fft(x, x)
    with pytest.raises(NotImplementedError):
        fused_fft.pre_col_fft(x, taper, scal)
    with pytest.raises(NotImplementedError):
        fused_fft.cbout_col_fft(x, x)
    y = torch.zeros((1, 256, 256), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        fused_fft.cb_col_fft(y, y)


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_step_matches_plain(cuda, weight_type):
    cfg = multichannel.MultiChannelConfig(
        pixels=512, num_pols=1, kernel_width=16, oversample=8, w_planes=8,
        w_slices=2, chunks_per_slice=256, chunk_size=128, rv=32, ru=32,
        weight_type=weight_type)
    batch = multichannel.make_example_batch(cfg, 1, seed=3, device=cuda)
    args = multichannel.channel_args(batch, 0)
    got = multichannel.single_channel_step(cfg)(*args)[0]
    with device.plain_versions():
        ref = multichannel.single_channel_step(cfg)(*args)[0]
    taper = batch.taper1d[0]
    t2 = torch.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    peak = ref.abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - ref).abs()[:, inside].max().item() <= 1e-4 * peak


def test_full_stokes_8192_step_takes_two_groups(cuda, monkeypatch):
    """One channel of ``mkat_l_8k_iquv`` (8192 px, P = 4, 6 W slices of
    349,525 visibilities, 16384 chunks a slice) through
    ``single_channel_step``: every slice takes two polarisation groups,
    K4 takes the six slices in one launch, each Stokes plane lies within
    the cell's ``dirty_err`` limit of its own peak from the float64
    reference at sampled pixels, and the step's peak memory holds one
    group's colour planes at a time (the batch, the image and its
    transposed copy, one group's planes, K23's stack of six pairs and
    2 GB).  With no memory free for a deeper stack, K4 takes one slice a
    launch, and the image is bitwise the same."""
    from portbench import manifest
    from portbench.reference import imaging as reference
    from portbench.runners import dirty_step

    cell = manifest.cell("mkat_l_8k_iquv.dirty")
    conf, traffic = cell.config, dict(cell.traffic, channels=1)
    cfg = dirty_step.step_config(conf)
    N, P, ts, S = cfg.pixels, cfg.num_pols, cfg.rv, cfg.w_slices
    seed = 2 ** 31 + 26
    batch, draws, _ = dirty_step.program_batch(conf, traffic, seed, cuda)
    assert [len(d.uv) for d in draws[0]] == [traffic["vis_per_slice"]] * S
    groups = mxu_gridder.pol_groups(P, N, ts)
    assert groups == [(0, 2), (2, 4)]
    step = multichannel.single_channel_step(cfg)
    args = multichannel.channel_args(batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = fused_gridder.grid_planes.launches
    k4 = fused_fft.epi_col_fft.launches, fused_fft.epi_col_fft.slices
    image = step(*args)[0]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    nonempty = int((batch.n_chunks[0] > 0).sum())
    assert nonempty == S
    assert fused_gridder.grid_planes.launches - launches == 2 * S
    assert (fused_fft.epi_col_fft.launches - k4[0],
            fused_fft.epi_col_fft.slices - k4[1]) == (1, S)

    batch_bytes = sum(t.numel() * t.element_size() for t in (
        batch.uv, batch.sub_uv, batch.w_plane, batch.anchor, batch.valid,
        batch.weights, batch.vis, batch.kernel, batch.taper1d,
        batch.pixel_size, batch.mid_w))
    ext2 = mxu_gridder.colour_tiles(N, ts) * 2 * ts
    group_bytes = 2 * 4 * 2 * ext2 * ext2 * 4
    image_bytes = P * N * N * 4
    pair_bytes = 2 * image_bytes
    assert peak < (batch_bytes + 2 * image_bytes + group_bytes
                   + S * pair_bytes + 2e9), peak

    monkeypatch.setattr(device, "free_memory", lambda dev: 0)
    k4 = fused_fft.epi_col_fft.launches
    one_a_slice = step(*args)[0]
    assert fused_fft.epi_col_fft.launches - k4 == S
    assert _bitwise((one_a_slice,), (image,))
    del one_a_slice

    rows, cols = reference.sample_axes(
        seed, reference.wkernel.taper(N, conf["antialias_width"],
                                      cfg.oversample),
        traffic["sample_axis"])
    got = image[:, torch.as_tensor(rows, device=cuda)][
        :, :, torch.as_tensor(cols, device=cuda)].double().cpu()
    del image, args, batch
    freq = dirty_step.frequencies(traffic)[0]
    ch = reference.Channel.of(reference.C_M_PER_S / freq, conf, cuda)
    ref = ch.image(reference.weighted(draws[0], pixels=N,
                                      weight_type="natural"),
                   rows, cols).cpu()
    limit = traffic["limits"]["dirty_err"]
    for p in range(P):
        err = ((got[p] - ref[p]).abs().max() / ref[p].abs().max()).item()
        assert err <= limit, (p, err)


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192])
def test_k6_k7_match_plain(cuda, n):
    """K6 and K7 on the tile core at every size it takes within 1e-5 of
    the peak of their plain versions (f32 DFT rounding in another order),
    on a CLEAN-like model in the central half of the image."""
    gen = torch.Generator(device="cpu").manual_seed(n)
    P = 1 if n > 1024 else 2
    model = torch.zeros((P, n, n))
    yx = torch.randint(n // 4, n - n // 4, (2, 500), generator=gen)
    model[:, yx[0], yx[1]] = torch.randn(500, generator=gen)
    model = model.to(cuda)
    taper = (0.5 + torch.rand(n, generator=gen)).to(cuda)
    scal = torch.tensor([700.0, 1.0 / (n * 16)], device=cuda)
    kr, ki = fused_fft.pre_col_fft(model, taper, scal)
    pr, pi = fused_fft.pre_col_fft_plain(model, taper, scal)
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert (kr - pr).abs().max().item() <= 1e-5 * scale
    assert (ki - pi).abs().max().item() <= 1e-5 * scale
    gk = fused_fft.cbout_col_fft(pr, pi)
    gp = fused_fft.cbout_col_fft_plain(pr, pi)
    scale = max(gp[0].abs().max().item(), gp[1].abs().max().item())
    for k, p in zip(gk, gp):
        assert (k - p).abs().max().item() <= 1e-5 * scale


def _k5_plan(seed, *, pixels, K, ts, P, n, mc=256, w_planes=4, O=8):
    """A tile-aligned plan whose uv cover the whole grid (every footprint
    inside it), corners included, so windows cross the grid's edge."""
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=(w_planes, O, K))
              + 1j * rng.normal(size=(w_planes, O, K))).astype(np.complex64)
    uv_bias = (K - 1) // 2 - pixels // 2
    uv = rng.integers(0, pixels - K + 1, size=(n, 2))
    uv[:4] = [[0, 0], [pixels - K, 0], [0, pixels - K],
              [pixels - K, pixels - K]]
    uv = (uv + uv_bias).astype(np.int16)
    sub = rng.integers(0, O, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = np.ones((n, P), np.complex64)
    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub, wp, vis, np.ones_like(vis, np.float32), pixels=pixels,
        kernel_width=K, ts=ts, mc=mc)
    return kernel, plan


@pytest.mark.parametrize("ts,K,P", [(64, 60, 1), (32, 16, 2), (64, 16, 1),
                                    (96, 96, 1)])
def test_k5_matches_plain(cuda, ts, K, P):
    """K5 within 1e-5 of the largest prediction of its plain version
    (f32 sums in another order) on every slot: slots past a chunk's valid
    count and chunks past n predict zero, also with n covering the empty
    padding chunks.  At ts = 96 (> 80, K = ts) the old 2ts <= 160 limit
    is gone; windows at the grid's edge read zero beyond it."""
    pixels = 1024
    kernel, plan = _k5_plan(4, pixels=pixels, K=K, ts=ts, P=P, n=20000)
    kern, uv, sub, wp, anc, val = (
        torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in
        (kernel, plan.uv, plan.sub_uv, plan.w_plane, plan.anchor,
         plan.valid))
    av, au, iu, iv, su, sv = fused_degrid.degrid_taps(
        kern, uv, sub, wp, anc, pixels=pixels, ts=ts)
    count = fused_gridder.valid_counts(val)
    table = fused_degrid.degrid_table(kern)
    occupied = int(plan.valid.any(axis=1).sum())
    valid = torch.from_numpy(plan.valid).to(cuda)
    assert plan.anchor.max() + ts + K - 1 > pixels
    gen = torch.Generator(device="cpu").manual_seed(K)
    gr = torch.randn((P, pixels, pixels), generator=gen).to(cuda)
    gi = torch.randn((P, pixels, pixels), generator=gen).to(cuda)
    for n in sorted({occupied, len(plan.valid)}):
        launches = fused_degrid.degrid_planes.launches
        k = fused_degrid.degrid_planes(gr, gi, av, au, count, iu, iv, su,
                                       sv, table, n, ts=ts)
        with device.plain_versions():
            p = fused_degrid.degrid_planes(gr, gi, av, au, count, iu, iv,
                                           su, sv, table, n, ts=ts)
        torch.cuda.synchronize()
        assert fused_degrid.degrid_planes.launches == launches + 1
        assert torch.isfinite(k).all() and not k[n:].any()
        assert not k[~valid].any()
        assert (k - p).abs().max().item() <= 1e-5 * p.abs().max().item()


@pytest.mark.parametrize("ts,K,P", [(64, 60, 1), (32, 30, 4), (96, 96, 2),
                                    (30, 30, 1)])
def test_k5_valid_counts_match_plain(cuda, ts, K, P):
    """K5 on direct inputs: chunks of 0, 1, 31, 255 and 256 valid slots,
    shifts anywhere in [0, ts - 1], windows up to and across the grid's
    edge; every slot within 1e-5 of the largest prediction of the plain
    version, the slots past each count exactly zero.  At ts = 30 most
    column anchors are not multiples of 4, so the window loads 4 bytes at
    a time there."""
    rng = np.random.default_rng(ts + K + P)
    pixels, Mc, WO = 700, 256, 64
    counts = np.array([256, 0, 1, 31, 255, 7, 0, 128, 256], np.int32)
    NC = len(counts)
    edge = pixels // ts          # the tile whose window crosses the edge
    av, au = (rng.integers(0, edge + 1, size=NC).astype(np.int32) * ts
              for _ in range(2))
    av[0] = au[0] = edge * ts
    assert ts % 4 == 0 or (au[counts > 0] % 4).any()
    iu, iv = (rng.integers(0, WO, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    su, sv = (rng.integers(0, ts, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    table = (rng.normal(size=(WO, K))
             + 1j * rng.normal(size=(WO, K))).astype(np.complex64)
    gen = torch.Generator(device="cpu").manual_seed(P)
    gr = torch.randn((P, pixels, pixels), generator=gen).to(cuda)
    gi = torch.randn((P, pixels, pixels), generator=gen).to(cuda)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in
            (av, au, counts, iu, iv, su, sv, table)]
    n = NC - 1
    k = fused_degrid.degrid_planes(gr, gi, *args, n, ts=ts)
    p = fused_degrid.degrid_planes_plain(gr, gi, *args, n, ts=ts)
    torch.cuda.synchronize()
    live = torch.arange(Mc, device=cuda)[None, :] < args[2][:, None]
    live[n:] = False
    assert (p[live] != 0).any()
    assert not k[~live].any()
    assert (k - p).abs().max().item() <= 1e-5 * p.abs().max().item()


def test_clean_cycle_never_syncs(cuda):
    """A minor cycle keeps every index on the card: no host sync (the
    host reads the stop flag once per batch of cycles)."""
    cfg = clean.CleanConfig(pixels=512, num_pols=1, border_pixels=0,
                            patch_y=65, patch_x=65, mode=clean.CLEAN_I,
                            loop_gain=0.1)
    gen = torch.Generator(device="cpu").manual_seed(0)
    state = clean.make_state(cfg, torch.randn((1, 512, 512),
                                              generator=gen).to(cuda),
                             torch.zeros((1, 512, 512), device=cuda))
    psf = torch.rand((1, 65, 65), generator=gen).to(cuda)
    args = [torch.zeros(1, dtype=torch.int32, device=cuda),
            torch.zeros(1, device=cuda), torch.zeros(1, device=cuda),
            torch.zeros(1, dtype=torch.bool, device=cuda)]
    threshold = torch.tensor(0.0, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            args = clean._cycle(cfg, state, psf, threshold, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(args[0]) == 3


def test_natural_step_never_syncs(cuda):
    """The natural-weight step keeps every value it needs on the card: no
    host sync from its first slice to its image, so the host can enqueue
    slices ahead of the device (``fused_gridder.occupancy`` fills its mask
    with no host value)."""
    cfg = multichannel.MultiChannelConfig(
        pixels=512, num_pols=4, kernel_width=16, oversample=8, w_planes=8,
        w_slices=2, chunks_per_slice=64, chunk_size=256, rv=32, ru=32,
        weight_type="natural")
    batch = multichannel.make_example_batch(cfg, 1, seed=5, device=cuda)
    args = multichannel.channel_args(batch, 0)
    step = multichannel.single_channel_step(cfg)
    want = step(*args)[0]                         # builds and warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step(*args)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sum(args[-1]) > 0
    assert torch.equal(got, want)


def test_uniform_step_never_syncs(cuda):
    """The uniform-weight step keeps every value it needs on the card: the
    weight grid's kernel finds each tile's chunks on the device, so no
    host sync from the weights to the image; the main path launches it
    once a channel."""
    cfg = multichannel.MultiChannelConfig(
        pixels=512, num_pols=4, kernel_width=16, oversample=8, w_planes=8,
        w_slices=2, chunks_per_slice=64, chunk_size=256, rv=32, ru=32,
        weight_type="uniform")
    batch = multichannel.make_example_batch(cfg, 1, seed=5, device=cuda)
    args = multichannel.channel_args(batch, 0)
    step = multichannel.single_channel_step(cfg)
    want = step(*args)[0]                         # builds and warms up
    torch.cuda.synchronize()
    launches = multichannel.weight_grid.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step(*args)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert multichannel.weight_grid.launches == launches + 1
    assert sum(args[-1]) > 0
    assert torch.equal(got, want)


def _inside(taper):
    """The anti-aliased field: taper^2 >= 0.2% of its peak."""
    t2 = torch.outer(taper, taper)
    return t2 >= 0.002 * t2.max()


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_step_at_1000px_matches_plain(cuda, weight_type):
    """The dirty step at 1000 px (no power of two: the grid -> image
    transform takes torch.fft by rule, and K3 and K23 never launch) against the
    all-plain step, within 1e-4 of the peak inside the field, as
    :func:`test_step_matches_plain`."""
    cfg = multichannel.MultiChannelConfig(
        pixels=1000, num_pols=1, kernel_width=16, oversample=8, w_planes=8,
        w_slices=2, chunks_per_slice=512, chunk_size=128, rv=32, ru=32,
        weight_type=weight_type)
    batch = multichannel.make_example_batch(cfg, 1, seed=3, device=cuda)
    args = multichannel.channel_args(batch, 0)
    fused_fft.cb_col_fft.launches = 0
    fused_fft.combine_cb_col_fft.launches = 0
    launches = fused_gridder.grid_planes.launches
    got = multichannel.single_channel_step(cfg)(*args)[0]
    assert fused_gridder.grid_planes.launches > launches
    assert fused_fft.cb_col_fft.launches == 0
    assert fused_fft.combine_cb_col_fft.launches == 0
    with device.plain_versions():
        ref = multichannel.single_channel_step(cfg)(*args)[0]
    peak = ref.abs().max().item()
    assert got.shape == (1, 1000, 1000) and torch.isfinite(got).all()
    inside = _inside(batch.taper1d[0])
    assert (got - ref).abs()[:, inside].max().item() <= 1e-4 * peak


def test_wave_matches_plain(cuda):
    """A small cube wave through K1-K7 against the all-plain wave: the
    same CLEAN components and images within 1e-4 of the dirty peak inside
    the anti-aliased field."""
    small = dict(pixels=1024, num_pols=1, kernel_width=16, oversample=8,
                 w_planes=8, w_slices=2, chunks_per_slice=512,
                 chunk_size=128, rv=32, ru=32)
    cfg = cube.CubeConfig(**small, majors=2, minor=500, patch=33,
                          psf_core=32)
    batch = multichannel.make_example_batch(
        multichannel.MultiChannelConfig(**small, weight_type="natural"), 1,
        seed=3, device=cuda)
    batch, pos, flux = cube.with_point_sources(cfg, batch, seed=1)
    got = cube.wave_image(cfg, batch)
    with device.plain_versions():
        ref = cube.wave_image(cfg, batch)
    taper = batch.taper1d[0]
    t2 = torch.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    peak = float(flux.max())
    assert torch.equal((got.model != 0)[..., inside],
                       (ref.model != 0)[..., inside])
    for a, b in ((got.model, ref.model), (got.residual, ref.residual)):
        assert torch.isfinite(a).all()
        assert (a - b).abs()[..., inside].max().item() <= 1e-4 * peak


def test_wave_at_1000px_matches_plain(cuda):
    """A cube wave at 1000 px: its PSF and dirty images take torch.fft by
    rule, its degrid major cycle K5 (image -> grid by torch.fft too);
    against the all-plain wave as :func:`test_wave_matches_plain`."""
    small = dict(pixels=1000, num_pols=1, kernel_width=16, oversample=8,
                 w_planes=8, w_slices=2, chunks_per_slice=512,
                 chunk_size=128, rv=32, ru=32)
    cfg = cube.CubeConfig(**small, majors=2, minor=500, patch=33,
                          psf_core=32)
    batch = multichannel.make_example_batch(
        multichannel.MultiChannelConfig(**small, weight_type="natural"), 1,
        seed=3, device=cuda)
    batch, pos, flux = cube.with_point_sources(cfg, batch, seed=1)
    fused_fft.cb_col_fft.launches = 0
    fused_fft.combine_cb_col_fft.launches = 0
    fused_degrid.degrid_planes.launches = 0
    got = cube.wave_image(cfg, batch)
    assert fused_fft.cb_col_fft.launches == 0
    assert fused_fft.combine_cb_col_fft.launches == 0
    assert fused_degrid.degrid_planes.launches > 0
    with device.plain_versions():
        ref = cube.wave_image(cfg, batch)
    inside = _inside(batch.taper1d[0])
    peak = float(flux.max())
    assert torch.equal((got.model != 0)[..., inside],
                       (ref.model != 0)[..., inside])
    assert torch.isfinite(got.psf_core).all()
    for a, b in ((got.model, ref.model), (got.residual, ref.residual)):
        assert torch.isfinite(a).all()
        assert (a - b).abs()[..., inside].max().item() <= 1e-4 * peak


@pytest.mark.parametrize("shape", [(2, 256, 384), (1, 4096, 4096),
                                   (3, 512, 200)])
def test_k8_matches_plain(cuda, shape):
    """K8 within 1e-5 of the largest output of its plain version (f32
    transforms in another order), both signs; fft2 against torch's."""
    gen = torch.Generator(device="cpu").manual_seed(shape[1])
    xr = torch.randn(shape, generator=gen).to(cuda)
    xi = torch.randn(shape, generator=gen).to(cuda)
    for sign in (-1, 1):
        kr, ki = fused_fft.col_fft(xr, xi, sign)
        pr, pi = fused_fft.col_fft_plain(xr, xi, sign)
        scale = max(pr.abs().max().item(), pi.abs().max().item())
        assert (kr - pr).abs().max().item() <= 1e-5 * scale
        assert (ki - pi).abs().max().item() <= 1e-5 * scale
    if shape[1] == shape[2]:
        x = torch.complex(xr, xi)
        ref = torch.fft.fft2(x)
        got = fused_fft.fft2(x, -1)
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("pixels", [1024, 1000])
def test_k2_accumulate_matches_plain(cuda, pixels):
    """K2 onto a running grid: bitwise equal to its plain version, also
    where the tile size does not divide N."""
    ts, K = 64, 60
    kernel, wg, plan = _plan_case(5, pixels=pixels, K=K, ts=ts, P=2,
                                  n=20000)
    ar, ai, occ = _planes(cuda, kernel, wg, plan, pixels=pixels, ts=ts,
                          plain=False)
    gen = torch.Generator(device="cpu").manual_seed(5)
    base = [torch.randn((2, pixels, pixels), generator=gen).to(cuda)
            for _ in range(2)]
    k = fused_gridder.combine_planes(ar, ai, occ, pixels=pixels, ts=ts,
                                     out=tuple(b.clone() for b in base))
    p = fused_gridder.combine_planes_plain(ar, ai, occ, pixels=pixels, ts=ts,
                                           out=tuple(b.clone() for b in base))
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def test_probes_on_the_card(cuda):
    """P1 and P2 on the tensor cores: A, B, E and F exact, C on 3xTF32
    within 1e-6 and above 0, C in one TF32 pass far less exact, one launch
    a probe; every probe kernel against its plain version."""
    from katsdpimager_tpu_torch import probes

    for fn in probes.P1 + probes.P2:
        fn.launches = 0
    errs = probes.run(cuda)
    assert [fn.launches for fn in probes.P1 + probes.P2] == [1] * 7
    for name in ("A", "B", "E", "F_hi", "F_mid", "F_lo"):
        assert errs[name] == 0.0, name
    assert 0.0 < errs["C_stacked"] <= 1e-6
    assert 0.0 < errs["C_separate"] <= 1e-6
    assert errs["C_tf32"] > 1e-5
    tol = {"C_stacked": 2e-6, "C_separate": 2e-6, "C_tf32": 1e-4}
    for name, _, kernel, plain in probes.cases(probes.inputs(cuda)):
        got, want = kernel(), plain()
        assert ((got - want).abs().max().item()
                <= tol.get(name, 0.0) * want.abs().max().item()), name


@pytest.mark.parametrize("pixels", [512, 1000])
def test_per_channel_run_matches_plain(cuda, pixels):
    """The per-channel CLI path (K = 16, --degrid, 2 majors) on the card
    against the all-plain run: images within 1e-4 of the dirty peak
    inside the anti-aliased field, the same components there.  At 512 px
    through K1-K7; at 1000 px (smooth, no power of two, 1000 % ts != 0)
    through K1, K2 and K5, the transforms taking torch.fft by rule."""
    import chip_smoke
    from katsdpimager_tpu_torch import arguments, frontend, imager
    from katsdpimager_tpu_torch.ops import wkernel

    dataset, _ = chip_smoke.sim_dataset(16, 128, 1, noise_jy=0.5)
    argv = ["simulated", "unused_%c.fits", "--pixels", str(pixels),
            "--kernel-width", "16", "--major", "2", "--degrid",
            "--no-tmp-file", "--vis-block", "1024"]

    def run(plain):
        args = imager.get_parser().parse_args(
            argv, namespace=arguments.SmartNamespace())
        cap = {}

        class Capture(frontend.Writer):
            def needs_fits_image(self, name):
                return name in ("dirty", "model", "clean")

            def needs_fits_grid(self, name):
                return False

            def write_fits_image(self, name, desc, ds, image, ip, ch,
                                 beam=None, bunit=None):
                cap[name] = np.array(image)

            def write_fits_grid(self, *a, **k):
                pass

        with _versions(plain):
            frontend.run(args, dataset, Capture(), device=cuda)
        return cap

    fused_degrid.degrid_planes.launches = 0
    fused_fft.cb_col_fft.launches = 0
    fused_fft.combine_cb_col_fft.launches = 0
    got = run(False)
    assert fused_degrid.degrid_planes.launches > 0
    assert (fused_fft.cb_col_fft.launches > 0) == (pixels == 512)
    # the CLI's running grid takes K2 then K3, never K23
    assert fused_fft.combine_cb_col_fft.launches == 0
    ref = run(True)
    taper = wkernel.taper(pixels, 7.0, 8, wkernel.default_beta(7.0))
    t2 = np.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    peak = np.abs(ref["dirty"]).max()
    for name in ("dirty", "model", "clean"):
        assert np.isfinite(got[name]).all()
        assert np.abs(got[name] - ref[name])[:, inside].max() <= 1e-4 * peak
    np.testing.assert_array_equal((got["model"] != 0)[:, inside],
                                  (ref["model"] != 0)[:, inside])


def _k1_inputs(dev, seed, *, ts, P, K, runs, counts, Mc=256, WO=64):
    """Direct K1 inputs: runs of 1-4 chunks sharing a slot, each chunk's
    valid slots a prefix of ``counts[c]``, taps anywhere in range."""
    rng = np.random.default_rng(seed)
    nt2 = 3
    NC = sum(runs)
    slots = rng.choice(4 * nt2 * nt2, size=len(runs), replace=False)
    slot = np.repeat(slots, runs).astype(np.int32)
    count = np.asarray(counts, np.int32)
    assert len(count) == NC
    iu, iv = (rng.integers(0, WO, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    su, sv = (rng.integers(0, ts, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    live = np.arange(Mc)[None, None, :] < count[:, None, None]
    sre, sim = (np.where(live, rng.normal(size=(NC, P, Mc)), 0.0).astype(
        np.float32) for _ in range(2))
    table = (rng.normal(size=(WO, K))
             + 1j * rng.normal(size=(WO, K))).astype(np.complex64)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
         (slot, count, iu, iv, su, sv, sre, sim, table)]
    return t, nt2


@pytest.mark.parametrize("ts,K", [(64, 60), (32, 30)] + TILE_CASES)
@pytest.mark.parametrize("P", [1, 4])
def test_k1_valid_counts_match_plain(cuda, ts, K, P):
    """K1 loops to each chunk's valid count: runs of 1-4 chunks with 0, 1,
    31 and 256 valid slots (and a run whose only chunk is empty), against
    its plain version within 2e-5 of the largest written value.  Planes
    start as NaN: K1 writes exactly the blocks its plain version writes,
    and never the padding of its window past 2ts (at odd ts the planes'
    row stride is no multiple of 4 floats)."""
    runs = [1, 2, 3, 4, 1]
    counts = [256, 0, 1, 31, 256, 7, 0, 255, 128, 31, 0]
    (slot, count, iu, iv, su, sv, sre, sim, table), nt2 = _k1_inputs(
        cuda, 5 * ts + P, ts=ts, P=P, K=K, runs=runs, counts=counts)
    n = len(counts)
    ext2 = nt2 * 2 * ts
    shape = (2, 2, P, ext2, ext2)
    kr, ki = (torch.full(shape, float("nan"), device=cuda) for _ in range(2))
    pr, pi = (torch.full(shape, float("nan"), device=cuda) for _ in range(2))
    args = (slot, n, count, iu, iv, su, sv, sre, sim, table)
    launches = fused_gridder.grid_planes.launches
    fused_gridder.grid_planes(*args, kr, ki, ts=ts)
    fused_gridder.grid_planes_plain(*args, pr, pi, ts=ts)
    torch.cuda.synchronize()
    assert fused_gridder.grid_planes.launches == launches + 1
    written = ~torch.isnan(pr)
    assert torch.equal(written, ~torch.isnan(kr))
    scale = max(pr[written].abs().max().item(), pi[written].abs().max().item())
    assert scale > 0
    for k, p in ((kr, pr), (ki, pi)):
        assert (k[written] - p[written]).abs().max().item() <= 2e-5 * scale
    # the run of one empty chunk is written, as zeros
    occ = fused_gridder.occupancy(slot, n, nt2)
    assert int(occ.sum()) == len(runs)


@pytest.mark.parametrize("n", [256, 1024, 4096, 8192])
@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("sign", [-1, 1])
def test_k8_clusters_match_plain(cuda, n, square, sign):
    """K8's four-step cluster design against ``col_fft_plain`` within
    1e-6 of the largest output, square and with a ragged M = 200."""
    m = n if square else 200
    gen = torch.Generator(device="cpu").manual_seed(n + m)
    xr = torch.randn((1, n, m), generator=gen).to(cuda)
    xi = torch.randn((1, n, m), generator=gen).to(cuda)
    kr, ki = fused_fft.col_fft(xr, xi, sign)
    pr, pi = fused_fft.col_fft_plain(xr, xi, sign)
    torch.cuda.synchronize()
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert (kr - pr).abs().max().item() <= 1e-6 * scale
    assert (ki - pi).abs().max().item() <= 1e-6 * scale


def test_cube_pipeline_matches_plain(cuda, tmp_path):
    """The batch pipeline's --cube route (K = 16, 2 channels in 2 waves,
    --subtract of the 1.5 Jy off-centre source, the MeerKAT primary
    beam, 2 majors) on the card against its all-plain run: the same NaN
    pixels (the beam's cutoff), restored images within 1e-4 of the
    plain run's peak inside the anti-aliased field, equal minor counts,
    and every kernel of the wave launched."""
    import json
    import math

    import chip_smoke
    from katsdpimager_tpu_torch import arguments, pipeline, simulate
    from katsdpimager_tpu_torch.ops import wkernel

    dataset, _ = chip_smoke.sim_dataset(16, 128, 2, noise_jy=0.5)
    src = simulate.DEFAULT_SOURCES[1]
    lsm = tmp_path / "lsm.txt"
    lsm.write_text(f"{math.degrees(src.ra)!r} {math.degrees(src.dec)!r} "
                   f"{src.flux_iquv[0]!r} 0 0 0\n")

    def run(name, plain):
        out = tmp_path / name
        args = pipeline.get_parser().parse_args(
            ["simulated", str(out), "--cube", "--pixels", "256",
             "--kernel-width", "16", "--major", "2", "--no-tmp-file",
             "--no-thumbnails", "--vis-block", "1024", "--subtract",
             str(lsm), "--primary-beam", "meerkat"],
            namespace=arguments.SmartNamespace())
        images = {}
        writer = pipeline.PipelineWriter(str(out), thumbnails=False)
        write = writer.write_fits_image

        def capture(name, desc, ds, image, ip, ch, *a, **k):
            images[ch] = np.array(image)
            return write(name, desc, ds, image, ip, ch, *a, **k)

        writer.write_fits_image = capture
        with _versions(plain):
            timings = pipeline.run(args, dataset, writer, device=cuda)
        assert len(timings) == 2
        return images, json.loads((out / "state.json").read_text())

    for fn in (fused_gridder.grid_planes, fused_fft.cb_col_fft,
               fused_fft.combine_cb_col_fft, fused_degrid.degrid_planes,
               fused_fft.pre_col_fft):
        fn.launches = 0
    got, got_state = run("kernels", False)
    assert fused_gridder.grid_planes.launches > 0
    # the wave's slice loop takes K23 in place of K2 then K3
    assert fused_fft.combine_cb_col_fft.launches > 0
    assert fused_fft.cb_col_fft.launches == 0
    assert fused_degrid.degrid_planes.launches > 0
    assert fused_fft.pre_col_fft.launches > 0
    ref, ref_state = run("plain", True)
    taper = wkernel.taper(256, 7.0, 8, wkernel.default_beta(7.0))
    t2 = np.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    for ch in range(2):
        assert got_state[f"status/{ch}"] == "complete"
        assert (got_state[f"stats/{ch}"]["minor"]
                == ref_state[f"stats/{ch}"]["minor"])
        np.testing.assert_array_equal(np.isnan(got[ch]), np.isnan(ref[ch]))
        both = inside & ~np.isnan(ref[ch][0])
        peak = np.abs(ref[ch][0][both]).max()
        assert np.isfinite(got[ch][0][both]).all()
        assert np.abs(got[ch][0] - ref[ch][0])[both].max() <= 1e-4 * peak


def test_wave_arena_waits_for_its_upload(cuda):
    """The pack arena of a wave is refilled two waves later by the
    prefetch worker; its upload is asynchronous from pinned memory, so
    the refill waits on the upload's event.  With the upload held back
    behind a device sleep, the batch keeps the packed bytes; the same
    steps without the event's wait lose them to the refill."""
    from katsdpimager_tpu_torch import cube_frontend

    cfg = cube.CubeConfig(pixels=256, num_pols=1, kernel_width=16,
                          oversample=8, w_planes=4, w_slices=2,
                          chunks_per_slice=2048, chunk_size=256)

    def upload_then_refill(guarded):
        arena = {}
        arrs = cube_frontend._wave_buffers(arena, cfg, 1, pin=True)
        assert all(t.is_pinned() for t in arena["tensors"])
        arrs[10][...] = 1.0 + 2.0j                       # the packed vis
        torch.cuda._sleep(1 << 30)                 # hold the copy back
        batch = cube_frontend.batch_from_arrays(arrs, cuda, arena)
        if not guarded:
            arena.pop("event")
        refilled = cube_frontend._wave_buffers(arena, cfg, 1, pin=True)
        refilled[10][...] = 7.0
        torch.cuda.synchronize()
        return bool((batch.vis == 1.0 + 2.0j).all())

    assert upload_then_refill(guarded=True)
    assert not upload_then_refill(guarded=False)


def _k1_err_vs_float64(dev, args, ts, nt2, P=1):
    """K1's largest error over its written blocks over the peak of a
    float64 run of its plain version, and the plain f32 version's; each
    polarization against its own peak, the largest of them."""
    slot, n, count, iu, iv, su, sv, sre, sim, table = args
    ext2 = nt2 * 2 * ts
    shape = (2, 2, P, ext2, ext2)
    kr, ki, pr, pi = (torch.zeros(shape, device=dev) for _ in range(4))
    r64, i64 = (torch.zeros(shape, dtype=torch.float64, device=dev)
                for _ in range(2))
    fused_gridder.grid_planes(*args, kr, ki, ts=ts)
    fused_gridder.grid_planes_plain(*args, pr, pi, ts=ts)
    fused_gridder.grid_planes_plain(
        slot, n, count, iu, iv, su, sv, sre.double(), sim.double(),
        table.to(torch.complex128), r64, i64, ts=ts)
    occ = fused_gridder.occupancy(slot, n, nt2)
    written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
        2 * ts, -1)[:, :, None]
    dims = (0, 1, 3, 4)
    scale = torch.maximum(r64.abs().amax(dim=dims), i64.abs().amax(dim=dims))
    return [(torch.maximum(
        (a.double() - r64).abs().where(written, 0.0).amax(dim=dims),
        (b.double() - i64).abs().where(written, 0.0).amax(dim=dims))
        / scale).max().item() for a, b in ((kr, ki), (pr, pi))]


@pytest.mark.parametrize("ts,K", [(64, 60), (32, 30)])
@pytest.mark.parametrize("run_chunks", [4, 32, 128])
def test_k1_long_runs_hold_float64(cuda, ts, K, run_chunks):
    """K1 on anchor runs of 4, 32 and 128 full chunks (32 k-steps of 8
    each): within 1e-6 of the peak of a float64 run of its plain version
    over the written blocks, the JAX gridder's accuracy class
    (1.6-2.2e-7).  The schedule before (one accumulator a value, promoted
    into the plane every 32 k-steps) read 3.1-3.9e-6 here; one level of
    FP32 totals, 0.8-1.7e-6 on the 32- and 128-chunk runs."""
    nruns = {4: 24, 32: 4, 128: 2}[run_chunks]
    runs = [run_chunks] * nruns
    counts = [256] * (run_chunks * nruns)
    (slot, count, iu, iv, su, sv, sre, sim, table), nt2 = _k1_inputs(
        cuda, 7 * ts + run_chunks, ts=ts, P=1, K=K, runs=runs,
        counts=counts)
    err, _ = _k1_err_vs_float64(
        cuda, (slot, len(counts), count, iu, iv, su, sv, sre, sim, table),
        ts, nt2)
    assert err <= 1e-6, err


@pytest.mark.parametrize("ts,K", [(64, 60), (32, 33), (64, 65)]
                         + TILE_CASES)
def test_k1_tiles_hold_float64(cuda, ts, K):
    """K1 at every tile size (``chip_smoke.py``'s ``tiles`` cases) on
    runs of 1-4 chunks with 0-256 valid slots: within 1e-6 of the peak of
    a float64 run of its plain version, as is the plain f32 version."""
    rng = np.random.default_rng(ts * 1000 + K)
    runs = [int(r) for r in rng.integers(1, 5, size=24)]
    counts = [int(c) for c in rng.integers(0, 257, size=sum(runs))]
    (slot, count, iu, iv, su, sv, sre, sim, table), nt2 = _k1_inputs(
        cuda, ts + K, ts=ts, P=1, K=K, runs=runs, counts=counts)
    err, plain = _k1_err_vs_float64(
        cuda, (slot, len(counts), count, iu, iv, su, sv, sre, sim, table),
        ts, nt2)
    assert err <= 1e-6, err
    assert plain <= 1e-6, plain


def _production_slice(dev, P=1):
    """K1's arguments at the production slice (``chip_smoke.py``'s step:
    4096 px, K = 60, ts 64, channel 0, slice 0 of 2^19 visibilities) with
    ``P`` polarizations, its tile size and nt2."""
    cfg = multichannel.MultiChannelConfig(
        pixels=4096, num_pols=P, kernel_width=60, oversample=8,
        w_planes=32, w_slices=4, chunks_per_slice=8192, chunk_size=256,
        rv=64, ru=64, minor_cycles=0, weight_type="natural")
    batch = multichannel.make_example_batch(cfg, 1, vis_per_slice=1 << 19,
                                            device=dev)
    N, ts, K = cfg.pixels, cfg.rv, cfg.kernel_width
    nt2 = mxu_gridder.colour_tiles(N, ts)
    n = int(batch.n_chunks[0, 0])
    kern = batch.kernel[0]
    uv, sub, wp, anc, val, vis = (x[0, 0] for x in (
        batch.uv, batch.sub_uv, batch.w_plane, batch.anchor, batch.valid,
        batch.vis))
    iu, iv, su, sv = fused_gridder.tap_indices(kern, uv, sub, wp, anc,
                                               pixels=N, ts=ts)
    sre, sim = fused_gridder.samples(vis, val, None, None, anc, su, sv,
                                     kernel_width=K, ts=ts)
    args = (fused_gridder.chunk_slots(anc, n, ts=ts, nt2=nt2), n,
            fused_gridder.valid_counts(val), iu, iv, su, sv, sre, sim,
            fused_gridder.conj_table(kern))
    return args, ts, nt2


@pytest.mark.parametrize("P", [1, 4])
def test_k1_production_slice_holds_float64(cuda, P):
    """K1 at the production slice (``chip_smoke.py``'s step: 4096 px,
    K = 60, ts 64, channel 0, slice 0 of 2^19 visibilities), in Stokes I
    and in full Stokes: each polarization within 1e-6 of its own peak of
    a float64 run of its plain version."""
    args, ts, nt2 = _production_slice(cuda, P)
    assert args[7].shape[1] == P
    err, _ = _k1_err_vs_float64(cuda, args, ts, nt2, P)
    assert err <= 1e-6, err


def _bits(t):
    return t.view(torch.int32)


def test_k1_two_launches_are_bitwise_equal(cuda):
    """Two launches of K1 at the production slice, into planes that start
    as NaN, give bitwise equal planes: each value has one owner and no
    sum depends on the order in which the CTAs take their work."""
    args, ts, nt2 = _production_slice(cuda)
    shape = (2, 2, 1, nt2 * 2 * ts, nt2 * 2 * ts)
    planes = [[torch.full(shape, float("nan"), device=cuda)
               for _ in range(2)] for _ in range(2)]
    for kr, ki in planes:
        fused_gridder.grid_planes(*args, kr, ki, ts=ts)
    torch.cuda.synchronize()
    (ar, ai), (br, bi) = planes
    assert torch.equal(_bits(ar), _bits(br))
    assert torch.equal(_bits(ai), _bits(bi))
    assert int((~torch.isnan(ar)).sum()) > 0


def _adversarial_inputs(dev, ts, K, seed=3, spare=40):
    """One anchor run of 128 full chunks among 500 runs of one chunk with
    0-256 valid slots; ``spare`` chunks past n that name the long run's
    slot with full counts (K1 must not grid them); nt2 at 2048 px."""
    rng = np.random.default_rng(seed)
    nt2 = mxu_gridder.colour_tiles(2048, ts)
    runs = [1] * 200 + [128] + [1] * 300
    n = sum(runs)
    NC = n + spare
    slots = rng.choice(4 * nt2 * nt2, size=len(runs), replace=False)
    slot = np.full(NC, slots[200], np.int32)
    slot[:n] = np.repeat(slots, runs)
    count = np.full(NC, 256, np.int32)
    count[:n] = np.concatenate([rng.integers(0, 257, size=200),
                                np.full(128, 256),
                                rng.integers(0, 257, size=300)])
    Mc, WO = 256, 64
    iu, iv = (rng.integers(0, WO, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    su, sv = (rng.integers(0, ts, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    live = np.arange(Mc)[None, None, :] < count[:, None, None]
    sre, sim = (np.where(live, rng.normal(size=(NC, 1, Mc)), 0.0).astype(
        np.float32) for _ in range(2))
    table = (rng.normal(size=(WO, K))
             + 1j * rng.normal(size=(WO, K))).astype(np.complex64)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
         (slot, count, iu, iv, su, sv, sre, sim, table)]
    return (t[0], n, *t[1:]), nt2


@pytest.mark.parametrize("ts,K", [(64, 60), (32, 30)])
def test_k1_adversarial_run_lengths(cuda, ts, K):
    """K1 on a plan whose run lengths are adversarial for its schedule
    (one 128-chunk run, 2048 batches, among 500 one-chunk runs, and
    chunks past n that would add to the long run): the blocks its plain
    version writes and no others (planes start as NaN), within 2e-5 of
    the largest written value and within 1e-6 of the peak of a float64
    run; a second launch bitwise equal."""
    args, nt2 = _adversarial_inputs(cuda, ts, K)
    shape = (2, 2, 1, nt2 * 2 * ts, nt2 * 2 * ts)
    kr, ki, pr, pi, kr2, ki2 = (torch.full(shape, float("nan"), device=cuda)
                                for _ in range(6))
    fused_gridder.grid_planes(*args, kr, ki, ts=ts)
    fused_gridder.grid_planes(*args, kr2, ki2, ts=ts)
    fused_gridder.grid_planes_plain(*args, pr, pi, ts=ts)
    torch.cuda.synchronize()
    written = ~torch.isnan(pr)
    assert torch.equal(written, ~torch.isnan(kr))
    assert torch.equal(written, ~torch.isnan(ki))
    scale = max(pr[written].abs().max().item(), pi[written].abs().max().item())
    for k, p in ((kr, pr), (ki, pi)):
        assert (k[written] - p[written]).abs().max().item() <= 2e-5 * scale
    assert torch.equal(_bits(kr), _bits(kr2))
    assert torch.equal(_bits(ki), _bits(ki2))
    err, _ = _k1_err_vs_float64(cuda, args, ts, nt2)
    assert err <= 1e-6, err


@pytest.mark.parametrize("case", ["production", "production P 4",
                                  "adversarial ts 64", "adversarial ts 32"])
def test_k1_work_matches_the_schedule_model(cuda, case):
    """Each worker of K1 (lane l of CTA b, worker l x SMs + b) reports
    the items and batches that the schedule's plain model
    (``tests/test_torch_k1_schedule.py``) deals it, over every pass
    (polarization x tile) of every run, at the production slice in
    Stokes I and in full Stokes and on the adversarial run lengths;
    workers the instance does not have report nothing; and the planes of
    the launch that reports are bitwise those of one that does not."""
    if case.startswith("production"):
        args, ts, nt2 = _production_slice(cuda, 4 if case.endswith("4")
                                          else 1)
    else:
        ts, K = {"adversarial ts 64": (64, 60),
                 "adversarial ts 32": (32, 30)}[case]
        args, nt2 = _adversarial_inputs(cuda, ts, K)
    P = args[7].shape[1]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    stats = torch.full((2 * sms, 2), -1, dtype=torch.int32, device=cuda)
    shape = (2, 2, P, nt2 * 2 * ts, nt2 * 2 * ts)
    kr, ki, kr2, ki2 = (torch.full(shape, float("nan"), device=cuda)
                        for _ in range(4))
    fused_gridder.grid_planes(*args, kr, ki, ts=ts, stats=stats)
    fused_gridder.grid_planes(*args, kr2, ki2, ts=ts)
    model = k1_schedule(args[0].cpu(), args[1], args[2].cpu(), P=P, ts=ts,
                        ctas=sms)
    want = [[len(items), sum(b for _, _, b in items)] for items in model]
    want += [[-1, -1]] * (2 * sms - len(want))
    assert stats.cpu().tolist() == want
    assert sum(w[0] for w in want) > 0
    assert torch.equal(_bits(kr), _bits(kr2))
    assert torch.equal(_bits(ki), _bits(ki2))


def _stretch_runs():
    """Runs at K1's stretch of ``PROMOTE_STEPS`` k-steps
    (``tests/test_torch_gridder_tc.py``)."""
    c = fused_gridder.PROMOTE_STEPS
    runs = {}
    for k in (c - 1, c, c + 1):
        if k >= 1:
            runs[f"{k} in 1 chunk"] = ([1, 1, 1], [100, 8 * k - 3, 7])
            runs[f"{k} in {k + 1} chunks"] = (
                [1, k + 1, 1], [100, 0] + [8] * (k - 1) + [5, 7])
    return runs


#: Runs at K1's promotion boundaries (``tests/test_torch_gridder_tc.py``'s
#: ``BOUNDARY_RUNS``): (chunks per run, valid slots per chunk), the middle
#: run holding the case's k-steps of 8 valid slots: at the stretch of
#: PROMOTE_STEPS k-steps, at 32 or 33 (where the schedule before changed
#: body), and at a segment of the kernel's totals.
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


@pytest.mark.parametrize("ts,K", [(64, 60), (32, 30)])
@pytest.mark.parametrize("case", list(BOUNDARY_RUNS))
def test_k1_runs_at_the_promotion_boundary(cuda, ts, K, case):
    """K1 on runs at its promotion boundaries, however many chunks (some
    empty) they span: each run is written once, as its plain version
    writes it (within 2e-5 of the largest written value) and within 1e-6
    of the peak of a float64 run, and nothing else is written (planes
    start as NaN)."""
    runs, counts = BOUNDARY_RUNS[case]
    (slot, count, iu, iv, su, sv, sre, sim, table), nt2 = _k1_inputs(
        cuda, 11 * ts + len(counts), ts=ts, P=1, K=K, runs=runs,
        counts=counts)
    n = len(counts)
    ext2 = nt2 * 2 * ts
    shape = (2, 2, 1, ext2, ext2)
    kr, ki, pr, pi = (torch.full(shape, float("nan"), device=cuda)
                      for _ in range(4))
    args = (slot, n, count, iu, iv, su, sv, sre, sim, table)
    fused_gridder.grid_planes(*args, kr, ki, ts=ts)
    fused_gridder.grid_planes_plain(*args, pr, pi, ts=ts)
    torch.cuda.synchronize()
    written = ~torch.isnan(pr)
    assert torch.equal(written, ~torch.isnan(kr))
    assert torch.equal(written, ~torch.isnan(ki))
    scale = max(pr[written].abs().max().item(), pi[written].abs().max().item())
    for k, p in ((kr, pr), (ki, pi)):
        assert (k[written] - p[written]).abs().max().item() <= 2e-5 * scale
    err, _ = _k1_err_vs_float64(cuda, args, ts, nt2)
    assert err <= 1e-6, err


def test_wave_at_double_matches_plain(cuda):
    """A cube wave at double (complex128 visibilities, float64 taper,
    pixel size and mid-w) through K1 and K5 against its all-plain run:
    float64, the same components, images within 1e-4 of the brightest
    source's flux inside the field (the float32 wave's gate: K1 and K5
    are float32 at double too)."""
    small = dict(pixels=1024, num_pols=1, kernel_width=16, oversample=8,
                 w_planes=8, w_slices=2, chunks_per_slice=512,
                 chunk_size=128, rv=32, ru=32)
    cfg = cube.CubeConfig(**small, majors=2, minor=500, patch=33,
                          psf_core=32)
    batch = multichannel.make_example_batch(
        multichannel.MultiChannelConfig(**small, weight_type="natural"), 1,
        seed=3, device=cuda)
    batch, pos, flux = cube.with_point_sources(cfg, batch, seed=1)
    batch = batch._replace(taper1d=batch.taper1d.double(),
                           pixel_size=batch.pixel_size.double(),
                           mid_w=batch.mid_w.double(),
                           vis=batch.vis.to(torch.complex128))
    launches = (fused_gridder.grid_planes.launches,
                fused_degrid.degrid_planes.launches)
    got = cube.wave_image(cfg, batch)
    assert fused_gridder.grid_planes.launches > launches[0]
    assert fused_degrid.degrid_planes.launches > launches[1]
    with device.plain_versions():
        ref = cube.wave_image(cfg, batch)
    assert got.residual.dtype == got.model.dtype == torch.float64
    inside = _inside(batch.taper1d[0])
    assert torch.equal((got.model != 0)[..., inside],
                       (ref.model != 0)[..., inside])
    for a, b in ((got.model, ref.model), (got.residual, ref.residual)):
        assert torch.isfinite(a).all()
        assert (a - b).abs()[..., inside].max().item() <= 1e-4 * flux.max()


def test_two_ranks_share_the_card(cuda):
    """The sharded step on 2 ranks (gloo) sharing the one card, at (chan
    2, vis 1) and (chan 1, vis 2), against the 1-rank step: bitwise for
    the chan split, within 1e-5 of the peak inside the field for the vis
    split."""
    from katsdpimager_tpu_torch.parallel import launch, mesh

    small = dict(pixels=1024, num_pols=1, kernel_width=16, oversample=8,
                 w_planes=8, w_slices=2, chunks_per_slice=512,
                 chunk_size=128, rv=32, ru=32)
    mcfg = multichannel.MultiChannelConfig(**small, weight_type="uniform")
    batch = multichannel.make_example_batch(mcfg, 2, seed=3, device="cpu")
    batch, _, _ = cube.with_point_sources(
        cube.CubeConfig(**small, patch=33), batch, seed=1)
    one = mesh.make_mesh(1)
    ref = multichannel.make_imaging_step(one, mcfg)(
        multichannel.local_batch(one, batch))[0].cpu().numpy()
    ranks = launch.run_ranks(
        2, "katsdpimager_tpu_torch.parallel.launch:image_shards",
        [dict(kind="step", cfg=mcfg, batch=batch, vis_shards=1),
         dict(kind="step", cfg=mcfg, batch=batch, vis_shards=2)])
    for r in ranks:
        np.testing.assert_array_equal(r[0]["outputs"][0][0],
                                      ref[r[0]["chan_index"]])
    inside = _inside(batch.taper1d[0]).cpu().numpy()
    peak = np.abs(ref).max()
    for r in ranks:
        got = r[1]["outputs"][0]
        assert np.abs(got - ref)[..., inside].max() <= 1e-5 * peak
        assert r[1]["psum_calls"] > 0


@pytest.mark.parametrize("ts,K,P", [(64, 60, 1), (32, 16, 2)])
def test_device_plan_grids_as_the_host_plan(cuda, ts, K, P):
    """``plan_chunks_tiled_device`` on the card, with no host sync: every
    field bitwise equal to the host plan, and K1 + K2 grid both plans to
    bitwise equal planes."""
    pixels, n = 1024, 20000
    rng = np.random.default_rng(7)
    kernel = (rng.normal(size=(4, 8, K))
              + 1j * rng.normal(size=(4, 8, K))).astype(np.complex64)
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, 4, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, P))
           + 1j * rng.normal(size=(n, P))).astype(np.complex64)
    wt = rng.uniform(0.5, 2.0, size=(n, P)).astype(np.float32)
    wg = rng.uniform(0.5, 2.0, size=(P, pixels, pixels)).astype(np.float32)
    kw = dict(pixels=pixels, kernel_width=K, ts=ts, mc=256)
    host = mxu_gridder.plan_chunks_tiled(uv, sub, wp, vis, wt, **kw)
    nc = host.uv.shape[0]
    uv_dev, *rest = (torch.from_numpy(a).to(cuda)
                     for a in (uv, sub, wp, vis, wt))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev = mxu_gridder.plan_chunks_tiled_device(uv_dev, *rest, **kw,
                                                   nc=nc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(v.device == uv_dev.device for v in dev.values())
    for name in mxu_gridder.ChunkPlan._fields:
        want = torch.from_numpy(np.ascontiguousarray(getattr(host, name)))
        assert torch.equal(dev[name].cpu(), want), name
    n_chunks = int(host.valid.any(axis=1).sum())
    assert int(dev["n_chunks"]) == n_chunks

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    def grid(plan):
        return fused_gridder.grid_slice(
            up(kernel), up(wg), *(plan[f] for f in (
                "uv", "sub_uv", "w_plane", "vis", "anchor", "valid")),
            n_chunks, pixels=pixels, ts=ts)

    want = grid({f: up(getattr(host, f)) for f in host._fields})
    got = grid(dev)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert want[0].abs().max() > 0


def test_spans_share_the_device_trace_clock(cuda, tmp_path):
    """One channel of the step at 256 px on the card, under
    ``torch.profiler`` with CPU and CUDA activity and a ``CollectProfiler``
    installed: each record (``time.time_ns()``) encloses its span's
    ``user_annotation`` in the exported trace (``baseTimeNanoseconds`` +
    ``ts``), the median gap at each end under 50 us; and K1's kernel is
    launched by a runtime call inside a ``k1.launch`` span (matched by
    ``args.correlation``)."""
    import json

    from katsdpimager_tpu_torch import profiling

    cfg = multichannel.MultiChannelConfig(
        pixels=256, num_pols=1, kernel_width=16, oversample=8, w_planes=8,
        w_slices=2, chunks_per_slice=64, chunk_size=128, rv=32, ru=32,
        weight_type="natural")
    batch = multichannel.make_example_batch(cfg, 1, seed=3, device=cuda)
    args = multichannel.channel_args(batch, 0)
    step = multichannel.single_channel_step(cfg)
    step(*args)                                   # builds and warms up
    torch.cuda.synchronize()
    prof = profiling.CollectProfiler()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with profiling.installed(prof), torch.profiler.profile(
            activities=acts) as tp:
        step(*args)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    tp.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    events = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
    annotations = {}
    for ev in events:
        if ev.get("cat") == "user_annotation":
            annotations.setdefault(ev["name"], []).append(ev)
    heads, tails = [], []
    for name, evs in annotations.items():
        recs = sorted((r for r in prof.records if r.stack[-1] == name),
                      key=lambda r: r.start_ns)
        evs.sort(key=lambda ev: ev["ts"])
        assert len(recs) == len(evs), name
        for rec, ev in zip(recs, evs):
            start = base + ev["ts"] * 1e3
            heads.append((start - rec.start_ns) / 1e3)
            tails.append((rec.end_ns - start - ev["dur"] * 1e3) / 1e3)
    assert len(heads) == len(prof.records) > 10
    assert min(heads) >= -1.0 and min(tails) >= -1.0, (heads, tails)
    heads.sort()
    tails.sort()
    assert heads[len(heads) // 2] <= 50 and tails[len(tails) // 2] <= 50
    k1 = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in annotations["k1.launch"]]
    launches = {ev["args"]["correlation"]: ev["ts"] for ev in events
                if ev.get("cat") in ("cuda_runtime", "cuda_driver")}
    kernels = [ev for ev in events if ev.get("cat") == "kernel"
               and "grid_planes_kernel" in ev["name"]]
    assert len(kernels) == 2
    for ev in kernels:
        t = launches[ev["args"]["correlation"]]
        assert any(s <= t <= e for s, e in k1)


#: The weight grid's kernel at the tile sizes the planners give: one
#: region a tile (ts <= 64, ts 8 at K = ts + 1), parts of 64 and 32 (ts
#: 96), of 64 (ts 128), and P up to 4.
WEIGHT_GRID_CASES = {
    "512 px, ts 32": dict(pixels=512, K=16, ts=32, P=1),
    "512 px, ts 32, P 4": dict(pixels=512, K=16, ts=32, P=4),
    "ts 8, K 9": dict(pixels=256, K=9, ts=8, P=1),
    "ts 50, K 16, P 3": dict(pixels=400, K=16, ts=50, P=3),
    "ts 96, P 2": dict(pixels=1024, K=96, ts=96, P=2),
    "ts 128": dict(pixels=2048, K=96, ts=128, P=1),
}


def _weight_grid_inputs(dev, seed, *, pixels, K, ts, P, S=2, n=20000,
                        mc=256):
    """One channel's (uv, valid, weights, anchor) from the planner: S
    slices of ``n`` visibilities clustered round the centre, 2% of them
    on cells past the grid's high edge (inside the last tiles' windows),
    weights U(0.5, 2); then padding slots given far-off uv and weights
    that would show, were they read."""
    rng = np.random.default_rng(seed)
    lim = pixels // 2 - K - 1
    cfg = multichannel.MultiChannelConfig(
        pixels=pixels, num_pols=P, kernel_width=K, oversample=8, w_planes=4,
        w_slices=S, chunks_per_slice=4 * n // mc + 1024, chunk_size=mc,
        rv=ts, ru=ts)
    slices, ncs = [], []
    for _ in range(S):
        uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim)
        edge = rng.random(n) < 0.02
        axis = rng.integers(0, 2, size=n)
        uv[edge, axis[edge]] = rng.integers(
            pixels // 2, pixels // 2 + ts // 2, size=int(edge.sum()))
        uv = uv.astype(np.int16)
        wt = rng.uniform(0.5, 2.0, size=(n, P)).astype(np.float32)
        planned, nc = multichannel.chunk_channel(
            cfg, uv, np.zeros_like(uv), np.zeros(n, np.int16),
            np.ones((n, P), np.complex64), wt)
        slices.append(planned)
        ncs.append(nc)
    NC = max(ncs) + 3
    uv, anchor, valid, weights = (
        np.stack([p[i][:NC] for p in slices]) for i in (0, 3, 4, 5))
    pad = ~valid
    uv[pad] = rng.integers(-pixels, pixels, size=(int(pad.sum()), 2))
    weights[pad] = rng.uniform(1.0, 3.0, size=(int(pad.sum()), P))
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (uv, valid, weights, anchor)]


def _check_weight_grid(dev, pixels, K, ts, uv, valid, weights, anchor):
    """The kernel's grid against the float32 serial fold (numpy's
    ``add.at`` over the valid slots in slot order), bitwise, and against
    the plain version on the card to 1e-6 of each cell; every cell
    written (the grid's memory held NaN before); one launch."""
    P = weights.shape[-1]
    kw = dict(anchor=anchor, ts=ts, kernel_width=K)
    nan = torch.full((P, pixels, pixels), float("nan"), device=dev)
    del nan
    launches = multichannel.weight_grid.launches
    got = multichannel.weight_grid(P, pixels, uv, valid, weights, **kw)
    with device.plain_versions():
        plain = multichannel.weight_grid(P, pixels, uv, valid, weights, **kw)
    torch.cuda.synchronize()
    assert multichannel.weight_grid.launches == launches + 1
    assert torch.isfinite(got).all()
    assert ((got - plain).abs() <= 1e-6 * plain.abs()).all()
    fold = add_at(pixels, uv.cpu(), valid.cpu(), weights.cpu(), np.float32)
    np.testing.assert_array_equal(got.cpu().numpy(), fold)
    assert fold.max() > 0
    return got


@pytest.mark.parametrize("case", list(WEIGHT_GRID_CASES))
def test_weight_grid_matches_plain(cuda, case):
    c = WEIGHT_GRID_CASES[case]
    inputs = _weight_grid_inputs(cuda, 7, **c)
    _check_weight_grid(cuda, c["pixels"], c["K"], c["ts"], *inputs)


@pytest.fixture(scope="module")
def production_channel():
    """Channel 0 of the production batch under uniform weights (4096 px,
    K = 60, ts 64, 4 slices of 2^19 visibilities in 8192 chunks of
    256): its config and (uv, valid, weights, anchor)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = multichannel.MultiChannelConfig(
        pixels=4096, num_pols=1, kernel_width=60, oversample=8,
        w_planes=32, w_slices=4, chunks_per_slice=8192, chunk_size=256,
        rv=64, ru=64, weight_type="uniform")
    batch = multichannel.make_example_batch(cfg, 1, vis_per_slice=1 << 19,
                                            device="cuda")
    return cfg, [x[0] for x in (batch.uv, batch.valid, batch.weights,
                                batch.anchor)]


def test_weight_grid_production_channel_matches_plain(cuda,
                                                      production_channel):
    cfg, inputs = production_channel
    _check_weight_grid(cuda, cfg.pixels, cfg.kernel_width, cfg.rv, *inputs)


def test_weight_grid_two_launches_are_bitwise_equal(cuda,
                                                    production_channel):
    """Each cell has one writer that adds its slots in slot order: two
    launches at the production channel give the same bits."""
    cfg, (uv, valid, weights, anchor) = production_channel
    a, b = (multichannel.weight_grid(
        1, cfg.pixels, uv, valid, weights, anchor=anchor, ts=cfg.rv,
        kernel_width=cfg.kernel_width) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))
    assert int((a > 0).sum()) > 0


def test_weight_grid_counts_its_launches_when_wrapped(cuda, monkeypatch):
    """A caller that wraps the module's ``weight_grid`` (as a benchmark's
    timer does) still runs the kernel, and the function's own
    ``launches`` counts it."""
    original = multichannel.weight_grid
    calls = []

    def wrapped(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(multichannel, "weight_grid", wrapped)
    cfg = multichannel.MultiChannelConfig(
        pixels=256, num_pols=1, kernel_width=16, oversample=8, w_planes=8,
        w_slices=2, chunks_per_slice=64, chunk_size=128, rv=32, ru=32,
        weight_type="uniform")
    batch = multichannel.make_example_batch(cfg, 2, seed=3, device=cuda)
    step = multichannel.make_imaging_step(None, cfg)
    launches = original.launches
    step(batch)
    torch.cuda.synchronize()
    assert len(calls) == 2
    assert original.launches == launches + 2


def test_weight_grid_rejects_unsupported(cuda):
    uv, valid, weights, anchor = _weight_grid_inputs(
        cuda, 3, pixels=256, K=16, ts=32, P=1, n=2000)
    kw = dict(anchor=anchor, kernel_width=16)
    with pytest.raises(NotImplementedError):
        multichannel.weight_grid(5, 256, uv, valid, weights.repeat(
            1, 1, 1, 5), ts=32, **kw)
    with pytest.raises(NotImplementedError):
        multichannel.weight_grid(1, 256, uv, valid, weights, ts=300, **kw)
    with pytest.raises(TypeError):
        multichannel.weight_grid(1, 256, uv.long(), valid, weights, ts=32,
                                 **kw)
