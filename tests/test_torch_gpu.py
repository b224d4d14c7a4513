"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device.  Run them on a
machine with one, without the JAX test configuration (that machine has
no JAX): ``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch.ops import (clean, fused_degrid, fused_fft,
                                        fused_gridder, mxu_gridder)
from katsdpimager_tpu_torch.parallel import cube, multichannel

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


def _planes(dev, kernel, wg, plan, *, pixels, ts, plain):
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
         (kernel, wg, plan.uv, plan.sub_uv, plan.w_plane, plan.vis,
          plan.anchor, plan.valid)]
    n = int(plan.valid.any(axis=1).sum())
    return fused_gridder.grid_chunks_planes(
        *t, None, n, pixels=pixels, ts=ts, plain=plain)


@pytest.mark.parametrize("ts,K,P", [(64, 60, 1), (64, 16, 2), (32, 16, 1)])
def test_k1_k2_match_plain(cuda, ts, K, P):
    """K1's written blocks within 2e-5 of peak of the plain version (f32
    summation order); K2 bitwise on the same planes."""
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


@pytest.mark.parametrize("n", [256, 1024, 4096, 8192])
def test_k3_k4_match_plain(cuda, n):
    gen = torch.Generator(device="cpu").manual_seed(n)
    P = 1 if n > 1024 else 2
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


def test_kernels_reject_unsupported(cuda):
    x = torch.zeros((1, 384, 384), device=cuda)
    with pytest.raises(NotImplementedError):
        fused_fft.cb_col_fft(x, x)
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
    ref = multichannel.single_channel_step(cfg, plain=True)(*args)[0]
    taper = batch.taper1d[0]
    t2 = torch.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    peak = ref.abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - ref).abs()[:, inside].max().item() <= 1e-4 * peak


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_k6_k7_match_plain(cuda, n):
    """K6 and K7 within 1e-5 of the peak of their plain versions (f32 DFT
    rounding in another order), on a CLEAN-like model in the central
    half of the image."""
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


@pytest.mark.parametrize("ts,K,P", [(64, 60, 1), (32, 16, 2), (64, 16, 1)])
def test_k5_matches_plain(cuda, ts, K, P):
    """K5 within 1e-5 of the largest prediction of its plain version
    (f32 sums in another order); chunks past n predict zero."""
    pixels = 1024
    kernel, _, plan = _plan_case(4, pixels=pixels, K=K, ts=ts, P=P,
                                 n=20000)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in
         (kernel, plan.uv, plan.sub_uv, plan.w_plane, plan.anchor)]
    n = int(plan.valid.any(axis=1).sum())
    gen = torch.Generator(device="cpu").manual_seed(K)
    gr = torch.randn((P, pixels, pixels), generator=gen).to(cuda)
    gi = torch.randn((P, pixels, pixels), generator=gen).to(cuda)
    k = fused_degrid.degrid_chunks_fused(gr, gi, *t, n, pixels=pixels, ts=ts)
    p = fused_degrid.degrid_chunks_fused(gr, gi, *t, n, pixels=pixels, ts=ts,
                                         plain=True)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all() and not k[n:].any()
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
    ref = cube.wave_image(cfg, batch, plain=True)
    taper = batch.taper1d[0]
    t2 = torch.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    peak = float(flux.max())
    assert torch.equal((got.model != 0)[..., inside],
                       (ref.model != 0)[..., inside])
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
    """P1 and P2: A, B, E and F exact, C in FP32 within 1e-6, C in TF32
    far less exact; every probe kernel against its plain version."""
    from katsdpimager_tpu_torch import probes

    errs = probes.run(cuda)
    for name in ("A", "B", "E", "F_hi", "F_mid", "F_lo"):
        assert errs[name] == 0.0, name
    assert errs["C_stacked"] <= 1e-6 and errs["C_separate"] <= 1e-6
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
    from katsdpimager_tpu import arguments
    from katsdpimager_tpu.ops import wkernel
    from katsdpimager_tpu_torch import frontend, imager

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

        frontend.run(args, dataset, Capture(), device=cuda, plain=plain)
        return cap

    fused_degrid.degrid_planes.launches = 0
    fused_fft.cb_col_fft.launches = 0
    got = run(False)
    assert fused_degrid.degrid_planes.launches > 0
    assert (fused_fft.cb_col_fft.launches > 0) == (pixels == 512)
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


@pytest.mark.parametrize("ts,K", [(64, 60), (32, 30)])
@pytest.mark.parametrize("P", [1, 4])
def test_k1_valid_counts_match_plain(cuda, ts, K, P):
    """K1 loops to each chunk's valid count: runs of 1-4 chunks with 0, 1,
    31 and 256 valid slots (and a run whose only chunk is empty), against
    its plain version within 2e-5 of the largest written value."""
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
