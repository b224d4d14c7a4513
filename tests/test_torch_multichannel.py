"""The port's dirty-image step against the JAX ``single_channel_step``
with its Pallas kernels (K1-K4, interpret mode) on the same batch."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from katsdpimager_tpu.parallel import multichannel as jax_mc
from katsdpimager_tpu_torch import convert
from katsdpimager_tpu_torch.ops import fused_fft, fused_gridder
from katsdpimager_tpu_torch.parallel import multichannel

torch.set_num_threads(2)

SMALL = dict(pixels=256, num_pols=1, kernel_width=16, oversample=8,
             w_planes=8, w_slices=2, chunks_per_slice=64, chunk_size=128,
             rv=32, ru=32)


def jax_batch(empty_slice: bool = False, pixels: int = SMALL["pixels"]):
    batch = jax_mc.make_example_batch(
        jax_mc.MultiChannelConfig(**dict(SMALL, pixels=pixels)), 2, seed=4)
    if not empty_slice:
        return batch
    d = convert.batch_to_numpy(convert.batch_from_jax(batch))
    for name in ("valid", "vis", "weights"):
        d[name][0, 1] = 0
    return jax_mc.ChannelBatch(**d)


@pytest.fixture(scope="module")
def jax_dirty():
    """Channel 0's JAX dirty image per (weight type, empty slice, pixels),
    with ``KTPU_GRID_ASSEMBLY=pallas`` and ``KTPU_FFT=pallas`` (the fused
    FFT declines sizes that are not powers of two: XLA's FFT there)."""
    memo = {}

    def get(weight_type, empty_slice=False, pixels=SMALL["pixels"]):
        key = (weight_type, empty_slice, pixels)
        if key not in memo:
            batch = jax_batch(empty_slice, pixels)
            cfg = jax_mc.MultiChannelConfig(**dict(SMALL, pixels=pixels),
                                            weight_type=weight_type)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("KTPU_GRID_ASSEMBLY", "pallas")
                mp.setenv("KTPU_FFT", "pallas")
                fn = jax.jit(jax_mc.single_channel_step(cfg))
                dirty, _ = fn(*(x[0] for x in batch))
                memo[key] = (batch, np.asarray(dirty))
        return memo[key]

    return get


def assert_image_close(got, ref, taper):
    """Within 1e-4 of peak inside the anti-aliased field (taper^2 >= 0.2%
    of its peak), finite everywhere."""
    assert np.isfinite(got).all()
    t2 = np.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    peak = np.abs(ref).max()
    assert np.abs(got - ref)[:, inside].max() <= 1e-4 * peak


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_step_matches_jax(jax_dirty, weight_type):
    batch, ref = jax_dirty(weight_type)
    tb = convert.batch_from_jax(batch)
    cfg = multichannel.MultiChannelConfig(**SMALL, weight_type=weight_type)
    got, model = multichannel.single_channel_step(cfg)(
        *multichannel.channel_args(tb, 0))
    assert got.shape == (1, 256, 256) and not model.any()
    assert_image_close(got.numpy(), ref, tb.taper1d[0].numpy())


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_step_at_smooth_size_matches_jax(jax_dirty, weight_type,
                                         monkeypatch):
    """At 320 px (2^6 5, not a power of two) the step's transform takes
    the torch.fft route, as the JAX step takes XLA's FFT; K3 and K4, even
    their plain versions, never run."""
    batch, ref = jax_dirty(weight_type, pixels=320)
    tb = convert.batch_from_jax(batch)

    def refuse(*args, **kwargs):
        raise AssertionError("K3/K4 ran at 320 px")

    monkeypatch.setattr(fused_fft, "grid_to_image_fused_parts", refuse)
    cfg = multichannel.MultiChannelConfig(**dict(SMALL, pixels=320),
                                          weight_type=weight_type)
    got, _ = multichannel.single_channel_step(cfg)(
        *multichannel.channel_args(tb, 0))
    assert got.shape == (1, 320, 320)
    assert_image_close(got.numpy(), ref, tb.taper1d[0].numpy())


def test_empty_slice_is_skipped(jax_dirty, monkeypatch):
    """A slice with no occupied chunk runs no gridder (its count is known
    on the host) and the image still matches JAX."""
    batch, ref = jax_dirty("natural", empty_slice=True)
    tb = convert.batch_from_jax(batch)
    assert tb.n_chunks[0].tolist()[1] == 0
    calls = []
    plain_k1 = fused_gridder.grid_planes_plain

    def counting(*args, **kw):
        calls.append(args[1])
        return plain_k1(*args, **kw)

    monkeypatch.setattr(fused_gridder, "grid_planes_plain", counting)
    cfg = multichannel.MultiChannelConfig(**SMALL, weight_type="natural")
    got, _ = multichannel.single_channel_step(cfg)(
        *multichannel.channel_args(tb, 0))
    assert calls == [tb.n_chunks[0, 0].item()]
    assert_image_close(got.numpy(), ref, tb.taper1d[0].numpy())


def test_counts_from_device_equal_host_counts():
    """``nc_slices=None`` counts occupied chunks itself, same result."""
    cfg = multichannel.MultiChannelConfig(**SMALL, weight_type="uniform")
    tb = multichannel.make_example_batch(cfg, 1, seed=9, device="cpu")
    step = multichannel.single_channel_step(cfg)
    args = multichannel.channel_args(tb, 0)
    a, _ = step(*args)
    b, _ = step(*args[:-1])
    assert torch.equal(a, b)


def test_minor_cycles_raise():
    """``minor_cycles > 0`` runs the CLEAN branch (it raised before CLEAN
    was ported): the model holds components whose sum plus the residual
    is the PSF-normalised dirty image wherever no patch subtracted."""
    cfg = multichannel.MultiChannelConfig(**SMALL, minor_cycles=10)
    tb = multichannel.make_example_batch(
        dataclasses.replace(cfg, minor_cycles=0), 1, seed=9, device="cpu")
    residual, model = multichannel.single_channel_step(cfg)(
        *multichannel.channel_args(tb, 0))
    assert residual.shape == model.shape == (1, 256, 256)
    assert 0 < int((model != 0).sum()) <= 10
    assert torch.isfinite(residual).all()


@pytest.fixture(scope="module")
def jax_clean_step():
    """The JAX step's CLEAN branch (20 minor cycles) on channel 0, on its
    XLA assemblies (the kernels are held one by one elsewhere)."""
    batch = jax_batch()
    cfg = jax_mc.MultiChannelConfig(**SMALL, weight_type="natural",
                                    minor_cycles=20, patch=17,
                                    border_pixels=32)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KTPU_GRID_ASSEMBLY", raising=False)
        mp.delenv("KTPU_FFT", raising=False)
        residual, model = jax.jit(jax_mc.single_channel_step(cfg))(
            *(x[0] for x in batch))
    return batch, cfg, np.asarray(residual), np.asarray(model)


def test_clean_branch_matches_jax(jax_clean_step):
    """Same components (the border keeps CLEAN inside the anti-aliased
    field, where the two paths' f32 rounding is not amplified by
    1/taper^2), fluxes and residual within 1e-4 of the dirty peak."""
    batch, jcfg, ref_res, ref_model = jax_clean_step
    tb = convert.batch_from_jax(batch)
    cfg = convert.config_from(multichannel.MultiChannelConfig, jcfg)
    residual, model = multichannel.single_channel_step(cfg)(
        *multichannel.channel_args(tb, 0))
    np.testing.assert_array_equal(model.numpy() != 0, ref_model != 0)
    assert int((model != 0).sum()) > 0
    peak = np.abs(ref_model).max() / cfg.loop_gain
    np.testing.assert_allclose(model.numpy(), ref_model, atol=1e-4 * peak)
    assert_image_close(residual.numpy(), ref_res, tb.taper1d[0].numpy())


def test_double_precision_raises():
    cfg = multichannel.MultiChannelConfig(**SMALL)
    tb = multichannel.make_example_batch(cfg, 1, seed=9, device="cpu")
    args = list(multichannel.channel_args(tb, 0))
    args[10] = args[10].to(torch.complex128)
    with pytest.raises(TypeError):
        multichannel.single_channel_step(cfg)(*args)


def test_step_at_double_matches_jax():
    """The step at double (complex128 visibilities, float64 taper, pixel
    size and mid-w) against the JAX step under ``jax_enable_x64``, which
    grids in XLA at float64: float64 images, closer to it inside the
    field than the float32 step is, and within the float32 gate (1e-4 of
    the peak).  K1 fills float32 colour planes at both precisions
    (test_torch_imager.py::test_k1_f32_band_sets_the_double_gate), so its
    band stays in the double route's difference: measured on the CPU
    1.0e-5 of the peak, the float32 step 2.5e-5.  On noise and 5 point
    sources."""
    from katsdpimager_tpu_torch.parallel import cube

    cfg = multichannel.MultiChannelConfig(**SMALL, weight_type="uniform")
    tb = multichannel.make_example_batch(cfg, 1, seed=5, device="cpu")
    tb, _, _ = cube.with_point_sources(
        cube.CubeConfig(**SMALL, patch=17), tb, seed=1)
    db = tb._replace(taper1d=tb.taper1d.double(),
                     pixel_size=tb.pixel_size.double(),
                     mid_w=tb.mid_w.double(),
                     vis=tb.vis.to(torch.complex128))
    step = multichannel.single_channel_step(cfg)
    got = step(*multichannel.channel_args(db, 0))[0].numpy()
    single = step(*multichannel.channel_args(tb, 0))[0].numpy()
    d = {k: v for k, v in convert.batch_to_numpy(db).items()
         if k != "n_chunks"}
    try:
        jax.config.update("jax_enable_x64", True)
        fn = jax.jit(jax_mc.single_channel_step(
            jax_mc.MultiChannelConfig(**SMALL, weight_type="uniform")))
        ref = np.asarray(fn(*(x[0] for x in jax_mc.ChannelBatch(**d)))[0])
    finally:
        jax.config.update("jax_enable_x64", False)
    assert got.dtype == ref.dtype == np.float64 and np.isfinite(got).all()
    t = tb.taper1d[0].double().numpy()
    t2 = np.outer(t, t)
    inside = t2 >= 0.002 * t2.max()
    peak = np.abs(ref).max()
    err = np.abs(got - ref)[:, inside].max() / peak
    err_single = np.abs(single - ref)[:, inside].max() / peak
    assert err < err_single and err <= 1e-4, (err, err_single)
