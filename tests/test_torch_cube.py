"""The port's cube wave (``parallel/cube.py``) against the JAX package's
on a noise batch with bright point sources.

The JAX waves run on their XLA assemblies (the CPU default): the kernels
on the path (K1-K7) are held to the JAX Pallas kernels one by one in
``test_torch_gridder.py``, ``test_torch_fourier.py`` and
``test_torch_degrid.py``.  Tolerances: images within 1e-4 of the dirty
peak inside the anti-aliased field (taper^2 >= 0.2% of its peak), where
the two FFT paths' f32 rounding is not amplified by 1/taper^2; the same
CLEAN components inside it; host statistics to 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from katsdpimager_tpu.ops import beam as jax_beam
from katsdpimager_tpu.parallel import cube as jax_cube
from katsdpimager_tpu.parallel import make_mesh
from katsdpimager_tpu.parallel import multichannel as jax_mc
from katsdpimager_tpu_torch import convert
from katsdpimager_tpu_torch.ops import beam
from katsdpimager_tpu_torch.parallel import cube, multichannel

torch.set_num_threads(2)

SMALL = dict(pixels=256, num_pols=1, kernel_width=16, oversample=8,
             w_planes=8, w_slices=2, chunks_per_slice=64, chunk_size=128,
             rv=32, ru=32)
CFG = cube.CubeConfig(**SMALL, majors=2, minor=300, patch=17, psf_core=32,
                      loop_gain=0.1)


def jax_cfg(cfg):
    return jax_cube.CubeConfig(**dataclasses.asdict(cfg))


def mesh():
    return make_mesh(jax.devices()[:1], vis_shards=1)


@pytest.fixture(scope="module")
def batches():
    """One channel of noise plus 5 point sources (10-100x the dirty RMS),
    as a port batch and a JAX batch."""
    tb = multichannel.make_example_batch(
        multichannel.MultiChannelConfig(**SMALL, weight_type="natural"), 1,
        seed=5, device="cpu")
    tb, pos, flux = cube.with_point_sources(CFG, tb, seed=1)
    jb = jax_mc.ChannelBatch(**convert.batch_to_numpy(tb))
    return tb, jb, pos, flux


@pytest.fixture(scope="module")
def waves(batches):
    """The port's and the JAX wave (XLA assemblies) on the same batch."""
    tb, jb, _, _ = batches
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KTPU_FFT", raising=False)
        mp.delenv("KTPU_GRID_ASSEMBLY", raising=False)
        ref = jax_cube.make_wave_image(mesh(), jax_cfg(CFG))(jb)
    return cube.wave_image(CFG, tb), jax_cube.WaveResult(
        *(np.asarray(x) for x in ref))


def field(tb):
    t = tb.taper1d[0].double().numpy()
    t2 = np.outer(t, t)
    return t2 >= 0.002 * t2.max()


def dirty_peak(tb, res):
    """Peak of channel 0's PSF-normalised dirty image."""
    args, nc = cube._channel(tb, 0)
    kern, tap, ps, midw, uv, sub, wp, anc, val, _, vis = args
    dirty = cube._grid_slices(CFG, kern, None, uv, sub, wp, anc, val, vis,
                              tap, ps, midw, nc)
    return float((dirty / res.psf_peak[0][:, None, None]).abs().max())


def test_wave_image_matches_jax(batches, waves):
    tb, _, _, _ = batches
    got, ref = waves
    inside = field(tb)
    peak = dirty_peak(tb, got)
    assert got.residual.shape == ref.residual.shape == (1, 1, 256, 256)
    np.testing.assert_array_equal(got.minor.numpy(), ref.minor)
    np.testing.assert_allclose(got.noise.numpy(), ref.noise, rtol=1e-5)
    np.testing.assert_allclose(got.psf_peak.numpy(), ref.psf_peak,
                               rtol=1e-5)
    np.testing.assert_allclose(got.psf_core.numpy(), ref.psf_core,
                               atol=1e-5)
    np.testing.assert_array_equal(got.weights_noise.numpy(),
                                  ref.weights_noise)
    np.testing.assert_array_equal(got.normalized_noise.numpy(),
                                  ref.normalized_noise)
    model = got.model.numpy()[0, 0]
    residual = got.residual.numpy()[0, 0]
    np.testing.assert_array_equal((model != 0)[inside],
                                  (ref.model[0, 0] != 0)[inside])
    for a, b in ((model, ref.model[0, 0]), (residual, ref.residual[0, 0])):
        assert np.isfinite(a).all()
        assert np.abs(a - b)[inside].max() <= 1e-4 * peak


def test_wave_recovers_the_sources(batches, waves):
    """CLEAN puts components on every source, and the restored image
    reads each source's flux at its position to 10%."""
    tb, _, pos, flux = batches
    got, _ = waves
    model = got.model.numpy()[0, 0]
    for y, x in pos:
        assert model[y, x] != 0
    ms, _ = cube.fit_wave_beams(got.psf_core)
    restored = cube.wave_restore(CFG, got.model, got.residual, ms)
    at_src = restored.numpy()[0, 0, pos[:, 0], pos[:, 1]]
    np.testing.assert_allclose(at_src, flux[0], rtol=0.1)
    assert int(got.minor[0]) > 0


@pytest.mark.parametrize("primary_beam", [False, True])
def test_wave_restore_matches_jax(waves, primary_beam):
    """On the JAX wave's own model, residual and fitted beams."""
    _, ref = waves
    cfg = dataclasses.replace(CFG, primary_beam=primary_beam,
                              primary_beam_cutoff=0.3)
    ms, _ = jax_cube.fit_wave_beams(ref.psf_core)
    extra = ()
    if primary_beam:
        y, x = np.mgrid[:256, :256] - 128
        extra = (np.exp(-(y * y + x * x) / 2e4).astype(np.float32)[None],)
    want = np.asarray(jax_cube.make_wave_restore(mesh(), jax_cfg(cfg))(
        *(jnp.asarray(a) for a in (ref.model, ref.residual, ms) + extra)))
    got = cube.wave_restore(
        cfg, torch.from_numpy(ref.model), torch.from_numpy(ref.residual),
        ms, *(torch.from_numpy(a) for a in extra)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.isnan(want).any() == primary_beam
    np.testing.assert_allclose(got[ok], want[ok],
                               atol=1e-5 * np.abs(want[ok]).max())


def test_fit_wave_beams_match_jax(waves):
    _, ref = waves
    ms, beams = cube.fit_wave_beams(torch.from_numpy(ref.psf_core.copy()))
    jms, jbeams = jax_cube.fit_wave_beams(ref.psf_core)
    np.testing.assert_allclose(ms, jms, rtol=1e-6)
    for b, jb in zip(beams, jbeams):
        np.testing.assert_allclose(
            [b.major, b.minor, b.theta, beam.beam_area(b)],
            [jb.major, jb.minor, jb.theta, jax_beam.beam_area(jb)],
            rtol=1e-9)


def test_convolve_beam_matches_jax():
    rng = np.random.default_rng(8)
    model = np.zeros((2, 128, 128), np.float32)
    idx = rng.integers(0, 128, size=(2, 40))
    model[:, idx[0], idx[1]] = rng.normal(size=40)
    b = beam.Beam(major=5.0, minor=3.0, theta=0.7)
    got = beam.convolve_beam(torch.from_numpy(model), b).numpy()
    want = np.asarray(jax_beam.convolve_beam(
        model, jax_beam.Beam(major=5.0, minor=3.0, theta=0.7)))
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("weight_type", ["uniform", "robust"])
def test_wave_psf_weights_match_jax(batches, weight_type):
    """Density weights, the normalised PSF and the weights-noise
    statistics of the auto-patch route's phase A."""
    tb, jb, _, _ = batches
    cfg = dataclasses.replace(CFG, weight_type=weight_type, robustness=0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KTPU_FFT", raising=False)
        mp.delenv("KTPU_GRID_ASSEMBLY", raising=False)
        ref = jax_cube.make_wave_psf(mesh(), jax_cfg(cfg))(jb)
    got = cube.wave_psf(cfg, tb)
    np.testing.assert_allclose(got.density.numpy(), np.asarray(ref.density),
                               rtol=1e-6)
    for name in ("psf_peak", "scale", "weights_noise", "normalized_noise"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-5)
    inside = field(tb)    # the PSF's peak is 1: the 1e-4 image gate
    np.testing.assert_allclose(got.psf.numpy()[0, 0][inside],
                               np.asarray(ref.psf)[0, 0][inside], atol=1e-4)
    assert float(got.weights_noise[0]) > 0


def test_auto_patch_route_equals_wave_image(batches, waves):
    """wave_psf then wave_clean at the configured patch is wave_image."""
    tb, _, _, _ = batches
    got, _ = waves
    psf = cube.wave_psf(CFG, tb)
    residual, model, noise, minor = cube.wave_clean(CFG, tb, psf, CFG.patch)
    assert torch.equal(residual, got.residual)
    assert torch.equal(model, got.model)
    assert torch.equal(noise, got.noise) and torch.equal(minor, got.minor)


def test_unported_and_double_inputs_raise(batches):
    tb, _, _, _ = batches
    with pytest.raises(NotImplementedError):
        cube.wave_image(dataclasses.replace(CFG, num_sources=2), tb)
    with pytest.raises(TypeError):
        cube.wave_psf(CFG, tb._replace(vis=tb.vis.to(torch.complex128)))
    with pytest.raises(TypeError):
        cube.wave_image(CFG, tb._replace(taper1d=tb.taper1d.double()))


def test_config_and_results_convert(waves):
    _, ref = waves
    assert convert.config_from(cube.CubeConfig, jax_cfg(CFG)) == CFG
    res = convert.tuple_from_jax(cube.WaveResult, ref)
    back = convert.tuple_to_numpy(res)
    for name in cube.WaveResult._fields:
        np.testing.assert_array_equal(back[name], getattr(ref, name))
