"""The port's CLEAN (``ops/clean.py``) against the JAX package's, on
identical inputs: the noise estimate exactly, the tile cache exactly
(to one ulp for the SUMSQ metric),
minor cycles with equal component positions and cycle counts and fluxes
to f32 rounding (the subtraction's f32 products may round differently:
1e-6 of the peak)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu.ops import clean as jax_clean
from katsdpimager_tpu_torch import convert
from katsdpimager_tpu_torch.ops import clean

torch.set_num_threads(2)


def psf(P, patch):
    y, x = np.mgrid[:patch, :patch] - patch // 2
    p = np.exp(-(y * y + x * x) / 8.0).astype(np.float32)
    return np.repeat(p[None], P, axis=0)


def image(seed, P=1, N=128, sources=()):
    """Noise plus PSF-shaped (dirty) point sources ``(y, x, flux)``."""
    rng = np.random.default_rng(seed)
    img = rng.normal(scale=0.05, size=(P, N, N)).astype(np.float32)
    beam = psf(P, 17)
    for y, x, a in sources:
        img[:, y - 8:y + 9, x - 8:x + 9] += a * beam
    return img


def configs(mode, P, border, patch, N=128):
    kw = dict(pixels=N, num_pols=P, border_pixels=border, patch_y=patch,
              patch_x=patch, mode=mode, loop_gain=0.2)
    return clean.CleanConfig(**kw), jax_clean.CleanConfig(**kw)


@pytest.mark.parametrize("shape,border", [((1, 128, 128), 0),
                                          ((2, 64, 64), 5),
                                          ((1, 33, 33), 1)])
def test_noise_est_equals_jax(shape, border):
    """Exact order statistics: the same float as the JAX rank search."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    x[0, 3, 3] = 0.0
    got = clean.noise_est(torch.from_numpy(x), border_pixels=border)
    ref = jax_clean.noise_est(jnp.asarray(x), border_pixels=border)
    assert got.dim() == 0
    assert float(got) == float(ref)


@pytest.mark.parametrize("mode,P", [(clean.CLEAN_I, 1),
                                    (clean.CLEAN_SUMSQ, 2)])
def test_reset_equals_jax(mode, P):
    tcfg, jcfg = configs(mode, P, border=3, patch=17)
    img = image(2, P)
    st = clean.make_state(tcfg, torch.from_numpy(img),
                          torch.zeros((P, 128, 128)))
    js = jax_clean.make_state(jcfg, jnp.asarray(img),
                              jnp.zeros((P, 128, 128), jnp.float32))
    # CLEAN_I's metric |x| is exact; the SUMSQ metric's f32 sum of
    # squares may round differently in XLA (one ulp).
    np.testing.assert_allclose(st.tile_max.numpy(), np.asarray(js.tile_max),
                               rtol=0 if mode == clean.CLEAN_I else 1e-6)
    np.testing.assert_array_equal(st.tile_pos.numpy(),
                                  np.asarray(js.tile_pos))
    np.testing.assert_array_equal(st.residual.numpy(),
                                  np.asarray(js.residual))


#: (mode, P, border, patch, threshold, max_cycles): a threshold stop
#: inside the first batch, a run over a batch boundary, SUMSQ with a
#: border, and a patch wider than the tile window.
CASES = {
    "I-threshold": (clean.CLEAN_I, 1, 0, 17, 0.5, 500),
    "I-batches": (clean.CLEAN_I, 1, 4, 33, 0.0, clean.CYCLE_BATCH + 7),
    "SUMSQ-border": (clean.CLEAN_SUMSQ, 2, 6, 17, 0.3, 300),
    "I-wide-patch": (clean.CLEAN_I, 1, 0, 65, 0.4, 200),
}


@pytest.mark.parametrize("name", list(CASES))
def test_minor_cycles_match_jax(name):
    mode, P, border, patch, threshold, max_cycles = CASES[name]
    tcfg, jcfg = configs(mode, P, border, patch)
    img = image(3, P, sources=[(30, 40, 3.0), (90, 70, 2.0),
                               (60, 100, 1.5), (100, 20, 2.5)])
    p = psf(P, patch)
    st = clean.make_state(tcfg, torch.from_numpy(img),
                          torch.zeros((P, 128, 128)))
    js = jax_clean.make_state(jcfg, jnp.asarray(img),
                              jnp.zeros((P, 128, 128), jnp.float32))
    st, k, first, last = clean.minor_cycles(
        tcfg, st, torch.from_numpy(p), threshold, max_cycles)
    js, jk, jfirst, jlast = jax_clean.minor_cycles(
        jcfg, js, jnp.asarray(p), jnp.float32(threshold), max_cycles)
    assert int(k) == int(jk) > 0
    if threshold == 0.0:
        assert int(k) == max_cycles
    else:
        assert int(k) < max_cycles        # stopped by the threshold
    jmodel = np.asarray(js.model)
    model = st.model.numpy()
    np.testing.assert_array_equal(model != 0, jmodel != 0)
    peak = np.abs(img).max()
    np.testing.assert_allclose(model, jmodel, atol=1e-6 * peak)
    np.testing.assert_allclose(st.residual.numpy(), np.asarray(js.residual),
                               atol=1e-6 * peak)
    np.testing.assert_allclose(float(first), float(jfirst), rtol=1e-6)
    np.testing.assert_allclose(float(last), float(jlast), rtol=1e-6)


def test_ties_go_to_the_first_maximum():
    """Equal peaks in two tiles and inside one tile: both frameworks take
    the first in row-major order (``torch.argmax`` as ``jnp.argmax``)."""
    tcfg, jcfg = configs(clean.CLEAN_I, 1, 0, 9)
    img = np.zeros((1, 128, 128), np.float32)
    img[0, 70, 10] = img[0, 70, 100] = img[0, 5, 80] = img[0, 5, 81] = 2.0
    p = psf(1, 9)
    st = clean.make_state(tcfg, torch.from_numpy(img),
                          torch.zeros((1, 128, 128)))
    js = jax_clean.make_state(jcfg, jnp.asarray(img),
                              jnp.zeros((1, 128, 128), jnp.float32))
    st, *_ = clean.minor_cycles(tcfg, st, torch.from_numpy(p), 0.0, 1)
    js, *_ = jax_clean.minor_cycles(jcfg, js, jnp.asarray(p),
                                    jnp.float32(0.0), 1)
    assert np.argwhere(st.model.numpy()[0]).tolist() == [[5, 80]]
    np.testing.assert_array_equal(st.model.numpy(), np.asarray(js.model))


def test_no_cycle_after_the_stop_changes_anything():
    """Cycles queued after the stop within a batch subtract exactly zero
    and add no component: the state equals a run capped at the stop."""
    tcfg, _ = configs(clean.CLEAN_I, 1, 0, 17)
    img = image(4, sources=[(64, 64, 3.0)])
    p = torch.from_numpy(psf(1, 17))

    def run(max_cycles):
        st = clean.make_state(tcfg, torch.from_numpy(img),
                              torch.zeros((1, 128, 128)))
        return clean.minor_cycles(tcfg, st, p, 1.0, max_cycles)

    st, k, _, _ = run(clean.CYCLE_BATCH)
    assert 0 < int(k) < clean.CYCLE_BATCH
    capped, k2, _, _ = run(int(k))
    assert int(k2) == int(k)
    assert torch.equal(st.residual, capped.residual)
    assert torch.equal(st.model, capped.model)
    assert torch.equal(st.tile_max, capped.tile_max)


def test_state_converts_between_packages():
    tcfg, jcfg = configs(clean.CLEAN_I, 1, 2, 17)
    js = jax_clean.make_state(jcfg, jnp.asarray(image(5)),
                              jnp.zeros((1, 128, 128), jnp.float32))
    st = convert.tuple_from_jax(clean.CleanState, js)
    back = jax_clean.CleanState(**convert.tuple_to_numpy(st))
    for a, b in zip(back, js):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert convert.config_from(clean.CleanConfig, jcfg) == tcfg


@pytest.mark.parametrize("mode,threshold,pols", [(clean.CLEAN_I, 5.0, 1),
                                                  (clean.CLEAN_SUMSQ, 5.0, 4),
                                                  (clean.CLEAN_SUMSQ, 3.0, 2)])
def test_host_helpers_equal_jax(mode, threshold, pols):
    assert (clean.noise_threshold_scale(mode, threshold, pols)
            == jax_clean.noise_threshold_scale(mode, threshold, pols))
    assert (clean.metric_to_power(mode, 2.25)
            == jax_clean.metric_to_power(mode, 2.25))
    assert (clean.power_to_metric(mode, 1.5)
            == jax_clean.power_to_metric(mode, 1.5))
    p = psf(2, 65)
    for limit in (None, 0.1):
        assert (clean.psf_patch(p, 0.2, limit)
                == jax_clean.psf_patch(p, 0.2, limit))
