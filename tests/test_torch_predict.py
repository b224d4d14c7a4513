"""The port's direct prediction (``ops/predict.py``) against the JAX
package's: ``predict_subtract`` with 37 sources over 20,000 visibilities
(crossing the 8192-visibility block boundary) to 1e-5 of the largest
prediction (f32 phases and products in another order), and the
component extraction and dequantization constants exactly; the exact
predict against the JAX function and the float64 oracle at powers of
two, and against the oracle alone at sizes that are not."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu import parameters, polarization
from katsdpimager_tpu.ops import predict as jax_predict
from katsdpimager_tpu_torch.ops import predict


def _params():
    fixed = parameters.FixedImageParameters(
        (polarization.STOKES_I, polarization.STOKES_Q), "single")
    ap = parameters.ArrayParameters(13.5, 1600.0)
    ip = parameters.make_image_parameters(fixed, 1.0, 5, 1.2e9, ap, None, 256)
    fgp = parameters.FixedGridParameters(7.0, 8, 4, 1600.0, 16)
    return ip, parameters.GridParameters(fgp, 3, 32)


def test_predict_subtract_matches_jax():
    ip, gp = _params()
    uv_scale, w_scale, w_bias = predict.uvw_scale_bias(ip, gp)
    assert (uv_scale, w_scale, w_bias) == jax_predict.uvw_scale_bias(ip, gp)
    rng = np.random.default_rng(11)
    S, n, P = 37, 20000, 2
    lmn = np.zeros((S, 3), np.float32)
    lmn[:, :2] = rng.uniform(-0.02, 0.02, size=(S, 2))
    lmn[:, 2] = np.sqrt(1 - (lmn[:, :2] ** 2).sum(-1)) - 1
    flux = rng.uniform(0.1, 2.0, size=(S, P)).astype(np.float32)
    uv = rng.integers(-100, 100, size=(n, 2)).astype(np.int16)
    sub = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, 32, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, P)) + 1j * rng.normal(size=(n, P))).astype(
        np.complex64)
    wt = rng.uniform(0.5, 2.0, size=(n, P)).astype(np.float32)
    bias = w_bias + 17.5
    ref = np.asarray(jax_predict.predict_subtract(
        *map(jnp.asarray, (lmn, flux, uv, sub, wp, vis, wt)),
        jnp.float32(uv_scale), jnp.float32(w_scale), jnp.float32(bias),
        oversample=8))
    got = predict.predict_subtract(
        *map(torch.from_numpy, (lmn, flux, uv, sub, wp, vis, wt)),
        uv_scale, w_scale, float(np.float32(bias)), oversample=8).numpy()
    largest = np.abs(wt * (vis - ref)).max()
    assert largest > 1.0
    np.testing.assert_allclose(got, ref, atol=1e-5 * largest)


def test_extract_sky_image_matches_jax():
    ip, gp = _params()
    model = np.zeros((2, 256, 256), np.float32)
    model[0, 100, 140] = 1.5
    model[1, 100, 140] = -0.5
    model[0, 30, 200] = 0.25
    got = predict.extract_sky_image(ip, gp, model)
    want = jax_predict.extract_sky_image(ip, gp, model)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _exact_case(pixels, seed, *, n=300, s=12, pols=2):
    """Pixel-grid components and subgrid-quantized visibilities at
    ``pixels``, with the parameters of both packages and the f64 oracle
    (built from the integer pixel coordinates, as tests/test_predict.py
    builds it)."""
    from katsdpimager_tpu_torch import parameters as tparameters
    from katsdpimager_tpu_torch import polarization as tpolarization

    def params(pm, pol):
        fixed = pm.FixedImageParameters((pol.STOKES_I, pol.STOKES_Q))
        ip = pm.ImageParameters(fixed, wavelength=0.21, pixel_size=1e-4,
                                pixels=pixels)
        fgp = pm.FixedGridParameters(antialias_width=7.0, oversample=8,
                                     image_oversample=4, max_w=500.0,
                                     kernel_width=16)
        return ip, pm.GridParameters(fgp, w_slices=3, w_planes=8)

    jip, jgp = params(parameters, polarization)
    ip, gp = params(tparameters, tpolarization)
    rng = np.random.default_rng(seed)
    model = np.zeros((pols, pixels, pixels), np.float32)
    ys = rng.integers(pixels // 4, 3 * pixels // 4, s)
    xs = rng.integers(pixels // 4, 3 * pixels // 4, s)
    model[:, ys, xs] = rng.uniform(0.2, 1.0, (pols, s)).astype(np.float32)
    got = predict.extract_sky_image(ip, gp, model, return_pixels=True)
    want = jax_predict.extract_sky_image(jip, jgp, model, return_pixels=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    lmn, flux, xi, yi = got
    half = max(pixels // 2, 8)
    uv = rng.integers(-half, half, size=(n, 2)).astype(np.int16)
    sub_uv = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    w_plane = rng.integers(0, gp.w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, pols))
           + 1j * rng.normal(size=(n, pols))).astype(np.complex64)
    weights = rng.uniform(0.5, 2.0, size=(n, pols)).astype(np.float32)
    uv_scale, w_scale, w_bias = predict.uvw_scale_bias(ip, gp)
    l64 = xi.astype(np.float64) * float(ip.pixel_size)
    m64 = yi.astype(np.float64) * float(ip.pixel_size)
    lmn64 = np.stack([l64, m64, np.sqrt(1 - l64 * l64 - m64 * m64) - 1], -1)
    oracle = jax_predict.predict_subtract_reference(
        lmn64, flux, uv, sub_uv, w_plane, vis.astype(np.complex128),
        weights, uv_scale, w_scale, w_bias, 8)
    args = (xi, yi, lmn[:, 2], flux, uv, sub_uv, vis, weights, w_plane)
    port = predict.predict_subtract_exact(
        *map(torch.from_numpy, args), float(np.float32(w_scale)),
        float(np.float32(w_bias)), pixels=pixels, oversample=8,
        w_planes=gp.w_planes, block=128).numpy()
    jax_out = np.asarray(jax_predict.predict_subtract_exact(
        *map(jnp.asarray, args), w_scale, w_bias, pixels=pixels,
        oversample=8, w_planes=gp.w_planes, block=128))
    return port, jax_out, oracle


@pytest.mark.parametrize("pixels", [16, 256])
def test_predict_subtract_exact_matches_jax(pixels):
    """At powers of two (M = 2 N O a power of two) the port's exact
    predict matches the JAX function and the f64 oracle within 2e-6 of
    the oracle's largest value (tests/test_predict.py's tolerance: only
    the w-phase trig and the flux products are f32)."""
    port, jax_out, oracle = _exact_case(pixels, pixels)
    scale = np.abs(oracle).max()
    assert np.abs(port - jax_out).max() <= 2e-6 * scale
    assert np.abs(port - oracle).max() <= 2e-6 * scale


@pytest.mark.parametrize("pixels", [12, 1000])
def test_predict_subtract_exact_at_sizes_not_powers_of_two(pixels):
    """At sizes that are not powers of two the port's exact predict
    reduces its phase index modulo M exactly and matches the f64 oracle
    within 2e-6 of its largest value; the JAX function, which reduces
    with ``& (M - 1)``, misses the oracle by far more (a trap in the
    reference that the port does not copy)."""
    port, jax_out, oracle = _exact_case(pixels, pixels)
    scale = np.abs(oracle).max()
    assert np.abs(port - oracle).max() <= 2e-6 * scale
    assert np.abs(jax_out - oracle).max() > 1e-2 * scale
