"""The port's direct prediction (``ops/predict.py``) against the JAX
package's: ``predict_subtract`` with 37 sources over 20,000 visibilities
(crossing the 8192-visibility block boundary) to 1e-5 of the largest
prediction (f32 phases and products in another order), and the
component extraction and dequantization constants exactly."""

import numpy as np
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
