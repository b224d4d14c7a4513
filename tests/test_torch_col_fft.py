"""Kernel K8 (the plain column DFT) and ``fft2`` of the port against the
JAX package's ``pallas_fft.col_fft`` and ``fft2_pallas`` (Pallas in
interpret mode).  Tolerance as ``tests/test_pallas_fft.py``: 2e-6 of the
largest output (f32 transforms in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu.ops import pallas_fft
from katsdpimager_tpu_torch.ops import fused_fft


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("N", [256, 512])
@pytest.mark.parametrize("sign", [-1, +1])
def test_col_fft_plain_matches_jax(N, sign):
    xr, xi = _planes(N + sign, (2, N, 384))
    jr, ji = pallas_fft.col_fft(jnp.asarray(xr), jnp.asarray(xi), sign)
    tr, ti = fused_fft.col_fft(torch.from_numpy(xr), torch.from_numpy(xi),
                               sign)
    scale = max(np.abs(np.asarray(jr)).max(), np.abs(np.asarray(ji)).max())
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-6 * scale)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=2e-6 * scale)


@pytest.mark.parametrize("N", [256, 512])
@pytest.mark.parametrize("sign", [-1, +1])
def test_fft2_matches_jax(N, sign):
    xr, xi = _planes(5 * N + sign, (2, N, N))
    x = (xr + 1j * xi).astype(np.complex64)
    ref = np.asarray(pallas_fft.fft2_pallas(jnp.asarray(x), sign=sign))
    got = fused_fft.fft2(torch.from_numpy(x), sign).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max())


def test_col_fft_sign_and_size_checks():
    x = torch.zeros((1, 256, 8))
    with pytest.raises(ValueError):
        fused_fft.col_fft(x, x, 2)
    assert fused_fft.kernel_size_ok(256) and fused_fft.kernel_size_ok(8192)
    assert not fused_fft.kernel_size_ok(384)
    assert not fused_fft.kernel_size_ok(128)
    assert not fused_fft.kernel_size_ok(16384)
