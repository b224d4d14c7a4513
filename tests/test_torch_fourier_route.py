"""The grid <-> image transforms at a size the column-DFT kernels do not
take (N = 384, smooth but not a power of two, as ``next_smooth`` gives):
the port's ``fourier.grid_to_image`` and ``image_to_grid`` against the
JAX package's XLA branch (2e-6 of the peak, f32 FFTs in another
order), and the routing rule: a CUDA image at such a size takes the
``torch.fft`` route by rule and is logged once; at a power of two it
never is."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu.ops import fourier as jax_fourier
from katsdpimager_tpu_torch.ops import fourier

N = 384
PS = 1.0 / (N * 16)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    grid = (rng.normal(size=(2, N, N))
            + 1j * rng.normal(size=(2, N, N))).astype(np.complex64)
    img = rng.normal(size=(2, N, N)).astype(np.float32)
    k1d = (0.5 + rng.uniform(0.2, 1.0, size=N)).astype(np.float32)
    return grid, img, k1d


def test_grid_to_image_matches_jax_xla_branch():
    grid, img, k1d = _inputs(1)
    assert not jax_fourier._use_pallas_fft(N, np.float32, np.complex64)
    ref = np.asarray(jax_fourier.grid_to_image_impl(
        jnp.asarray(grid), jnp.asarray(img), jnp.asarray(k1d), 77.0, PS,
        pixels=N))
    got = fourier.grid_to_image(torch.from_numpy(grid),
                                torch.from_numpy(img),
                                torch.from_numpy(k1d), 77.0, PS).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max())
    parts = fourier.grid_to_image_parts(
        torch.from_numpy(grid.real.copy()), torch.from_numpy(grid.imag.copy()),
        torch.from_numpy(img), torch.from_numpy(k1d), 77.0, PS).numpy()
    np.testing.assert_array_equal(parts, got)


def test_image_to_grid_matches_jax_xla_branch():
    _, img, k1d = _inputs(2)
    ref = np.asarray(jax_fourier.image_to_grid_impl(
        jnp.asarray(img), jnp.asarray(k1d), 31.0, PS, pixels=N))
    got = fourier.image_to_grid(torch.from_numpy(img),
                                torch.from_numpy(k1d), 31.0, PS).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max())
    gr, gi = fourier.image_to_grid_parts(torch.from_numpy(img),
                                         torch.from_numpy(k1d), 31.0, PS)
    np.testing.assert_array_equal(torch.complex(gr, gi).numpy(), got)


def test_route_rule_logs_each_other_size_once(monkeypatch, caplog):
    monkeypatch.setattr(fourier, "_logged_sizes", set())
    cuda = torch.device("cuda")
    with caplog.at_level(logging.INFO, logger=fourier.__name__):
        assert not fourier.use_fused_fft(N, cuda, torch.float32)
        assert not fourier.use_fused_fft(N, cuda, torch.float32,
                                         torch.complex64)
        assert not fourier.use_fused_fft(3024, "cuda", torch.float32)
    routed = [r for r in caplog.records if "torch.fft route" in r.message]
    assert [r.args[0] for r in routed] == [N, 3024]


@pytest.mark.parametrize("n", [256, 512, 4096, 8192])
def test_route_rule_never_leaves_the_kernels_at_powers_of_two(
        monkeypatch, caplog, n):
    monkeypatch.setattr(fourier, "_logged_sizes", set())
    with caplog.at_level(logging.INFO, logger=fourier.__name__):
        assert fourier.use_fused_fft(n, torch.device("cuda"), torch.float32,
                                     torch.complex64)
    assert not caplog.records
    # CPU tensors and float64 take the plain formulas, as in JAX
    assert not fourier.use_fused_fft(n, "cpu", torch.float32)
    assert not fourier.use_fused_fft(n, "cuda", torch.float64)
