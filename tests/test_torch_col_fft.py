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


# ---------------------------------------------------------------------------
# K8's index plan, without the card: a numpy model of the loops of
# ``csrc/col_fft_tile.cuh`` (every thread, butterfly, shared-memory slot
# and cluster rank), in float64, against ``np.fft``.  It checks the
# four-step split N = Q R, the two Stockham passes and the cluster's
# length-Q finish, not the kernel's rounding.

_COLS, _PER_THREAD = 16, 32


def _bit_reverse(i, rad):
    r, b = 0, 1
    while b < rad:
        r, i, b = (r << 1) | (i & 1), i >> 1, b << 1
    return r


def _dft_reg(v, tw, n_over_rad, sgn):
    rad = len(v)
    v = list(v)
    for i in range(rad):
        r = _bit_reverse(i, rad)
        if r > i:
            v[i], v[r] = v[r], v[i]
    h = 1
    while h < rad:
        for j in range(h):
            w = tw[j * (rad // (2 * h)) * n_over_rad]
            w = w.real + 1j * sgn * w.imag
            for k in range(j, rad, 2 * h):
                t = v[k + h] if j == 0 else w * v[k + h]
                v[k + h], v[k] = v[k] - t, v[k] + t
        h <<= 1
    return v


def _col_fft_tile_model(x, R, R1, R2, Q, sgn):
    N, M = x.shape
    tw = np.exp(2j * np.pi * np.arange(N) / N)

    def twiddle(k):
        return tw[k].real + 1j * sgn * tw[k].imag

    T = R * _COLS // _PER_THREAD
    y = np.zeros_like(x)
    for c0 in range(0, M, _COLS):
        bufs = []
        for q in range(Q):
            buf = np.zeros(R * _COLS, complex)
            for b in range(T * (_PER_THREAD // R1)):           # pass 1
                c, j = b % _COLS, b // _COLS
                v = [x[q + Q * (j + i * (R // R1)), c0 + c]
                     if c0 + c < M else 0 for i in range(R1)]
                v = _dft_reg(v, tw, N // R1, sgn)
                for i in range(R1):
                    buf[(j * R1 + i) * _COLS + c] = v[i]
            out = np.empty_like(buf)
            for b in range(T * (_PER_THREAD // R2)):           # pass 2
                c, j = b % _COLS, b // _COLS
                v = [buf[(j + i * R1) * _COLS + c] for i in range(R2)]
                v = [v[0]] + [twiddle(j * i * (N // R)) * v[i]
                              for i in range(1, R2)]
                v = _dft_reg(v, tw, N // R2, sgn)
                for i in range(R2):
                    k2 = j + i * R1
                    if Q == 1:
                        if c0 + c < M:
                            y[k2, c0 + c] = v[i]
                    else:
                        out[k2 * _COLS + c] = twiddle(q * k2) * v[i]
            bufs.append(out)
        for q in range(Q if Q > 1 else 0):                     # the cluster
            for e in range(T * (_PER_THREAD // Q)):
                c, k2 = e % _COLS, q * (R // Q) + e // _COLS
                z = _dft_reg([bufs[s][k2 * _COLS + c] for s in range(Q)],
                             tw, N // Q, sgn)
                if c0 + c < M:
                    for k1 in range(Q):
                        y[k2 + R * k1, c0 + c] = z[k1]
    return y


# (R, R1, R2, Q) as ``ktt_col_fft`` dispatches N = 256, 512, 1024 and
# 4096, and a cluster of 8 at a smaller R.
@pytest.mark.parametrize("plan,M", [((256, 16, 16, 1), 20),
                                    ((512, 32, 16, 1), 16),
                                    ((512, 32, 16, 2), 20),
                                    ((128, 8, 16, 8), 20),
                                    ((512, 32, 16, 8), 16)])
def test_k8_tile_plan_model(plan, M):
    R, R1, R2, Q = plan
    rng = np.random.default_rng(R + Q)
    x = rng.normal(size=(Q * R, M)) + 1j * rng.normal(size=(Q * R, M))
    for sgn, ref in ((-1, np.fft.fft(x, axis=0)),
                     (1, np.fft.ifft(x, axis=0) * Q * R)):
        got = _col_fft_tile_model(x, R, R1, R2, Q, sgn)
        np.testing.assert_allclose(got, ref, atol=1e-10 * np.abs(ref).max())
