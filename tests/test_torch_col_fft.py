"""Kernel K8 (the plain column DFT) and ``fft2`` of the port against the
JAX package's ``pallas_fft.col_fft`` and ``fft2_pallas`` (Pallas in
interpret mode).  Tolerance as ``tests/test_pallas_fft.py``: 2e-6 of the
largest output (f32 transforms in another order).  Then the index plans
of the tile core that K8, K3, K4, K6 and K7 share, as a numpy model."""

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
# The tile core's index plans, without the card: a numpy model of the loops
# of ``csrc/col_fft_tile.cuh`` and of the hooks of K8, K3 and K4 in
# ``csrc/fft.cu`` (every thread, butterfly, shared-memory slot, cluster
# rank, stage slot and output address), in float64, against ``np.fft``
# and the plain versions.  It checks the four-step split N = Q R, the two
# Stockham passes, the cluster's length-Q finish (along columns, or along
# k for K3 and K6), K3's checkerboard load and transposed store, where
# K4's epilogue and prefetches land, where K6's prologue (the core's
# per-value hook) is applied, and K7's checkerboard as a half shift and
# a column sign on load; not the kernels' rounding.  Arrays run
# over (thread, butterfly of the thread, value of the butterfly): one warp
# instruction is 32 consecutive threads at one (butterfly, value).

_COLS, _PER_THREAD = 16, 32

#: (R, R1, R2, Q) of every N the tile kernels take (``with_plan``).
_PLANS = {256: (256, 16, 16, 1), 512: (512, 32, 16, 1),
          1024: (512, 32, 16, 2), 2048: (512, 32, 16, 4),
          4096: (512, 32, 16, 8), 8192: (1024, 32, 32, 8)}


def _bit_reverse(i, rad):
    r, b = 0, 1
    while b < rad:
        r, i, b = (r << 1) | (i & 1), i >> 1, b << 1
    return r


def _dft_reg(v, tw, n_over_rad, sgn):
    """``dft_reg`` along the last axis of ``v``."""
    rad = v.shape[-1]
    v = v[..., [_bit_reverse(i, rad) for i in range(rad)]]
    h = 1
    while h < rad:
        for j in range(h):
            w = tw[j * (rad // (2 * h)) * n_over_rad]
            w = w.real + 1j * sgn * w.imag
            for k in range(j, rad, 2 * h):
                t = v[..., k + h] if j == 0 else w * v[..., k + h]
                v[..., k + h], v[..., k] = v[..., k] - t, v[..., k] + t
        h <<= 1
    return v


def _written_once(idx, size):
    """Every slot of ``range(size)`` in ``idx`` exactly once."""
    np.testing.assert_array_equal(np.sort(idx, axis=None), np.arange(size))


def _conflict_free(idx):
    """Each half-warp of each instruction reads or writes 16 float2 slots
    on distinct bank pairs (``idx`` in float2 units, thread axis first)."""
    half = np.moveaxis(idx.reshape(idx.shape[0] // 16, 16, -1) % 16, 1, -1)
    assert (np.diff(np.sort(half, axis=-1), axis=-1) != 0).all()


def _tile_model(load, N, plan, sgn, along_k=False, prep=None):
    """One tile of ``col_fft_tile``: ``load(rows, c)`` gives the inputs at
    plane rows ``rows`` of tile column ``c``, called once for each CTA q
    of the cluster in turn, and ``prep(rows, c, values)`` (the core's
    per-value hook; None: the identity) turns them into the DFT's input.  Returns, for each CTA, what it hands its
    store hook as ``(k, c, y)``: the values y[k1] of a k2 at rows
    k = k2 + R k1 of tile column c (k1 on the last axis when Q > 1).
    ``along_k`` is the finish ``Finish::kAlongK``."""
    R, R1, R2, Q = plan
    T, L = R * _COLS // _PER_THREAD, R // Q
    tw = np.exp(2j * np.pi * np.arange(N) / N)

    def twiddle(k):
        return tw[k].real + 1j * sgn * tw[k].imag

    def butterflies(nb):          # b = tid + u T: (thread, butterfly, 1)
        return (np.arange(T)[:, None] + np.arange(nb)[None, :] * T)[..., None]

    def slot(k2, c):              # a partial sum's place in buf
        return c * R + (k2 ^ c) if along_k else k2 * _COLS + c

    bufs, out = [], []
    for q in range(Q):
        b = butterflies(_PER_THREAD // R1)                     # pass 1
        c, j, i = b % _COLS, b // _COLS, np.arange(R1)
        rows = q + Q * (j + i * (R // R1))
        v = load(rows, c)
        if prep is not None:
            v = prep(*np.broadcast_arrays(rows, c), v)
        v = _dft_reg(v, tw, N // R1, sgn)
        slots = (j * R1 + i) * _COLS + c
        _written_once(slots, R * _COLS)
        buf = np.full(R * _COLS, np.nan, complex)
        buf[slots] = v
        b = butterflies(_PER_THREAD // R2)                     # pass 2
        c, j, i = b % _COLS, b // _COLS, np.arange(R2)
        v = buf[(j + i * R1) * _COLS + c] * twiddle(j * i * (N // R))
        v = _dft_reg(v, tw, N // R2, sgn)
        k2 = j + i * R1
        if Q == 1:
            out.append((k2, c, v))
        else:
            slots = slot(k2, c)
            _written_once(slots, R * _COLS)
            _conflict_free(slots)
            buf[slots] = twiddle(q * k2) * v
        bufs.append(buf)
    for q in range(Q if Q > 1 else 0):                         # the cluster
        e = butterflies(_PER_THREAD // Q)
        c = e // L if along_k else e % _COLS
        k2 = q * L + (e % L if along_k else e // _COLS)
        _conflict_free(slot(k2, c))
        blocks = slot(k2, c).reshape(T // 16, 16, -1) // 16    # 128 bytes
        assert (blocks == blocks[:, :1]).all()
        z = np.concatenate([bufs[s][slot(k2, c)] for s in range(Q)], -1)
        out.append((k2 + R * np.arange(Q), c, _dft_reg(z, tw, N // Q, sgn)))
    return out


def _k8_model(x, plan, sgn):
    N, M = x.shape
    y = np.full_like(x, np.nan)
    for c0 in range(0, M, _COLS):
        def load(rows, c):
            return np.where(c0 + c < M, x[rows, np.minimum(c0 + c, M - 1)], 0)

        for k, c, v in _tile_model(load, N, plan, sgn):
            k, c, v = np.broadcast_arrays(k, c0 + c, v)
            live = c < M
            y[k[live], c[live]] = v[live]
    return y


def _transposed_model(x, cols, plan, sgn, load, prep=None):
    """A tile kernel with K3's transposed store on the tiles of the
    column subset ``cols`` (whole tiles) of (P, N, N) planes, given as
    ``x[p][:, i]`` at column ``cols[i]``; ``load(xp, rows, c, c0)`` gives
    plane ``xp``'s inputs at tile column c of the tile at column c0.  Each
    output address once, each warp on 32 consecutive floats: with
    clusters straight from a finish along k, without through a stage in
    shared memory (every slot once, free of bank conflicts).  Returns rows
    ``cols`` of the (P, N, N) output."""
    R, R1, R2, Q = plan
    P, N, _ = x.shape
    T = R * _COLS // _PER_THREAD
    yT = np.full((P, len(cols), N), np.nan, complex)
    for p in range(P):
        for t0 in range(0, len(cols), _COLS):
            c0 = cols[t0]
            xp = x[p][:, t0:t0 + _COLS]
            tile = _tile_model(
                lambda rows, c: load(xp, rows, c, c0), N, plan, sgn,
                along_k=Q > 1,
                prep=None if prep is None else
                lambda rows, c, v: prep(rows, c0 + c, v))
            for k, c, y in tile:
                k, c, y = np.broadcast_arrays(k, c, y)
                if Q == 1:
                    stage = np.full(R * _COLS, np.nan, complex)
                    idx = c * R + (k ^ c)                      # column_slot
                    _written_once(idx, R * _COLS)
                    _conflict_free(idx)
                    stage[idx] = y
                    e = np.arange(T)[:, None] + np.arange(R * _COLS // T) * T
                    c, k = e // R, e % R
                    src = c * R + (k ^ c)
                    _conflict_free(src)
                    y = stage[src]
                addr = (c0 + c) * N + k
                warps = addr.reshape(T // 32, 32, -1)
                assert (np.diff(warps, axis=1) == 1).all()
                assert np.unique(addr).size == addr.size
                assert np.isnan(yT[p, t0 + c, k]).all()
                yT[p, t0 + c, k] = y
    assert not np.isnan(yT).any()
    return yT


def _k3_model(x, cols, plan):
    """K3 on the tiles of ``cols``: the checkerboard on load, the inverse
    DFT, the transposed store (:func:`_transposed_model`)."""
    def load(xp, rows, c, c0):
        return np.where((rows + c0 + c) % 2, -1, 1) * xp[rows, c]

    return _transposed_model(x, cols, plan, 1, load)


def _prologue(img, r, c, taper, w, ps, N):
    """K6's prologue in float64: the layer of the transposed image at
    (r, c)."""
    lm_r, lm_c = (r - N / 2) * ps, (c - N / 2) * ps
    n = np.sqrt(1 - lm_r * lm_r - lm_c * lm_c)
    pre = img * np.where((r + c) % 2, -1, 1) / (taper[r] * taper[c] * n)
    return pre * np.exp(-2j * np.pi * w * (n - 1))


def _k6_model(img, cols, plan, taper, w, ps):
    """K6 on the tiles of ``cols``: the load hook fetches only the image
    value, the per-value hook applies the prologue at its (row, column),
    then the forward DFT and K3's transposed store."""
    N = img.shape[1]
    fetched = []

    def load(xp, rows, c, c0):
        fetched.append(xp[rows, c])
        return xp[rows, c].astype(complex)

    def prep(rows, c, v):
        assert (v.imag == 0).all()
        assert any(v.shape == f.shape and (v.real == f).all()
                   for f in fetched)
        return _prologue(v.real, rows, c, taper, w, ps, N)

    return _transposed_model(img, cols, plan, -1, load, prep)


def _k7_model(x, cols, plan):
    """K7 on the tiles of ``cols``: the load hook reads row (r + N/2) mod N
    (a half shift, which makes the output's (-1)^k) with odd columns
    negated, the forward DFT, stored in natural orientation; the loads
    cover every input row once, every half-warp stores 16 consecutive
    floats (64 bytes) of a row, each address once.  Returns the columns
    ``cols`` of the (P, N, N) output."""
    R, _, _, Q = plan
    P, N, _ = x.shape
    T = R * _COLS // _PER_THREAD
    y = np.full(x.shape, np.nan, complex)
    for p in range(P):
        for t0 in range(0, len(cols), _COLS):
            c0 = cols[t0]
            read = []

            def load(rows, c):
                src = (rows + N // 2) % N
                read.append(np.broadcast_arrays(src, c))
                return np.where((c0 + c) % 2, -1, 1) * x[p][src, t0 + c]

            tile = _tile_model(load, N, plan, -1)
            src = np.concatenate([(r * _COLS + c).ravel() for r, c in read])
            _written_once(src, N * _COLS)
            for k, c, v in tile:
                k, c, v = np.broadcast_arrays(k, c, v)
                addr = k * N + c0 + c
                half = addr.reshape(T // 16, 16, -1)
                assert (np.diff(half, axis=1) == 1).all()
                assert np.isnan(y[p, k, t0 + c]).all()
                y[p, k, t0 + c] = v
    assert not np.isnan(y).any()
    return y


def _epilogue(img, y, r, c, taper, w, ps, N):
    """K4's epilogue in float64."""
    lm_r, lm_c = (r - N / 2) * ps, (c - N / 2) * ps
    n = np.sqrt(1 - lm_r * lm_r - lm_c * lm_c)
    ph = 2 * np.pi * w * (n - 1)
    common = np.where((r + c) % 2, -1, 1) * n / (taper[r] * taper[c])
    return img + y.real * np.cos(ph) * common - y.imag * np.sin(ph) * common


def _k4_model(x, img, cols, plan, taper, w, ps):
    """K4 on the tiles of ``cols``: plain load, the epilogue at each
    finished value's (row k, column c0 + c), each once, and the image
    values each CTA prefetches as it loads, which are the ones it
    updates.  ``x`` and ``img`` hold the columns ``cols`` of (P, N, N)
    planes; ``img`` is updated in place."""
    R, _, _, Q = plan
    P, N, _ = x.shape
    L = R // Q
    seen = np.zeros(img.shape, int)
    for p in range(P):
        for t0 in range(0, len(cols), _COLS):
            fetched = []

            def load(rows, c):
                q, r2 = rows % Q, rows // Q          # rows = q + Q r2
                row = q * L + r2 % L + R * (r2 // L)
                fetched.append(np.broadcast_arrays(row, c))
                return x[p][rows, t0 + c]

            out = _tile_model(load, N, plan, 1)
            for (k, c, y), f in zip(out, fetched):
                k, c, y = np.broadcast_arrays(k, c, y)
                np.testing.assert_array_equal(
                    np.sort((f[0] * _COLS + f[1]).ravel()),
                    np.sort((k * _COLS + c).ravel()))
                img[p, k, t0 + c] = _epilogue(img[p, k, t0 + c], y, k,
                                              cols[t0] + c, taper, w, ps, N)
                seen[p, k, t0 + c] += 1
    assert (seen == 1).all()


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
        got = _k8_model(x, plan, sgn)
        np.testing.assert_allclose(got, ref, atol=1e-10 * np.abs(ref).max())


def _columns(N):
    """The first and the last tile of columns."""
    return np.r_[0:_COLS, N - _COLS:N]


def _square_or_columns(rng, P, N):
    """Complex (P, N, N) planes where the plain versions can hold them at
    test size (N <= 1024), else only their columns ``_columns(N)``."""
    shape = (P, N, N if N <= 1024 else 2 * _COLS)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (x, x[..., _columns(N)]) if N <= 1024 else (None, x)


@pytest.mark.parametrize("N", sorted(_PLANS))
def test_k3_tile_plan_model(N):
    """K3's plan at every dispatched (R, R1, R2, Q), two planes: against
    ``cb_col_fft_plain`` (float64) at N <= 1024 and ``np.fft`` above."""
    cols = _columns(N)
    square, x = _square_or_columns(np.random.default_rng(N), 2, N)
    got = _k3_model(x, cols, _PLANS[N])
    if square is not None:
        tr, ti = fused_fft.cb_col_fft_plain(torch.from_numpy(square.real),
                                            torch.from_numpy(square.imag))
        ref = (tr.numpy() + 1j * ti.numpy())[:, cols]
    else:
        cb = np.where((np.arange(N)[:, None] + cols) % 2, -1, 1)
        ref = np.swapaxes(np.fft.ifft(cb * x, axis=1) * N, 1, 2)
    np.testing.assert_allclose(got, ref, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("N", sorted(_PLANS))
def test_k4_tile_plan_model(N):
    """K4's plan at every dispatched (R, R1, R2, Q), two planes: against
    ``epi_col_fft_plain`` at N <= 1024 (f32 epilogue factors: 1e-5 of
    the peak at w = 7) and the float64 epilogue on ``np.fft`` above."""
    cols = _columns(N)
    rng = np.random.default_rng(N + 1)
    square, x = _square_or_columns(rng, 2, N)
    img = rng.normal(size=x.shape)
    taper = 0.5 + rng.random(N)
    w, ps = 7.0, 1.0 / (16 * N)
    got = img.copy()
    _k4_model(x, got, cols, _PLANS[N], taper, w, ps)
    if square is not None:
        full = rng.normal(size=square.shape)
        full[..., cols] = img
        ref = fused_fft.epi_col_fft_plain(
            torch.from_numpy(square.real), torch.from_numpy(square.imag),
            torch.from_numpy(full), torch.from_numpy(taper),
            torch.tensor([w, ps], dtype=torch.float64)).numpy()[..., cols]
        tol = 1e-5
    else:
        y = np.fft.ifft(x, axis=1) * N
        ref = _epilogue(img, y, np.arange(N)[:, None], cols[None, :], taper,
                        w, ps, N)
        tol = 1e-10
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("N", sorted(_PLANS))
def test_k6_tile_plan_model(N):
    """K6's plan at every dispatched (R, R1, R2, Q), two planes: against
    ``pre_col_fft_plain`` at N <= 1024 (f32 prologue factors: 1e-5 of the
    peak at w = 7) and the float64 prologue on ``np.fft`` above."""
    cols = _columns(N)
    rng = np.random.default_rng(N + 2)
    square, x = _square_or_columns(rng, 2, N)
    taper = 0.5 + rng.random(N)
    w, ps = 7.0, 1.0 / (16 * N)
    got = _k6_model(x.real, cols, _PLANS[N], taper, w, ps)
    if square is not None:
        tr, ti = fused_fft.pre_col_fft_plain(
            torch.from_numpy(square.real), torch.from_numpy(taper),
            torch.tensor([w, ps], dtype=torch.float64))
        ref = (tr.numpy() + 1j * ti.numpy())[:, cols]
        tol = 1e-5
    else:
        layer = _prologue(x.real, np.arange(N)[:, None], cols[None, :],
                          taper, w, ps, N)
        ref = np.swapaxes(np.fft.fft(layer, axis=1), 1, 2)
        tol = 1e-10
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("N", sorted(_PLANS))
def test_k7_tile_plan_model(N):
    """K7's plan at every dispatched (R, R1, R2, Q), two planes: against
    ``cbout_col_fft_plain`` (float64) at N <= 1024 and ``np.fft`` times
    the checkerboard above."""
    cols = _columns(N)
    square, x = _square_or_columns(np.random.default_rng(N + 3), 2, N)
    got = _k7_model(x, cols, _PLANS[N])
    if square is not None:
        tr, ti = fused_fft.cbout_col_fft_plain(torch.from_numpy(square.real),
                                               torch.from_numpy(square.imag))
        ref = (tr.numpy() + 1j * ti.numpy())[..., cols]
    else:
        cb = np.where((np.arange(N)[:, None] + cols) % 2, -1, 1)
        ref = cb * np.fft.fft(x, axis=1)
    np.testing.assert_allclose(got, ref, atol=1e-10 * np.abs(ref).max())
