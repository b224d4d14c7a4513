"""The port's image -> grid transform (K6 + K7 plain versions, and the
plain formula) and fused degridder (K5 plain version,
``degrid_chunks_parts``) against the JAX fused Pallas kernels
(interpret mode) and the numpy scatter degrid oracle.

Tolerances: 1e-5 of peak throughout.  Measured here: K6 + K7 within
3.2e-7 of the grid's peak (f32 DFT rounding at N = 256); K5 within 1.5e-7
of the largest prediction against JAX and 5e-7 against the oracle (f32
sums of K^2 = 256 taps in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu.ops import fourier as jax_fourier
from katsdpimager_tpu.ops import gridder
from katsdpimager_tpu.ops import mxu_gridder as jax_mxu
from katsdpimager_tpu.ops import pallas_fft
from katsdpimager_tpu_torch.ops import (fourier, fused_degrid, fused_fft,
                                        mxu_gridder)

torch.set_num_threads(2)

N = 256
W, PS = 123.0, 1.0 / (N * 16)
K, TS, O, WP, MC = 16, 32, 8, 4, 64


def image_case(P):
    rng = np.random.default_rng(200 + P)
    img = rng.normal(size=(P, N, N)).astype(np.float32)
    k1d = (0.5 + rng.uniform(0.2, 1.0, size=N)).astype(np.float32)
    return img, k1d


def transposed(img):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(img, 1, 2)))


@pytest.fixture(scope="module")
def jax_grids():
    """JAX ``image_to_grid_fused_parts`` (Pallas, interpret mode) per
    polarization count."""
    memo = {}

    def get(P):
        if P not in memo:
            img, k1d = image_case(P)
            gr, gi = pallas_fft.image_to_grid_fused_parts(
                jnp.asarray(np.swapaxes(img, 1, 2)), jnp.asarray(k1d), W, PS,
                pixels=N)
            memo[P] = ((img, k1d), np.asarray(gr), np.asarray(gi))
        return memo[P]

    return get


def assert_grid_close(got, ref_r, ref_i):
    peak = max(np.abs(ref_r).max(), np.abs(ref_i).max())
    np.testing.assert_allclose(got[0].numpy(), ref_r, atol=1e-5 * peak)
    np.testing.assert_allclose(got[1].numpy(), ref_i, atol=1e-5 * peak)


@pytest.mark.parametrize("P", [1, 2])
def test_k6_k7_plain_match_jax(jax_grids, P):
    """K6 then K7 (plain versions) on the transposed image, element for
    element against the JAX fused pair: the orientation is the JAX one."""
    (img, k1d), gr, gi = jax_grids(P)
    got = fused_fft.image_to_grid_fused_parts(
        transposed(img), torch.from_numpy(k1d), W, PS)
    assert_grid_close(got, gr, gi)


@pytest.mark.parametrize("P", [1, 2])
def test_image_to_grid_parts_matches_jax(jax_grids, P):
    """The routing entry (CPU: the plain formula) against the JAX routing
    entry on its fused Pallas path."""
    (img, k1d), gr, gi = jax_grids(P)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KTPU_FFT", "pallas")
        assert jax_fourier._use_pallas_fft(N, np.float32)
        jr, ji = jax_fourier.image_to_grid_parts_impl(
            jnp.asarray(img), jnp.asarray(k1d), W, PS, pixels=N)
    np.testing.assert_array_equal(np.asarray(jr), gr)
    np.testing.assert_array_equal(np.asarray(ji), gi)
    got = fourier.image_to_grid_parts(torch.from_numpy(img),
                                      torch.from_numpy(k1d), W, PS)
    assert_grid_close(got, gr, gi)


def test_plain_k7_is_cb_times_col_fft():
    """The plain K7 is the JAX column DFT (sign -1) times the
    checkerboard, untransposed."""
    img, _ = image_case(1)
    xr, xi = img, img[:, ::-1].copy()
    yr, yi = pallas_fft.col_fft(jnp.asarray(xr), jnp.asarray(xi), -1)
    cb = np.where((np.arange(N)[:, None] + np.arange(N)[None, :]) % 2,
                  -1.0, 1.0).astype(np.float32)
    tr, ti = fused_fft.cbout_col_fft_plain(torch.from_numpy(xr),
                                           torch.from_numpy(xi))
    assert_grid_close((tr, ti), np.asarray(yr) * cb, np.asarray(yi) * cb)


def test_image_to_grid_inverts_grid_to_image():
    """image -> grid -> image is ``img * N^2 / taper^4``: the transforms
    are unnormalised, ``n`` cancels, and both directions divide by the
    taper (the kernel's transform is convolved in on both paths)."""
    img, k1d = image_case(1)
    g = fourier.image_to_grid(torch.from_numpy(img).double(),
                              torch.from_numpy(k1d).double(), W, PS)
    back = fourier.grid_to_image(g, torch.zeros((1, N, N),
                                                dtype=torch.float64),
                                 torch.from_numpy(k1d).double(), W, PS)
    t2 = np.outer(k1d.astype(np.float64), k1d.astype(np.float64))
    np.testing.assert_allclose(back.numpy() / N ** 2 * t2 * t2, img,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# K5


def degrid_case(seed, P, n=600):
    """uv drawn across the whole grid (every kernel footprint inside it,
    the scatter oracle's domain), so tile-edge shifts all occur."""
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=(WP, O, K))
              + 1j * rng.normal(size=(WP, O, K))).astype(np.complex64)
    uv_bias = (K - 1) // 2 - N // 2
    uv = (rng.integers(0, N - K + 1, size=(n, 2)) + uv_bias).astype(np.int16)
    sub = rng.integers(0, O, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, WP, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, P))
           + 1j * rng.normal(size=(n, P))).astype(np.complex64)
    wt = rng.uniform(0.5, 2.0, size=(n, P)).astype(np.float32)
    grid = (rng.normal(size=(P, N, N))
            + 1j * rng.normal(size=(P, N, N))).astype(np.complex64)
    plan = mxu_gridder.plan_chunks_tiled(uv, sub, wp, vis, wt, pixels=N,
                                         kernel_width=K, ts=TS, mc=MC)
    return dict(kernel=kernel, uv=uv, sub=sub, wp=wp, vis=vis, wt=wt,
                grid=grid, plan=plan,
                nc=int(plan.valid.any(axis=1).sum()))


def plan_arrays(plan):
    return (plan.uv, plan.sub_uv, plan.w_plane, plan.weights, plan.vis,
            plan.anchor, plan.valid)


def port_degrid(case, n_chunks="count", **kw):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in plan_arrays(case["plan"])]
    g = case["grid"]
    grid = (torch.from_numpy(np.ascontiguousarray(g.real)),
            torch.from_numpy(np.ascontiguousarray(g.imag)))
    nc = case["nc"] if n_chunks == "count" else n_chunks
    return mxu_gridder.degrid_chunks_parts(
        grid, torch.from_numpy(case["kernel"]), *t, nc, pixels=N, rv=TS,
        ru=TS, **kw)


@pytest.fixture(scope="module")
def jax_degrid():
    """JAX ``degrid_chunks_impl(assembly="pallas", tile_aligned=True)``
    (interpret mode) per polarization count."""
    memo = {}

    def get(P):
        if P not in memo:
            case = degrid_case(300 + P, P)
            g = case["grid"]
            out = jax_mxu.degrid_chunks_impl(
                (jnp.asarray(g.real), jnp.asarray(g.imag)),
                jnp.asarray(case["kernel"]),
                *(jnp.asarray(a) for a in plan_arrays(case["plan"])),
                jnp.asarray(case["nc"], jnp.int32), pixels=N, rv=TS, ru=TS,
                assembly="pallas", tile_aligned=True)
            memo[P] = (case, np.asarray(out))
        return memo[P]

    return get


@pytest.mark.parametrize("P", [1, 2])
def test_degrid_matches_jax_fused(jax_degrid, P):
    case, ref = jax_degrid(P)
    got = port_degrid(case).numpy()
    scale = np.abs(case["plan"].vis - ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)


@pytest.mark.parametrize("P", [1, 2])
def test_degrid_matches_scatter_oracle(jax_degrid, P):
    case, _ = jax_degrid(P)
    plan = case["plan"]
    got = port_degrid(case).numpy()[plan.row_chunk, plan.row_slot]
    oracle = gridder.degrid_vis_reference(
        case["grid"], case["kernel"], case["uv"], case["sub"], case["wp"],
        case["wt"], case["vis"])
    scale = np.abs(case["vis"] - oracle).max()
    np.testing.assert_allclose(got, oracle, atol=1e-5 * scale)


def test_plain_k5_matches_jax_kernel_output(jax_degrid):
    """The plain K5 alone, masked and weighted as the caller does, is the
    JAX prediction; chunks past ``n`` predict exactly zero."""
    case, ref = jax_degrid(1)
    plan = case["plan"]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (plan.uv, plan.sub_uv, plan.w_plane, plan.anchor)]
    g = case["grid"]
    pred = fused_degrid.degrid_chunks_fused(
        torch.from_numpy(np.ascontiguousarray(g.real)),
        torch.from_numpy(np.ascontiguousarray(g.imag)),
        torch.from_numpy(case["kernel"]), *t, case["nc"], pixels=N, ts=TS)
    assert not pred[case["nc"]:].any()
    got = plan.vis - plan.weights * (pred.numpy() * plan.valid[..., None])
    scale = np.abs(plan.vis - ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)


def test_padding_chunks_pass_through():
    """``n_chunks = 0`` predicts nothing: every visibility comes back
    unchanged; counting the chunks on the device gives the host count's
    result."""
    case = degrid_case(11, 1, n=300)
    vis = torch.from_numpy(case["plan"].vis)
    assert torch.equal(port_degrid(case, n_chunks=0), vis)
    assert torch.equal(port_degrid(case, n_chunks=None), port_degrid(case))


def test_shifts_and_anchors_in_range():
    """Shifts clamp to [0, 2ts - K] and anchors to [0, ext - 2ts]."""
    case = degrid_case(12, 1, n=500)
    plan = case["plan"]
    av, au, iu, iv, su, sv = fused_degrid.degrid_taps(
        torch.from_numpy(case["kernel"]),
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (plan.uv, plan.sub_uv, plan.w_plane, plan.anchor)),
        pixels=N, ts=TS)
    ext = mxu_gridder.dense_pad_size(N, TS)
    for s in (su, sv):
        assert int(s.min()) >= 0 and int(s.max()) <= 2 * TS - K
    for a in (av, au):
        assert int(a.min()) >= 0 and int(a.max()) <= ext - 2 * TS
    assert int(iu.max()) < WP * O and int(iv.max()) < WP * O


@pytest.mark.parametrize("rv,ru,width", [(32, 16, 16), (32, 32, 40)])
def test_unported_layouts_raise(rv, ru, width):
    """Where the JAX package falls back to an XLA assembly, the port
    raises."""
    case = degrid_case(13, 1, n=50)
    case["kernel"] = np.zeros((WP, O, width), np.complex64)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in plan_arrays(case["plan"])]
    g = torch.zeros((1, N, N))
    with pytest.raises(NotImplementedError):
        mxu_gridder.degrid_chunks_parts(
            (g, g), torch.from_numpy(case["kernel"]), *t, pixels=N, rv=rv,
            ru=ru)
