"""The port's per-channel ``Imaging`` against the JAX package's, at
256 px with K = 16 on a simulated observation, every W slice gridded in
two blocks onto the running grid: the dirty image (grid, K1 + K2 onto
the running grid, K3 + K4), the degrid path (K6 + K7, K5), the direct
prediction and CLEAN.  The JAX class runs its CPU assemblies (scan
gridder, XLA FFT).  Tolerances: images within 1e-4 of the peak inside
the anti-aliased field (taper^2 >= 0.2% of its peak), where the two f32
paths' rounding is not amplified by 1/taper^2; visibilities within 1e-5
of the largest prediction; CLEAN exact on identical inputs."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu import imaging as jax_imaging
from katsdpimager_tpu import parameters, polarization, simulate
from katsdpimager_tpu.ops import pallas_gridder
from katsdpimager_tpu.ops import weights as jax_weights
from katsdpimager_tpu_torch import convert, imaging, preprocess
from katsdpimager_tpu_torch.ops import clean, fused_gridder, mxu_gridder
from katsdpimager_tpu_torch.ops import weights

torch.set_num_threads(2)
N, K = 256, 16


def _params(weight_type="UNIFORM"):
    fixed = parameters.FixedImageParameters((polarization.STOKES_I,),
                                            "single")
    ants = simulate.random_array(16, 800.0)
    uvw, vis = simulate.simulate_vis(
        ants, math.radians(-30.7), simulate.DEFAULT_PHASE_CENTRE, [1.0e9],
        simulate.DEFAULT_SOURCES, np.linspace(-0.5, 0.5, 24))
    longest = float(np.linalg.norm(uvw, axis=1).max() * 1.01)
    ap = parameters.ArrayParameters(13.5, longest)
    ip = parameters.make_image_parameters(fixed, 1.0, 5, 1.0e9, ap, None, N)
    fgp = parameters.FixedGridParameters(7.0, 8, 4, longest, K)
    gp = parameters.GridParameters(fgp, 2, 64)
    clean_p = parameters.CleanParameters(100, 0.1, 0.85, 5.0,
                                         clean.CLEAN_I, 0.01, 0.5, 0.02)
    return ip, gp, clean_p, uvw, vis


@pytest.fixture(scope="module")
def setup():
    ip, gp, clean_p, uvw, vis = _params()
    col = preprocess.VisibilityCollectorMem([ip], [gp], engine="torch",
                                            device="cpu")
    mueller = polarization.polarization_matrix(
        [polarization.STOKES_I], [polarization.STOKES_XX,
                                  polarization.STOKES_XY,
                                  polarization.STOKES_YX,
                                  polarization.STOKES_YY])
    col.add(uvw, np.ones(vis.shape, np.float32), vis, None, None, mueller,
            None)
    reader = col.reader()
    blocks = {s: list(reader.iter_slice(0, s, reader.len(0, s) // 2 + 1))
              for s in range(gp.w_slices)}
    assert all(len(b) == 2 for b in blocks.values() if b)
    taper = imaging.Imaging(ip, gp, parameters.WeightParameters(
        weights.WeightType.NATURAL), clean_p, device="cpu").taper1d.numpy()
    t2 = np.outer(taper, taper)
    return ip, gp, clean_p, blocks, t2 >= 0.002 * t2.max()


def _pair(setup, kind="UNIFORM"):
    ip, gp, clean_p, _, _ = setup
    j = jax_imaging.Imaging(ip, gp, parameters.WeightParameters(
        jax_weights.WeightType[kind]), clean_p)
    t = imaging.Imaging(ip, gp, parameters.WeightParameters(
        weights.WeightType[kind]), clean_p, device="cpu")
    return j, t


def _dirty(im, blocks, field="vis"):
    im.clear_weights()
    for s, bs in blocks.items():
        for chunk in bs:
            im.grid_weights(chunk.uv, chunk.weights)
    im.finalize_weights()
    im.clear_dirty()
    for s, bs in blocks.items():
        if not bs:
            continue
        im.clear_grid()
        for b, chunk in enumerate(bs):
            im.grid_slice(chunk, chunk[field], s, b)
        im.grid_to_image(s)


@pytest.fixture(scope="module")
def dirty_pair(setup):
    j, t = _pair(setup)
    _dirty(j, setup[3])
    _dirty(t, setup[3])
    return j, t


def test_dirty_matches_jax(setup, dirty_pair):
    inside = setup[4]
    j, t = dirty_pair
    want, got = np.asarray(j.dirty), t.get_buffer("dirty")
    peak = np.abs(want).max()
    assert np.isfinite(got).all() and peak > 0
    assert np.abs(got - want)[:, inside].max() <= 1e-4 * peak
    np.testing.assert_allclose(t.get_buffer("weights_grid"),
                               np.asarray(j.weights.grid), rtol=1e-6)


def test_last_running_grid_matches_jax(dirty_pair):
    """The last slice's grid, two blocks added onto the running grid."""
    j, t = dirty_pair
    want, got = np.asarray(j.grid), t.get_buffer("grid")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _model(pixels):
    model = np.zeros((1, pixels, pixels), np.float32)
    for (y, x, f) in ((128, 128, 1.0), (100, 150, 0.5), (160, 90, -0.3)):
        model[0, y, x] = f
    return model


def test_degrid_matches_jax(setup):
    j, t = _pair(setup)
    j.model = jnp.asarray(_model(N))
    t.model = torch.from_numpy(_model(N))
    for s, bs in setup[3].items():
        if not bs:
            continue
        mg = j.model_to_grid(j.mid_w[s])
        tg = t.model_to_grid(t.mid_w[s])
        for b, chunk in enumerate(bs):
            want = np.asarray(j.degrid_slice(chunk, chunk.vis, mg, s, b))
            got = t.degrid_slice(chunk, chunk.vis, tg, s, b).numpy()
            largest = np.abs(chunk.vis - want).max()
            assert largest > 0.1
            np.testing.assert_allclose(got, want, atol=1e-5 * largest)


def test_predict_matches_jax(setup):
    j, t = _pair(setup)
    j.model = jnp.asarray(_model(N))
    t.model = torch.from_numpy(_model(N))
    j.model_to_predict()
    t.model_to_predict()
    for s, bs in setup[3].items():
        for chunk in bs:
            want = np.asarray(j.model_predict(chunk, chunk.vis, s))
            got = t.model_predict(chunk, chunk.vis, s).numpy()
            largest = np.abs(chunk.vis - want).max()
            np.testing.assert_allclose(got, want, atol=1e-5 * largest)


def test_clean_matches_jax_on_the_same_state(setup, dirty_pair):
    """JAX's PSF, dirty image and reset CLEAN state handed to the port
    (``convert.imaging_from_jax``): the minor cycles find the same
    components, and the residuals agree to f32 rounding."""
    ip, gp, clean_p, blocks, inside = setup
    j, _ = dirty_pair
    jp, tp = _pair(setup)
    _dirty(jp, blocks, "weights")
    scale = np.reciprocal(jp.psf_peak())
    jp.scale_dirty(scale)
    jp.dirty_to_psf()
    box = jp.psf_patch()
    jp.dirty = j.dirty
    jp.scale_dirty(scale)
    noise = jp.noise_est()
    jp.clean_reset()
    convert.imaging_from_jax(jp, tp)
    assert tp.noise_est() == pytest.approx(noise, rel=1e-6)
    assert tp.psf_patch() == box
    threshold = 5 * noise
    kj = jp.clean_cycles(threshold, 150)
    kt = tp.clean_cycles(threshold, 150)
    assert kt[0] == kj[0] > 10
    assert kt[1:] == pytest.approx(kj[1:], rel=1e-6)
    jp.clean_finish()
    tp.clean_finish()
    state = convert.imaging_to_numpy(tp)
    np.testing.assert_array_equal(state["model"] != 0,
                                  np.asarray(jp.model) != 0)
    np.testing.assert_allclose(state["model"], np.asarray(jp.model),
                               rtol=1e-6)
    peak = np.abs(np.asarray(j.dirty)).max() * scale[0]
    assert np.abs(state["dirty"] - np.asarray(jp.dirty)).max() <= 1e-6 * peak


def test_running_grid_matches_jax_fused():
    """K2's accumulating form (plain) against the JAX running-grid combine
    ``pallas_gridder.grid_chunks_fused`` (interpret mode) onto a non-zero
    grid."""
    rng = np.random.default_rng(4)
    pixels, ts, P, n = 256, 32, 1, 3000
    kern = (rng.normal(size=(4, 8, K))
            + 1j * rng.normal(size=(4, 8, K))).astype(np.complex64)
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, 4, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, P)) + 1j * rng.normal(size=(n, P))).astype(
        np.complex64)
    plan = mxu_gridder.plan_chunks_tiled(uv, sub, wp, vis,
                                         np.ones_like(vis, np.float32),
                                         pixels=pixels, kernel_width=K, ts=ts)
    base = (rng.normal(size=(P, pixels, pixels))
            + 1j * rng.normal(size=(P, pixels, pixels))).astype(np.complex64)
    ext = mxu_gridder.dense_pad_size(pixels, ts)
    gpad = np.zeros((P, ext, ext), np.complex64)
    gpad[:, :pixels, :pixels] = base
    fields = (plan.uv, plan.sub_uv, plan.w_plane, plan.vis, plan.anchor,
              plan.valid)
    nch = int(plan.valid.any(axis=1).sum())
    want = np.asarray(pallas_gridder.grid_chunks_fused(
        jnp.asarray(gpad), jnp.asarray(kern), None,
        *map(jnp.asarray, fields), None, jnp.int32(nch), pixels=pixels,
        ts=ts, interpret=True))[:, :pixels, :pixels]
    grid = (torch.from_numpy(base.real.copy()),
            torch.from_numpy(base.imag.copy()))
    fused_gridder.grid_slice(torch.from_numpy(kern), None,
                             *(torch.from_numpy(np.ascontiguousarray(f))
                               for f in fields),
                             n_chunks=nch, pixels=pixels, ts=ts, out=grid)
    got = torch.complex(*grid).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want - base).max()


def test_tile_size_and_accumulate_order():
    assert mxu_gridder.tile_size(4096, 60) == 64
    assert mxu_gridder.tile_size(256, 16) == 32
    assert mxu_gridder.tile_size(384, 16) == 48
    # the plain K2 adds onto the grid in the JAX order (((g+p00)+p01)+...)
    accr = torch.zeros((2, 2, 1, 128, 128))
    accr[0, 0] = 1e8
    accr[0, 1] = -1e8
    accr[1, 0] = 1.0
    occ = torch.ones((2, 2, 2, 2), dtype=torch.bool)
    g = (torch.full((1, 64, 64), 1.0), torch.zeros((1, 64, 64)))
    fused_gridder.combine_planes_plain(accr, accr.clone(), occ, pixels=64,
                                       ts=32, out=g)
    # (1 + 1e8) - 1e8 + 1 = 1 in f32: the base meets p00 first
    assert g[0][0, 40, 40].item() == 1.0
