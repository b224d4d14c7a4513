"""The port's scatter gridder (``ops/gridder.py``) and the ``Imaging``
methods on it (``grid_chunk``, ``degrid_chunk``) against the JAX
package's ``ops/gridder.py`` and its numpy oracles, on the same inputs.

Tolerances: the port's oracles equal the JAX oracles bitwise (the same
numpy loops); the scatter gridder is within 2e-6 of the grid's peak of
the JAX scatter and of the f64 oracle (f32 accumulation in another
order), the degridder within 2e-6 of the largest visibility; dirty
images through ``grid_chunk`` within 1e-4 of the JAX ``Imaging``'s peak
inside the anti-aliased field (taper^2 >= 0.2% of its peak), where the
grids' f32 rounding is not amplified by 1/taper^2.  No footprint leaves
the grid (the JAX scatter wraps negative indices, the port drops
them)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu import imaging as jax_imaging
from katsdpimager_tpu import parameters as jax_params
from katsdpimager_tpu import polarization as jax_pol
from katsdpimager_tpu.ops import clean as jax_clean
from katsdpimager_tpu.ops import gridder as jax_gridder
from katsdpimager_tpu.ops import weights as jax_weights
from katsdpimager_tpu.preprocess import VisChunk
from katsdpimager_tpu_torch import imaging, parameters, polarization
from katsdpimager_tpu_torch.ops import clean as clean_ops
from katsdpimager_tpu_torch.ops import gridder
from katsdpimager_tpu_torch.ops import weights as weight_ops

torch.set_num_threads(2)


def random_case(seed, pixels=128, K=8, oversample=4, w_planes=3, pols=2,
                n=300):
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=(w_planes, oversample, K))
              + 1j * rng.normal(size=(w_planes, oversample, K))
              ).astype(np.complex64)
    lim = pixels // 2 - K
    uv = rng.integers(-lim, lim, size=(n, 2)).astype(np.int16)
    sub_uv = rng.integers(0, oversample, size=(n, 2)).astype(np.int16)
    w_plane = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, pols))
           + 1j * rng.normal(size=(n, pols))).astype(np.complex64)
    wg = rng.uniform(0.5, 2.0, size=(pols, pixels, pixels)).astype(np.float32)
    weights = rng.uniform(0.1, 2.0, size=vis.shape).astype(np.float32)
    grid = (rng.normal(size=(pols, pixels, pixels))
            + 1j * rng.normal(size=(pols, pixels, pixels))
            ).astype(np.complex64)
    return dict(kernel=kernel, uv=uv, sub_uv=sub_uv, w_plane=w_plane,
                vis=vis, wg=wg, weights=weights, grid=grid)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,K,pols", [(42, 8, 2), (5, 7, 1), (9, 16, 4)])
def test_grid_vis_matches_jax_and_oracle(seed, K, pols):
    c = random_case(seed, K=K, pols=pols)
    pixels = c["wg"].shape[-1]
    zeros = np.zeros((pols, pixels, pixels), np.complex64)
    args = [c[k] for k in ("kernel", "wg", "uv", "sub_uv", "w_plane", "vis")]
    # grid_vis works in place: grid onto a copy of ``zeros``.
    got = gridder.grid_vis(t(zeros.copy()), *(t(a) for a in args),
                           pixels=pixels).numpy()
    want = np.asarray(jax_gridder.grid_vis(
        jnp.asarray(zeros), *(jnp.asarray(a) for a in args), pixels=pixels))
    oracle = gridder.grid_vis_reference(zeros.astype(np.complex128), *args)
    jax_oracle = jax_gridder.grid_vis_reference(
        zeros.astype(np.complex128), *args)
    np.testing.assert_array_equal(oracle, jax_oracle)
    peak = np.abs(oracle).max()
    assert np.abs(got - want).max() <= 2e-6 * peak
    assert np.abs(got - oracle).max() <= 2e-6 * peak


def test_grid_vis_accumulates_and_padding_is_noop():
    """Gridding onto a grid adds to it in place, and zero-vis padding
    entries (at uv 0) change nothing."""
    c = random_case(3, n=120, pols=1)
    pixels = c["wg"].shape[-1]
    args = [t(c[k]) for k in ("kernel", "wg", "uv", "sub_uv", "w_plane",
                              "vis")]
    base = torch.from_numpy(c["grid"][:1].copy())
    onto = base.clone()
    once = gridder.grid_vis(onto, *args, pixels=pixels)
    assert once is onto
    assert torch.equal(base, torch.from_numpy(c["grid"][:1]))
    pad = 9
    padded = [torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype)])
              for a in args[2:]]
    again = gridder.grid_vis(base.clone(), *args[:2], *padded, pixels=pixels)
    np.testing.assert_array_equal(again.numpy(), once.numpy())
    fresh = gridder.grid_vis(torch.zeros_like(base), *args, pixels=pixels)
    np.testing.assert_allclose((once - base).numpy(), fresh.numpy(),
                               atol=1e-5 * fresh.abs().max().item())


@pytest.mark.parametrize("seed,K,pols", [(7, 8, 2), (13, 16, 1)])
def test_degrid_vis_matches_jax_and_oracle(seed, K, pols):
    c = random_case(seed, K=K, pols=pols)
    pixels = c["wg"].shape[-1]
    args = [c[k] for k in ("grid", "kernel", "uv", "sub_uv", "w_plane",
                           "weights", "vis")]
    got = gridder.degrid_vis(*(t(a) for a in args), pixels=pixels).numpy()
    want = np.asarray(jax_gridder.degrid_vis(
        *(jnp.asarray(a) for a in args), pixels=pixels))
    oracle = gridder.degrid_vis_reference(*args)
    np.testing.assert_array_equal(
        oracle, jax_gridder.degrid_vis_reference(*args))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * scale
    assert np.abs(got - oracle).max() <= 2e-6 * scale
    # padding entries (zero weights) keep their visibilities
    c["weights"][::5] = 0.0
    out = gridder.degrid_vis(*(t(c[k]) for k in (
        "grid", "kernel", "uv", "sub_uv", "w_plane", "weights", "vis")),
        pixels=pixels).numpy()
    np.testing.assert_array_equal(out[::5], c["vis"][::5])


def _imagers(weight_type):
    """The JAX and the port ``Imaging`` of one channel (256 px, K = 12)."""
    made = []
    for params, pol, wops, cops, mod, kw in (
            (jax_params, jax_pol, jax_weights, jax_clean, jax_imaging, {}),
            (parameters, polarization, weight_ops, clean_ops, imaging,
             {"device": "cpu"})):
        fixed = params.FixedImageParameters((pol.STOKES_I,), "single")
        ip = params.ImageParameters(fixed, wavelength=0.21, pixel_size=1e-4,
                                    pixels=256)
        fgp = params.FixedGridParameters(
            antialias_width=7.0, oversample=8, image_oversample=4,
            max_w=500.0, kernel_width=12)
        gp = params.GridParameters(fgp, w_slices=2, w_planes=4)
        wp = params.WeightParameters(wops.WeightType[weight_type])
        cp = params.CleanParameters(100, 0.1, 0.85, 5.0, cops.CLEAN_I, 0.01,
                                    0.5, 0.02)
        made.append(mod.Imaging(ip, gp, wp, cp, **kw))
    return made


def _chunk(seed, n=2000, pixels=256, K=12, oversample=8, w_planes=4):
    rng = np.random.default_rng(seed)
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    return VisChunk(
        uv=uv,
        sub_uv=rng.integers(0, oversample, size=(n, 2)).astype(np.int16),
        w_plane=rng.integers(0, w_planes, size=n).astype(np.int16),
        weights=rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32),
        vis=(rng.normal(size=(n, 1))
             + 1j * rng.normal(size=(n, 1))).astype(np.complex64))


@pytest.mark.parametrize("weight_type", ["NATURAL", "UNIFORM"])
def test_imaging_grid_chunk_matches_jax(weight_type):
    """``grid_chunk`` then ``grid_to_image`` on both packages'
    ``Imaging``: the grids within 2e-6 of their peak, the dirty images
    within 1e-4 of the JAX peak inside the field."""
    jim, tim = _imagers(weight_type)
    chunk = _chunk(71)
    for im in (jim, tim):
        im.clear_weights()
        if weight_type != "NATURAL":
            im.grid_weights(chunk.uv, chunk.weights)
        im.finalize_weights()
        im.clear_dirty()
        im.clear_grid()
        im.grid_chunk(chunk, chunk.vis)
        im.grid_to_image(0)
    want = np.asarray(jim.dirty)
    got = tim.dirty.numpy()
    np.testing.assert_allclose(tim.get_buffer("grid"), np.asarray(jim.grid),
                               atol=2e-6 * np.abs(np.asarray(jim.grid)).max())
    taper = tim.taper1d.double().numpy()
    t2 = np.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    assert np.abs(got - want)[:, inside].max() <= 1e-4 * np.abs(want).max()


def test_imaging_degrid_chunk_matches_jax():
    """``degrid_chunk`` of a model grid on both packages' ``Imaging``:
    within 2e-6 of the largest visibility, and equal to the port's
    fused ``degrid_slice`` to the degridders' f32 rounding."""
    jim, tim = _imagers("NATURAL")
    chunk = _chunk(17, n=1500)
    rng = np.random.default_rng(2)
    model = np.zeros((1, 256, 256), np.float32)
    model[0, rng.integers(80, 176, 6), rng.integers(80, 176, 6)] = 1.0
    jim.model = jnp.asarray(model)
    tim.model = torch.from_numpy(model)
    w = float(tim.mid_w[0])
    jgrid = jim.model_to_grid(w)
    tgrid = tim.model_to_grid(w)
    want = jim.degrid_chunk(chunk, chunk.vis, jgrid)
    got = tim.degrid_chunk(chunk, chunk.vis, tgrid).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * scale
    fused = tim.degrid_slice(chunk, chunk.vis, tgrid, 0).numpy()
    assert np.abs(got - fused).max() <= 2e-6 * scale
