"""The port's preprocessing (``preprocess.py``) against the JAX package's:
the torch engine against the JAX engine on one batch, with and without
per-visibility feed-angle rotation, and the collectors and readers.
Integer coordinates and slice counts must be identical; merged vis and
weights agree to 1e-6 relative (the merge's sums may run in another
order)."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from katsdpimager_tpu import parameters, polarization
from katsdpimager_tpu import preprocess as jax_pre
from katsdpimager_tpu_torch import preprocess

GEOMETRY = dict(pixels=256, cell_size=0.5, oversample=8, w_slices=3,
                w_planes=16, max_w=900.0, kernel_width=16)
LINEAR = [polarization.STOKES_XX, polarization.STOKES_XY,
          polarization.STOKES_YX, polarization.STOKES_YY]
STOKES = [polarization.STOKES_I, polarization.STOKES_Q, polarization.STOKES_U]


def _batch(seed, n=5000):
    rng = np.random.default_rng(seed)
    uvw = rng.normal(scale=60, size=(n, 3)).astype(np.float32)
    uvw[:300] = uvw[300:600]                  # duplicates merge
    w = rng.uniform(0.5, 2, size=(n, 4)).astype(np.float32)
    w[::97, 1] = 0                            # flagged
    vis = (rng.normal(size=(n, 4)) + 1j * rng.normal(size=(n, 4))).astype(
        np.complex64)
    vis[5, 2] = np.nan                        # squashed
    fa = rng.uniform(-np.pi, np.pi, size=(2, n)).astype(np.float32)
    return uvw, w, vis, fa


def _assert_records(got, want, count):
    for k in ("uv", "sub_uv", "w_plane", "w_slice"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k])[:count])
    np.testing.assert_array_equal(got["slice_counts"], want["slice_counts"])
    for k in ("weights", "vis"):
        w = np.asarray(want[k])[:count]
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("feed_angles", [False, True])
def test_torch_engine_matches_jax(feed_angles):
    uvw, w, vis, fa = _batch(1)
    if feed_angles:
        ms, mc = polarization.polarization_matrices(STOKES, LINEAR)
        mueller = preprocess.rotated_mueller_np(ms, mc, fa[0], fa[1])
    else:
        mueller = polarization.polarization_matrix(STOKES, LINEAR)
    mueller = mueller.astype(np.complex64)
    want = jax.device_get(jax_pre._preprocess_channel(
        jax_pre.ChannelGeometry(**GEOMETRY), 3, jnp.asarray(uvw),
        jnp.asarray(w), jnp.asarray(vis), jnp.asarray(mueller)))
    got = preprocess.preprocess_channel(
        preprocess.ChannelGeometry(**GEOMETRY),
        *map(torch.from_numpy, (uvw, w, vis, mueller)))
    count = int(want["count"])
    assert got["count"] == count and 0 < count < len(uvw) - 300
    _assert_records(got, want, count)


def _params(num_channels):
    fixed = parameters.FixedImageParameters(tuple(STOKES[:2]), "single")
    ap = parameters.ArrayParameters(13.5, 400.0)
    fgp = parameters.FixedGridParameters(7.0, 8, 4, 400.0, 16)
    ips = [parameters.make_image_parameters(fixed, 1.0, 5, f, ap, None, 256)
           for f in 1.0e9 * (1 + 0.05 * np.arange(num_channels))]
    return ips, [parameters.GridParameters(fgp, 3, 16)] * num_channels


def _collect(module, engine, cls="VisibilityCollectorMem", **kw):
    ips, gps = _params(2)
    col = getattr(module, cls)(ips, gps, 1 << 12, engine=engine, **kw)
    mueller = polarization.polarization_matrix(STOKES[:2], LINEAR)
    for seed in (2, 3):
        uvw, w, vis, _ = _batch(seed, 3000)
        uvw *= 0.2
        col.add(uvw, np.stack([w, w[::-1]]), np.stack([vis, vis[::-1]]),
                None, None, mueller, None)
    return col


def _slices(col):
    r = col.reader()
    return [[r.slice_arrays(c, s) for s in range(r.num_w_slices(c))]
            for c in range(col.num_channels)]


@pytest.mark.parametrize("engine", ["torch", "native",
                                    "VisibilityCollectorNative"])
def test_collector_matches_jax(engine):
    want = _collect(jax_pre, "jax")
    if engine == "VisibilityCollectorNative":
        # the class forces the native engine over the one passed
        got = _collect(preprocess, "torch", engine, device="cpu")
    else:
        got = _collect(preprocess, engine, device="cpu")
    assert (got.num_input, got.num_output) == (want.num_input,
                                                want.num_output)
    for gch, wch in zip(_slices(got), _slices(want)):
        for g, w in zip(gch, wch):
            assert len(g) == len(w)
            for k in ("uv", "sub_uv", "w_plane"):
                np.testing.assert_array_equal(g[k], w[k])
            for k in ("weights", "vis"):
                np.testing.assert_allclose(
                    g[k], w[k], rtol=0,
                    atol=1e-6 * np.abs(w[k]).max(initial=1e-30))


def test_native_collector_is_the_native_engine():
    """``VisibilityCollectorNative`` forces ``engine="native"`` over an
    engine passed and passes ``device`` through: its records bitwise
    those of ``VisibilityCollector(engine="native")``."""
    got = _collect(preprocess, "torch", "VisibilityCollectorNative",
                   device="cpu")
    same = _collect(preprocess, "native", "VisibilityCollector",
                    device="cpu")
    assert (got.engine, got.device) == ("native", torch.device("cpu"))
    assert (got.num_input, got.num_output) == (same.num_input,
                                                same.num_output)
    for gch, sch in zip(_slices(got), _slices(same)):
        for g, s in zip(gch, sch):
            for k in ("uv", "sub_uv", "w_plane", "weights", "vis"):
                np.testing.assert_array_equal(g[k], s[k], err_msg=k)


def test_hdf5_collector_streams_blocks(tmp_path):
    mem = _collect(preprocess, "torch", device="cpu")
    ips, gps = _params(2)
    col = preprocess.VisibilityCollectorHDF5(str(tmp_path / "spill.h5"),
                                             ips, gps, 1 << 12,
                                             device="cpu")
    mueller = polarization.polarization_matrix(STOKES[:2], LINEAR)
    for seed in (2, 3):
        uvw, w, vis, _ = _batch(seed, 3000)
        uvw *= 0.2
        col.add(uvw, np.stack([w, w[::-1]]), np.stack([vis, vis[::-1]]),
                None, None, mueller, None)
    col.close()
    r, rm = col.reader(), mem.reader()
    for c in range(2):
        for s in range(r.num_w_slices(c)):
            assert r.len(c, s) == rm.len(c, s)
            # blocks are views of one recycled buffer: copy each in turn
            blocks = [b.vis.copy() for b in r.iter_slice(c, s, 700)]
            whole = rm.slice_arrays(c, s)
            np.testing.assert_array_equal(
                np.concatenate(blocks) if blocks else whole.vis, whole.vis)
    r.close()


def test_hdf5_collector_needs_h5py(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    ips, gps = _params(1)
    with pytest.raises(RuntimeError, match="--no-tmp-file"):
        preprocess.VisibilityCollectorHDF5(str(tmp_path / "x.h5"), ips, gps)
