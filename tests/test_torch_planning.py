"""The port's host planning, device planning and batch synthesis against
the JAX package: the chunk layout and the example batch must be
bit-identical, so one batch feeds both packages."""

import dataclasses

import numpy as np
import pytest
import torch

from katsdpimager_tpu import native
from katsdpimager_tpu.ops import mxu_gridder as jax_mxu
from katsdpimager_tpu.parallel import multichannel as jax_mc
from katsdpimager_tpu_torch import convert
from katsdpimager_tpu_torch.ops import mxu_gridder
from katsdpimager_tpu_torch.parallel import multichannel

torch.set_num_threads(2)

SMALL = dict(pixels=256, num_pols=1, kernel_width=16, oversample=8,
             w_planes=8, w_slices=2, chunks_per_slice=64, chunk_size=128,
             rv=32, ru=32)


def _coords(seed, n, *, pixels=512, K=16, O=8, P=2, w_planes=4):
    rng = np.random.default_rng(seed)
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, O, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, P))
           + 1j * rng.normal(size=(n, P))).astype(np.complex64)
    wt = rng.uniform(0.5, 2.0, size=(n, P)).astype(np.float32)
    return uv, sub, wp, vis, wt


def _assert_plans_equal(a, b):
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
        assert getattr(a, name).dtype == getattr(b, name).dtype, name


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("ts,mc", [(64, 256), (32, 64)])
def test_plan_chunks_tiled_matches_jax(monkeypatch, path, ts, mc):
    if path == "native" and not native.available():
        pytest.skip("the native packer does not build here")
    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    args = _coords(3, 5000)
    kw = dict(pixels=512, kernel_width=16, ts=ts, mc=mc)
    _assert_plans_equal(mxu_gridder.plan_chunks_tiled(*args, **kw),
                        jax_mxu.plan_chunks_tiled(*args, **kw))


def test_native_and_numpy_plans_agree(monkeypatch):
    if not native.available():
        pytest.skip("the native packer does not build here")
    args = _coords(4, 3000, P=1)
    kw = dict(pixels=512, kernel_width=16, ts=64, mc=128)
    fast = mxu_gridder.plan_chunks_tiled(*args, **kw)
    monkeypatch.setattr(native, "available", lambda: False)
    _assert_plans_equal(fast, mxu_gridder.plan_chunks_tiled(*args, **kw))


def test_empty_plan_matches_jax():
    args = _coords(5, 0)
    kw = dict(pixels=512, kernel_width=16, ts=64, mc=128)
    _assert_plans_equal(mxu_gridder.plan_chunks_tiled(*args, **kw),
                        jax_mxu.plan_chunks_tiled(*args, **kw))


def test_plan_coords_and_count_match_jax():
    uv = _coords(6, 4000)[0]
    kw = dict(pixels=512, kernel_width=16, ts=64, mc=128)
    ours = mxu_gridder.plan_chunks_tiled_coords(uv, **kw)
    ref = jax_mxu.plan_chunks_tiled_coords(uv, **kw)
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    assert (mxu_gridder.plan_chunks_tiled_count(uv, **kw)
            == jax_mxu.plan_chunks_tiled_count(uv, **kw)
            == ref["n_chunks"])


@pytest.mark.parametrize("pixels,ts", [(256, 32), (512, 64), (4096, 64),
                                       (8192, 64)])
def test_dense_pad_size_matches_jax(pixels, ts):
    assert (mxu_gridder.dense_pad_size(pixels, ts)
            == jax_mxu.dense_pad_size(pixels, ts))


def test_pol_groups(monkeypatch):
    """One group under the cap; JAX's polarization-group split over it."""
    assert mxu_gridder.pol_groups(4, 4096, 64) == [(0, 4)]
    # 8k full Stokes: 2.28 GB per polarization against the 5 GB cap
    assert mxu_gridder.pol_groups(4, 8192, 64) == [(0, 2), (2, 4)]
    monkeypatch.setattr(mxu_gridder, "MAX_ACC_GB", 0.04)
    assert mxu_gridder.pol_groups(3, 512, 64) == [(0, 2), (2, 3)]
    monkeypatch.setattr(mxu_gridder, "MAX_ACC_GB", 1.0)
    with pytest.raises(ValueError):
        mxu_gridder.pol_groups(1, 8192, 64)


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_make_example_batch_bit_identical(weight_type):
    kw = dict(SMALL, weight_type=weight_type)
    ref = jax_mc.make_example_batch(jax_mc.MultiChannelConfig(**kw), 2,
                                    seed=7)
    ours = multichannel.make_example_batch(
        multichannel.MultiChannelConfig(**kw), 2, seed=7, device="cpu")
    for name in convert.JAX_FIELDS:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(
        ours.n_chunks.numpy(),
        np.asarray(ref.valid).any(axis=-1).sum(axis=-1))


def test_make_example_batch_thinning_matches_jax():
    """A layout too small for the requested visibilities thins the data
    the same way in both packages."""
    kw = dict(SMALL, chunks_per_slice=12)
    ref = jax_mc.make_example_batch(jax_mc.MultiChannelConfig(**kw), 1,
                                    seed=2, vis_per_slice=4000)
    ours = multichannel.make_example_batch(
        multichannel.MultiChannelConfig(**kw), 1, seed=2,
        vis_per_slice=4000, device="cpu")
    for name in convert.JAX_FIELDS:
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(ours.valid.sum()) < 4000


def test_config_matches_jax():
    """Same fields and defaults as the JAX MultiChannelConfig."""
    ours = {f.name: f.default for f in
            dataclasses.fields(multichannel.MultiChannelConfig)}
    ref = {f.name: f.default for f in
           dataclasses.fields(jax_mc.MultiChannelConfig)}
    assert ours == ref


def test_batch_round_trip():
    jb = jax_mc.make_example_batch(jax_mc.MultiChannelConfig(**SMALL), 2,
                                   seed=1)
    tb = convert.batch_from_jax(jb)
    assert tb.n_chunks.tolist() == np.asarray(jb.valid).any(-1).sum(
        -1).tolist()
    back = jax_mc.ChannelBatch(**convert.batch_to_numpy(tb))
    for name in convert.JAX_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


def _device_case(clustered, K=12, n=777):
    """The inputs of ``tests/test_mxu_gridder.py``'s
    ``test_device_plan_matches_host`` (its ``random_case``, seed 31),
    without the kernel and the weight grid."""
    rng = np.random.default_rng(31)
    pixels, oversample, w_planes, pols = 256, 4, 3, 2
    rng.normal(size=(w_planes, oversample, K))
    rng.normal(size=(w_planes, oversample, K))
    lim = pixels // 2 - K
    if clustered:
        uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                     ).astype(np.int16)
    else:
        uv = rng.integers(-lim, lim, size=(n, 2)).astype(np.int16)
    sub_uv = rng.integers(0, oversample, size=(n, 2)).astype(np.int16)
    w_plane = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, pols)) + 1j * rng.normal(size=(n, pols))
           ).astype(np.complex64)
    weights = rng.uniform(0.3, 2.0, size=(n, pols)).astype(np.float32)
    return pixels, (uv, sub_uv, w_plane, vis, weights)


def _jax_device_plan(args, **kw):
    import jax.numpy as jnp

    uv, sub_uv, w_plane, vis, weights = args
    return {k: np.asarray(v) for k, v in jax_mxu.plan_chunks_tiled_device(
        *(jnp.asarray(a.astype(np.int32)) for a in (uv, sub_uv, w_plane)),
        jnp.asarray(vis), jnp.asarray(weights), **kw).items()}


def _torch_device_plan(args, **kw):
    got = mxu_gridder.plan_chunks_tiled_device(*args, **kw, device="cpu")
    assert all(v.device.type == "cpu" for v in got.values())
    return {k: v.numpy() for k, v in got.items()}


def _assert_dicts_equal(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("clustered", [True, False])
@pytest.mark.parametrize("ts,mc", [(32, 64), (64, 256)])
def test_device_plan_matches_host_and_jax(clustered, ts, mc):
    """``plan_chunks_tiled_device`` on the CPU: every field bitwise equal
    to the port's host plan and to the JAX device planner's, in the
    clustered and the uniform case of ``tests/test_mxu_gridder.py``."""
    pixels, args = _device_case(clustered)
    kw = dict(pixels=pixels, kernel_width=12, ts=ts, mc=mc)
    host = mxu_gridder.plan_chunks_tiled(*args, **kw)
    nc = host.uv.shape[0]
    got = _torch_device_plan(args, **kw, nc=nc)
    for name in mxu_gridder.ChunkPlan._fields:
        np.testing.assert_array_equal(got[name], getattr(host, name),
                                      err_msg=name)
        assert got[name].dtype == getattr(host, name).dtype, name
    assert got["n_chunks"] == host.valid.any(axis=1).sum()
    assert got["n_chunks"].shape == () and got["n_chunks"].dtype == np.int32
    _assert_dicts_equal(got, _jax_device_plan(args, **kw, nc=nc))



@pytest.mark.parametrize("clustered", [True, False])
def test_device_plan_drops_chunks_past_nc(clustered):
    """With ``nc`` below the chunk count the chunks past it are dropped,
    as the JAX scatter's ``mode="drop"`` drops them: ``n_chunks`` is the
    true count, the kept chunks are the full plan's, ``row_chunk`` stays
    unclipped; bitwise equal to the JAX device planner."""
    pixels, args = _device_case(clustered)
    kw = dict(pixels=pixels, kernel_width=12, ts=32, mc=64)
    full = _torch_device_plan(args, **kw, nc=64)
    total = int(full["n_chunks"])
    nc = total // 2
    got = _torch_device_plan(args, **kw, nc=nc)
    assert int(got["n_chunks"]) == total > nc
    for name in ("uv", "sub_uv", "w_plane", "vis", "weights", "anchor",
                 "valid"):
        np.testing.assert_array_equal(got[name], full[name][:nc],
                                      err_msg=name)
    for name in ("row_chunk", "row_slot"):
        np.testing.assert_array_equal(got[name], full[name], err_msg=name)
    assert (got["row_chunk"] >= nc).any()
    _assert_dicts_equal(got, _jax_device_plan(args, **kw, nc=nc))


def test_device_plan_of_nothing():
    """No visibilities: ``n_chunks`` 0 and ``nc`` empty chunks, as the
    JAX device planner gives."""
    pixels, args = _device_case(True)
    args = tuple(a[:0] for a in args)
    kw = dict(pixels=pixels, kernel_width=12, ts=32, mc=64, nc=4)
    got = _torch_device_plan(args, **kw)
    assert int(got["n_chunks"]) == 0 and not got["valid"].any()
    assert got["uv"].shape == (4, 64, 2) and got["row_chunk"].shape == (0,)
    _assert_dicts_equal(got, _jax_device_plan(args, **kw))
