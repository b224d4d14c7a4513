"""The weights layer's grid (``parallel/multichannel.weight_grid``) on the
CPU: its plain version against numpy's ``add.at`` over the valid slots,
and the tile-aligned planner's invariants that the CUDA kernel
(``csrc/weights.cu``) relies on.  The kernel itself is held to the plain
version on the card (``tests/test_torch_gpu.py -k weight_grid``).

Tolerance: 1e-6 of each cell against a float64 sum (a cell holds a few
float32 weights of U(0.5, 2), added in an order ``index_put_`` does not
promise).  On the card the kernel is held bitwise to numpy's float32
``add.at`` over the valid slots in slot order (:func:`add_at`), the
serial fold it computes."""

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch import device
from katsdpimager_tpu_torch.parallel import multichannel

torch.set_num_threads(2)


def example_channel(pixels, num_pols, seed=3):
    """Channel 0 of the step's small batch (2 W slices of 256 chunks of
    128 at ts 32, NC 64 at 256 px): its config and (uv, valid, weights,
    anchor)."""
    cfg = multichannel.MultiChannelConfig(
        pixels=pixels, num_pols=num_pols, kernel_width=16, oversample=8,
        w_planes=8, w_slices=2, chunks_per_slice=64 if pixels == 256 else 256,
        chunk_size=128, rv=32, ru=32, weight_type="uniform")
    batch = multichannel.make_example_batch(cfg, 1, seed=seed, device="cpu")
    return cfg, (batch.uv[0], batch.valid[0], batch.weights[0],
                 batch.anchor[0])


def add_at(pixels, uv, valid, weights, dtype):
    """numpy's ``add.at`` of the valid slots' weights into their cells,
    in slot order, in ``dtype``; cells outside the grid dropped."""
    uv, valid, weights = (np.asarray(x) for x in (uv, valid, weights))
    P = weights.shape[-1]
    keep = valid.reshape(-1)
    cell = uv.reshape(-1, 2)[keep].astype(np.int64) + pixels // 2
    w = weights.reshape(-1, P)[keep].astype(dtype)
    inside = ((cell >= 0) & (cell < pixels)).all(axis=1)
    rows, cols, w = cell[inside, 1], cell[inside, 0], w[inside]
    grid = np.zeros((P, pixels, pixels), dtype)
    for p in range(P):
        np.add.at(grid[p], (rows, cols), w[:, p])
    return grid


def grid_of(cfg, uv, valid, weights, anchor, **kwargs):
    return multichannel.weight_grid(
        cfg.num_pols, cfg.pixels, uv, valid, weights, anchor=anchor,
        ts=cfg.rv, kernel_width=cfg.kernel_width, **kwargs)


@pytest.mark.parametrize("pixels", [256, 512])
@pytest.mark.parametrize("num_pols", [1, 4])
def test_plain_matches_add_at(pixels, num_pols):
    cfg, (uv, valid, weights, anchor) = example_channel(pixels, num_pols)
    got = grid_of(cfg, uv, valid, weights, anchor).numpy()
    ref = add_at(pixels, uv, valid, weights, np.float64)
    assert int(valid.sum()) > 0 and ref.max() > 0
    assert np.all(np.abs(got - ref) <= 1e-6 * np.abs(ref))


def test_padding_slots_never_count():
    cfg, (uv, valid, weights, anchor) = example_channel(512, 2)
    want = grid_of(cfg, uv, valid, weights, anchor)
    rng = np.random.default_rng(7)
    pad = ~valid
    assert int(pad.sum()) > 0
    uv2, w2 = uv.clone(), weights.clone()
    # Padding slots on cells inside the grid and far outside it, with
    # weights that would show.
    uv2[pad] = torch.from_numpy(rng.integers(
        -400, 400, size=(int(pad.sum()), 2), dtype=np.int32))
    w2[pad] = torch.from_numpy(rng.uniform(
        1.0, 3.0, size=(int(pad.sum()), 2)).astype(np.float32))
    got = grid_of(cfg, uv2, valid, w2, anchor)
    assert torch.equal(got, want)


def test_cells_past_the_edge_are_dropped():
    """Visibilities whose cells lie past the grid's high edge, inside the
    last tiles' windows (the planner takes them), count nowhere."""
    pixels, K, ts, mc = 256, 16, 32, 64
    cfg = multichannel.MultiChannelConfig(
        pixels=pixels, num_pols=1, kernel_width=K, oversample=8, w_planes=4,
        w_slices=1, chunks_per_slice=128, chunk_size=mc, rv=ts, ru=ts)
    rng = np.random.default_rng(11)
    uv = rng.integers(-100, 100, size=(600, 2))
    uv[:40, 1] = rng.integers(pixels // 2, pixels // 2 + ts // 2, size=40)
    uv[40:80, 0] = rng.integers(pixels // 2, pixels // 2 + ts // 2, size=40)
    planned, nc = multichannel.chunk_channel(
        cfg, uv.astype(np.int16), np.zeros_like(uv, np.int16),
        np.zeros(600, np.int16), np.ones((600, 1), np.complex64),
        rng.uniform(0.5, 2.0, size=(600, 1)).astype(np.float32))
    puv, anchor, valid, w = (planned[i] for i in (0, 3, 4, 5))
    past = ((puv + pixels // 2) >= pixels).any(-1) & valid
    assert int(past.sum()) == 80
    got = grid_of(cfg, *(torch.from_numpy(x)[None]
                         for x in (puv, valid, w, anchor))).numpy()
    ref = add_at(pixels, puv, valid, w, np.float64)
    assert np.all(np.abs(got - ref) <= 1e-6 * np.abs(ref))
    inside = w[valid & ~past].astype(np.float64).sum()
    assert abs(got.sum(dtype=np.float64) - inside) <= 1e-6 * inside


def planner_key(anchor, ts, pixels):
    """The tile key the planner sorts by: tv * ntu + tu."""
    ntu = -(-pixels // ts) + 1
    return (anchor[..., 0] // ts) * ntu + anchor[..., 1] // ts


@pytest.mark.parametrize("ts,K", [(16, 12), (32, 16), (64, 60), (128, 96)])
@pytest.mark.parametrize("pixels,seed", [(256, 1), (1024, 2)])
def test_planner_invariants_the_kernel_relies_on(ts, K, pixels, seed):
    """Of each slice's chunks: the valid slots a prefix of each chunk; the
    occupied chunks first, sorted by tile; every valid cell inside its
    chunk's window ``anchor + (K - 1) // 2``, ts x ts."""
    cfg = multichannel.MultiChannelConfig(
        pixels=pixels, num_pols=1, kernel_width=K, oversample=8, w_planes=4,
        w_slices=2, chunks_per_slice=4096, chunk_size=128, rv=ts, ru=ts)
    rng = np.random.default_rng(seed)
    lim = pixels // 2 - K - 1
    kb = (K - 1) // 2
    for _ in range(cfg.w_slices):
        n = 4000
        uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                     ).astype(np.int16)
        planned, nc = multichannel.chunk_channel(
            cfg, uv, np.zeros_like(uv), np.zeros(n, np.int16),
            np.ones((n, 1), np.complex64), np.ones((n, 1), np.float32))
        puv, anchor, valid = planned[0], planned[3], planned[4]
        count = valid.sum(-1)
        assert count.sum() == n
        np.testing.assert_array_equal(
            valid, np.arange(valid.shape[1]) < count[:, None])
        assert (count[:nc] > 0).all() and (count[nc:] == 0).all()
        assert (anchor % ts == 0).all()
        assert (np.diff(planner_key(anchor[:nc], ts, pixels)) >= 0).all()
        cell = puv[..., ::-1] + pixels // 2              # (row, col)
        shift = cell - (anchor[:, None, :] + kb)
        assert ((shift >= 0) & (shift < ts))[valid].all()


def test_density_plain_equals_density():
    cfg, (uv, valid, weights, anchor) = example_channel(256, 1)
    want = multichannel._density(cfg, uv, anchor, valid, weights)
    with device.plain_versions():
        got = multichannel._density(cfg, uv, anchor, valid, weights)
    assert torch.equal(got, want)
    assert (want > 0).any()
