"""The frozen draws, packed by the port's planner, are the port's
``make_example_batch``."""

import numpy as np
import torch

from katsdpimager_tpu_torch.parallel import multichannel as mc
from portbench.runners import dirty_step
from portbench.gen import example_batch
from portbench.tests.small import SMALL_CONFIG, SMALL_TRAFFIC


def test_frozen_draws_give_the_ports_example_batch():
    seed = 2 ** 31 + 3
    got, draws, work = dirty_step.program_batch(SMALL_CONFIG, SMALL_TRAFFIC,
                                                seed, "cpu")
    cfg = dirty_step.step_config(SMALL_CONFIG)
    want = mc.make_example_batch(cfg, SMALL_TRAFFIC["channels"], seed=seed,
                                 vis_per_slice=SMALL_TRAFFIC["vis_per_slice"],
                                 device="cpu")
    for name in mc.ChannelBatch._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert sum(len(d.uv) for row in draws for d in row) == int(got.valid.sum())
    for c, row in enumerate(work):
        for s, w in enumerate(row):
            assert w["chunks"] == got.n_chunks[c, s]
            assert w["valid"] == int(got.valid[c, s].sum())


def test_thinning_halves_and_draws_again():
    calls = []

    def pack(c, s, d):
        calls.append((c, s, len(d.uv)))
        if len(d.uv) > 64:
            raise ValueError("too many")

    out = example_batch.draw_slices(
        5, channels=2, w_slices=2, pixels=256, kernel_width=16, oversample=8,
        w_planes=8, num_pols=1, vis_per_slice=256, pack=pack)
    assert calls == [(0, 0, 256), (0, 0, 128), (0, 0, 64), (0, 1, 64),
                     (1, 0, 64), (1, 1, 64)]
    assert [len(d.uv) for row in out for d in row] == [64] * 4
    d = out[0][0]
    assert d.uv.dtype == np.int16 and np.abs(d.uv).max() <= 256 // 2 - 17
    assert d.vis.dtype == np.complex64 and d.weights.min() >= 0.5
