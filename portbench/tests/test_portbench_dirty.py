"""The dirty cell's comparison on the CPU at a small size: the reference
agrees with the port, a run comes out correct, and the control and the
faults the cell can have come out not correct."""

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch.parallel import multichannel as mc
from portbench import manifest, run
from portbench.runners import dirty_step
from portbench.reference import imaging as reference
from portbench.tests.small import SEED, SMALL_CONFIG, SMALL_TRAFFIC, small_cell

N = SMALL_CONFIG["pixels"]


def reference_image(draws_c, freq, *, tf32, rows=None, cols=None,
                    weight_type="natural"):
    rows = np.arange(N) if rows is None else rows
    cols = np.arange(N) if cols is None else cols
    ch = reference.Channel.of(reference.C_M_PER_S / freq, SMALL_CONFIG, "cpu")
    return ch.image(reference.weighted(draws_c, pixels=N,
                                       weight_type=weight_type),
                    rows, cols, tf32=tf32)


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_reference_is_the_ports_float32_step(weight_type):
    conf = dict(SMALL_CONFIG, weight_type=weight_type)
    batch, draws, _ = dirty_step.program_batch(conf, SMALL_TRAFFIC, SEED,
                                               "cpu")
    step = mc.single_channel_step(dirty_step.step_config(conf))
    taper = reference.wkernel.taper(N, 7.0, 8)
    rows, cols = reference.sample_axes(SEED, taper, 48)
    for c, freq in enumerate(dirty_step.frequencies(SMALL_TRAFFIC)):
        got = step(*mc.channel_args(batch, c))[0][:, rows][:, :, cols]
        ref = reference_image(draws[c], freq, tf32=False, rows=rows,
                              cols=cols, weight_type=weight_type)
        assert float((got.double() - ref).abs().max()
                     / ref.abs().max()) < 2e-5


def test_uniform_density_is_one_over_the_cells_weight():
    uv = np.array([[0, 0], [0, 0], [1, 0]], np.int16)
    z = np.zeros((3, 2), np.int16)
    vis = np.ones((3, 1), np.complex64)
    wt = np.array([[1.0], [3.0], [2.0]], np.float32)
    out = reference.weighted([(uv, z, z[:, 0], vis, wt)], pixels=8,
                             weight_type="uniform")
    assert out[0][3][:, 0].tolist() == [0.25, 0.25, 0.5]


def test_sampled_pixels_lie_inside_the_field():
    taper = reference.wkernel.taper(N, 7.0, 8)
    rows, cols = reference.sample_axes(SEED, taper, 32)
    t2 = np.outer(taper[rows], taper[cols])
    assert t2.min() >= reference.FIELD_SHARE * taper.max() ** 2
    assert len(set(rows)) == 32 and len(set(cols)) == 32


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12 + 2 ** -20, -3.0e-7], dtype=torch.float32)
    got = reference.round_tf32(x)
    assert got.tolist()[:4] == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0]
    assert abs(got[4] / x[4] - 1) <= 2 ** -11


def run_small(**traffic):
    return run.run_cell(small_cell(**traffic), seed=SEED, seconds=0.5,
                        trace=False, device="cpu")


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_a_run_is_correct(weight_type):
    cell = small_cell()
    cell.config["weight_type"] = weight_type
    out = run.run_cell(cell, seed=SEED, seconds=0.5, trace=False,
                       device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    check = out["checks"]["dirty_err"]
    assert 0 < check["value"] < check["limit"]
    assert list(out)[-1] == "checks"


def patch_step(monkeypatch, make):
    """Replace the port's step by ``make(fn, channel)``'s function."""
    original = mc.single_channel_step
    calls = [0]

    def patched(cfg, plain=False):
        fn = original(cfg, plain)

        def step(*args):
            c = calls[0] % SMALL_TRAFFIC["channels"]
            calls[0] += 1
            return make(fn, c, calls[0], args)

        return step

    monkeypatch.setattr(mc, "single_channel_step", patched)


def test_the_control_is_not_correct(monkeypatch):
    """The reference at TF32, put in the program's place."""
    _, draws, _ = dirty_step.program_batch(SMALL_CONFIG, SMALL_TRAFFIC, SEED,
                                           "cpu")
    freqs = dirty_step.frequencies(SMALL_TRAFFIC)
    images = [reference_image(draws[c], f, tf32=True)
              for c, f in enumerate(freqs)]
    patch_step(monkeypatch, lambda fn, c, k, args: (images[c], images[c]))
    out = run_small()
    assert not out["correct"] and out["failed"] == out["attempted"]
    assert out["checks"]["dirty_err"]["value"] > 10 * SMALL_TRAFFIC[
        "limits"]["dirty_err"]


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """Half of each slice's chunks dropped, the rest counted twice."""
    def make(fn, c, k, args):
        args = list(args)
        vis = args[10].clone()
        vis[:, vis.shape[1] // 2:] = 0
        args[10] = 2 * vis
        return fn(*args)

    patch_step(monkeypatch, make)
    out = run_small()
    assert not out["correct"]


@pytest.mark.parametrize("scale", [1.001, 0.0])
def test_an_altered_image_is_not_correct(monkeypatch, scale):
    """One channel's image of one step of the window altered where it is
    made (scaled by 1.001, or left empty)."""
    first_window_call = SMALL_TRAFFIC["channels"] + 1

    def make(fn, c, k, args):
        residual, model = fn(*args)
        if k == first_window_call:
            residual = residual * scale
        return residual, model

    patch_step(monkeypatch, make)
    out = run_small()
    assert not out["correct"] and out["failed"] == 1


@pytest.mark.parametrize("trace", [False, True])
def test_the_uniform_cell_reports_its_own_metrics(trace):
    e2e, layer = manifest.metrics_of(manifest.load(),
                                     "mkat_l_4k_uniform.dirty")
    cell = manifest.Cell("small_uniform.dirty", 1,
                         dict(SMALL_CONFIG, weight_type="uniform"),
                         dict(SMALL_TRAFFIC, metric_prefix="dirty_uniform"),
                         e2e, layer, manifest.HERE)
    out = run.run_cell(cell, seed=SEED, seconds=0.5, trace=trace,
                       device="cpu")
    assert out["correct"]
    want = ({m["name"] for m in layer if m["source"] != "device_trace"}
            if trace else {m["name"] for m in e2e})
    assert set(out["metrics"]) == want
    if trace:
        assert out["metrics"]["uniform.weight_grid_ms"]["value"] > 0
