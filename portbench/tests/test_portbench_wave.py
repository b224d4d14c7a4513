"""The cube wave cell's comparison on the CPU at a small size: a run is
correct, every number's control reads over its limit, and each fault the
cell can have comes out not correct."""

import pytest
import torch

from katsdpimager_tpu_torch.parallel import cube
from portbench import run
from portbench.runners import cube_wave
from portbench.tests.small import SEED, WAVE_TRAFFIC, wave_cell

LIMITS = WAVE_TRAFFIC["limits"]


def run_small(trace=False):
    return run.run_cell(wave_cell(), seed=SEED, seconds=0.5, trace=trace,
                        device="cpu")


def test_a_run_is_correct_and_traced():
    out = run_small(trace=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    for name, check in out["checks"].items():
        assert 0 <= check["value"] < check["limit"], name
    metrics = out["metrics"]
    assert 0 < metrics["clean.clean_share"]["value"] <= 100
    assert metrics["clean.minor_cycles_per_s"]["value"] > 0
    assert set(out["checks"]) == set(LIMITS)


def test_every_numbers_control_reads_over_its_limit():
    """The reference at TF32 in the program's place, read by each
    number's comparison."""
    out = cube_wave.run(wave_cell(), seed=SEED, seconds=0.3, trace=False,
                        device="cpu", control=True)
    assert out["correct"]
    for name, reading in out["control"].items():
        assert reading > LIMITS[name], name
        assert out["checks"][name][0] < LIMITS[name] / 3, name


def fault(monkeypatch, name, make):
    original = getattr(cube, name)
    monkeypatch.setattr(cube, name, make(original))


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """Each slice's second half of chunks left out of every image, the
    rest counted twice."""
    def make(original):
        def grid(cfg, kernel, density, uv, sub, wp, anc, val, vis, *rest,
                 **kw):
            vis = vis.clone()
            vis[:, vis.shape[1] // 2:] = 0
            return original(cfg, kernel, density, uv, sub, wp, anc, val,
                            2 * vis, *rest, **kw)
        return grid

    fault(monkeypatch, "_grid_slices", make)
    out = run_small()
    assert not out["correct"]
    assert out["checks"]["dirty_err"]["value"] > LIMITS["dirty_err"]


def test_a_major_cycle_that_subtracts_nothing_is_not_correct(monkeypatch):
    """The degridding major cycle returns the visibilities unchanged."""
    fault(monkeypatch, "_degrid_slices",
          lambda original: lambda cfg, kernel, model, uv, sub, wp, anc, val,
          wt, vis, *rest, **kw: vis)
    out = run_small()
    assert not out["correct"]
    assert out["checks"]["regrid_err"]["value"] > LIMITS["regrid_err"]


@pytest.mark.parametrize("what", ["model", "unchanged"])
def test_an_altered_clean_stage_is_not_correct(monkeypatch, what):
    """A CLEAN stage's model altered where it is made (one component
    scaled by 1.001), or the stage returning its state unchanged."""
    def make(original):
        def stage(cfg, residual, model, patch):
            if what == "unchanged":
                return (residual, model, torch.zeros(()),
                        torch.zeros((), dtype=torch.int32))
            res, mod, noise, cycles = original(cfg, residual, model, patch)
            flat = mod.reshape(-1)
            k = int(torch.nonzero(flat)[0])
            flat[k] = flat[k] * 1.001
            return res, mod, noise, cycles
        return stage

    fault(monkeypatch, "_clean_stage", make)
    out = run_small()
    assert not out["correct"]
    assert out["checks"]["clean_err"]["value"] > LIMITS["clean_err"]
