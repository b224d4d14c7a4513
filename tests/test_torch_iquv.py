"""Full-Stokes (IQUV) imaging of the dirty step, on the CPU at a small size
(256 px, K 16): the port's step at four polarisations against the
benchmark's plain float64 reference, the accumulator cap's groups of
polarisations against one group, the ``mkat_l_4k_iquv.dirty`` cell of
``BENCHMARK.json`` and its readers, and its runner's comparison."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch.ops import fused_gridder, mxu_gridder
from katsdpimager_tpu_torch.parallel import multichannel as mc
from portbench import manifest
from portbench.common.trace import Trace
from portbench.reference import imaging as reference
from portbench.runners import dirty_step
from portbench.tests.small import SEED, SMALL_CONFIG, SMALL_TRAFFIC, small_cell

N = SMALL_CONFIG["pixels"]
P = 4
CELL = "mkat_l_4k_iquv.dirty"

#: Stokes I, Q, U and V at the scales of a polarised sky: Q, U and V at
#: 10%, 3% and 1% of I, so that each plane has a peak of its own and a
#: plane dropped, swapped or weighted as another misses its own peak.
SCALES = (1.0, 0.1, 0.03, 0.01)


def iquv_config(weight_type="natural"):
    return dict(SMALL_CONFIG, num_pols=P, weight_type=weight_type)


def scaled(draws):
    """Every slice's visibilities with plane p scaled by ``SCALES[p]``."""
    s = np.asarray(SCALES, np.float32)
    return [[d._replace(vis=(d.vis * s).astype(np.complex64)) for d in row]
            for row in draws]


@pytest.fixture(scope="module", params=["natural", "uniform"])
def step_and_reference(request):
    """(weight type, [(port, reference)] per channel): the port's
    ``single_channel_step`` at four polarisations and the float64
    reference, each (P, L, L) at sampled pixels inside the field."""
    conf = iquv_config(request.param)
    _, draws, _ = dirty_step.program_batch(conf, SMALL_TRAFFIC, SEED, "cpu")
    batch, draws, _ = dirty_step.program_batch(conf, SMALL_TRAFFIC, SEED,
                                               "cpu", draws=scaled(draws))
    step = mc.single_channel_step(dirty_step.step_config(conf))
    rows, cols = reference.sample_axes(
        SEED, reference.wkernel.taper(N, 7.0, 8), 48)
    out = []
    for c, freq in enumerate(dirty_step.frequencies(SMALL_TRAFFIC)):
        got = step(*mc.channel_args(batch, c))[0][:, rows][:, :, cols]
        ch = reference.Channel.of(reference.C_M_PER_S / freq, conf, "cpu")
        ref = ch.image(reference.weighted(draws[c], pixels=N,
                                          weight_type=request.param),
                       rows, cols)
        out.append((got, ref))
    return request.param, out


@pytest.mark.parametrize("pol", range(P))
def test_each_stokes_plane_holds_its_own_peak(step_and_reference, pol):
    """Plane ``pol`` of every channel within 2e-5 of its own peak from the
    float64 reference (the small cell's limit), and the reference's
    planes at the scales the draws were given."""
    _, channels = step_and_reference
    for got, ref in channels:
        assert got.shape == (P,) + ref.shape[1:]
        peak = ref[pol].abs().max()
        ratio = float(peak / ref[0].abs().max())
        assert SCALES[pol] / 3 < ratio < 3 * SCALES[pol]
        err = float((got[pol].double() - ref[pol]).abs().max() / peak)
        assert err < 2e-5, err


def slice_inputs():
    """Channel 0, slice 0 of the small batch at four polarisations, and a
    (P, N, N) weight grid of its own."""
    conf = iquv_config()
    batch, _, _ = dirty_step.program_batch(conf, SMALL_TRAFFIC, SEED, "cpu")
    args = [batch.kernel[0]] + [x[0, 0] for x in (
        batch.uv, batch.sub_uv, batch.w_plane, batch.vis, batch.anchor,
        batch.valid)]
    density = torch.from_numpy(np.random.default_rng(SEED).uniform(
        0.5, 2.0, size=(P, N, N)).astype(np.float32))
    return args, density, int(batch.n_chunks[0, 0])


def per_pol_gb(ts):
    ext2 = mxu_gridder.colour_tiles(N, ts) * 2 * ts
    return 4 * ext2 * ext2 * 4 * 2 / 1e9


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("route", ["parts", "onto"])
def test_pol_groups_grid_as_one_group(size, route, monkeypatch):
    """With the accumulator cap forced down to ``size`` polarisations,
    the groups of :func:`mxu_gridder.pol_groups` grid the same planes,
    bitwise, as one group of all four: into fresh planes (``out=None``,
    route ``parts``) and onto given ones (``out=planes``, ``onto``)."""
    ts = SMALL_CONFIG["tile_size"]
    cap = per_pol_gb(ts) * (size + 0.5)
    groups = [(p, min(p + size, P)) for p in range(0, P, size)]
    assert mxu_gridder.pol_groups(P, N, ts) == [(0, P)]
    (kernel, uv, sub, wp, vis, anc, val), density, n = slice_inputs()

    def grid():
        out = None
        if route == "onto":
            out = tuple(torch.zeros((P, N, N)) for _ in range(2))
        return fused_gridder.grid_slice(
            kernel, density, uv, sub, wp, vis, anc, val, n, pixels=N,
            ts=ts, out=out)

    whole = grid()
    monkeypatch.setattr(mxu_gridder, "MAX_ACC_GB", cap)
    assert mxu_gridder.pol_groups(P, N, ts) == groups
    split = grid()
    for a, b in zip(split, whole):
        assert a.shape == (P, N, N)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert whole[0].abs().amax(dim=(1, 2)).min() > 0


def reader(name):
    path = os.path.join(manifest.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


READERS = ("iquv.k1_roofline", "iquv.k1_ms_per_pol", "iquv.idle_share")


def test_the_cell_loads_with_its_metrics():
    cell = manifest.cell(CELL)
    assert cell.chips == 1
    assert cell.config["num_pols"] == P
    assert cell.config["weight_type"] == "natural"
    assert cell.config["reduced"] == []
    assert cell.traffic["runner"] == "dirty_step"
    assert cell.traffic["metric_prefix"] == "dirty"
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "dirty_mvis_per_s", "dirty_step_p95_ms"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert all(m["moves"] == "dirty_mvis_per_s" for m in cell.per_layer)
    # Everything but the polarisations and the config's own words is
    # the production batch's.
    base = manifest.cell("mkat_l_4k.dirty")
    words = {"name", "source", "assumed", "num_pols"}
    assert {k: v for k, v in cell.config.items() if k not in words} == {
        k: v for k, v in base.config.items() if k not in words}
    assert {k: v for k, v in cell.traffic.items()
            if k not in ("config", "why", "trace_steps")} == {
        k: v for k, v in base.traffic.items()
        if k not in ("config", "why", "trace_steps")}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_on_an_empty_trace(name):
    assert reader(name)(Trace([], {}, [], 1.0)) is None


WORK = {"chunks": 4905, "valid": 524288, "runs": 3848, "pols": P, "ts": 64,
        "kernel_width": 60, "table_rows": 256}


def k1_trace(k1_us):
    """Two traced steps whose K1 kernels take ``k1_us`` in all, beside a
    K4 of 500 us, over a stretch of 10 ms."""
    events = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": k1_us,
               "name": "void grid_planes_kernel<128>(Args)"},
              {"ph": "X", "cat": "kernel", "ts": k1_us, "dur": 500,
               "name": "epi_col_fft_kernel"}]
    return Trace([], {"trace.steps": 2, "k1.work": [WORK] * 2,
                      "k1.launches": 2}, events, window_s=0.010)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_a_full_stokes_trace(name):
    trace = k1_trace(8000)
    got = reader(name)(trace)
    want = {"iquv.k1_ms_per_pol": 8.0 / 2 / P,
            "iquv.idle_share": 100 * (1 - 8500e-6 / 0.010),
            "iquv.k1_roofline": reader("dirty.k1_roofline")(trace)}[name]
    assert got == pytest.approx(want)
    if name == "iquv.k1_roofline":
        # Four planes a visibility: four times Stokes I's floor.
        one = dict(WORK, pols=1)
        single = Trace([], dict(trace.counters, **{"k1.work": [one] * 2}),
                       trace.events, 0.010)
        assert 3 < got / reader(name)(single) <= 4


def run_small(monkeypatch=None, swap=None):
    """The runner at the small size with four polarisations, the step's
    images with planes ``swap`` exchanged where they are made."""
    cell = small_cell()
    cell.config["num_pols"] = P
    if swap is not None:
        original = mc.single_channel_step
        order = list(range(P))
        order[swap[0]], order[swap[1]] = swap[1], swap[0]

        def patched(cfg):
            fn = original(cfg)

            def step(*args):
                image, model = fn(*args)
                return image[order], model
            return step

        monkeypatch.setattr(mc, "single_channel_step", patched)
    return dirty_step.run(cell, seed=SEED, seconds=0.3, trace=False,
                          device="cpu")


def test_a_full_stokes_run_is_correct():
    out = run_small()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    value, limit = out["checks"]["dirty_err"]
    assert 0 < value < limit


def test_two_planes_swapped_are_not_correct(monkeypatch):
    out = run_small(monkeypatch, swap=(1, 2))
    assert not out["correct"] and out["failed"] == out["attempted"]
