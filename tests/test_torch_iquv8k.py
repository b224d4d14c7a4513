"""Full-Stokes imaging at 8192 px (``mkat_l_8k_iquv.dirty``), on the CPU at
a small size (256 px, K 16) where the size does not matter: the step with
its polarisations split into two groups by the accumulator cap against
the benchmark's plain float64 reference, one group's colour planes alive
at a time, the ``k1.group`` and ``k1.prep_shared`` spans, the
configuration against katsdpimager's sizing rules, one slice of the
cell's own traffic packed at 8192 px, the cell in ``BENCHMARK.json`` and
its readers."""

import importlib.util
import os
import weakref

import pytest
import torch

from katsdpimager_tpu_torch import parameters, polarization, profiling
from katsdpimager_tpu_torch.ops import fused_fft, fused_gridder, mxu_gridder
from katsdpimager_tpu_torch.parallel import multichannel as mc
from portbench import manifest
from portbench.common.trace import Trace
from portbench.gen import example_batch
from portbench.reference import imaging as reference
from portbench.runners import dirty_step
from portbench.tests.small import SEED, SMALL_CONFIG, SMALL_TRAFFIC
from test_torch_iquv import SCALES, iquv_config, scaled

N = SMALL_CONFIG["pixels"]
TS = SMALL_CONFIG["tile_size"]
P = 4
CELL = "mkat_l_8k_iquv.dirty"
TWO_GROUPS = [(0, 2), (2, 4)]


def two_group_cap():
    """An accumulator cap, in GB, that holds two polarisations' colour
    planes at the small size and not three."""
    ext2 = mxu_gridder.colour_tiles(N, TS) * 2 * TS
    return 2.5 * (4 * ext2 * ext2 * 4 * 2 / 1e9)


@pytest.fixture(scope="module")
def two_group_step():
    """[(port, reference)] per channel: the step at four polarisations
    with the cap forced to two groups a slice, and the float64 reference,
    each (P, L, L) at sampled pixels inside the field."""
    conf = iquv_config()
    _, draws, _ = dirty_step.program_batch(conf, SMALL_TRAFFIC, SEED, "cpu")
    batch, draws, _ = dirty_step.program_batch(conf, SMALL_TRAFFIC, SEED,
                                               "cpu", draws=scaled(draws))
    step = mc.single_channel_step(dirty_step.step_config(conf))
    rows, cols = reference.sample_axes(
        SEED, reference.wkernel.taper(N, 7.0, 8), 48)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mxu_gridder, "MAX_ACC_GB", two_group_cap())
        assert mxu_gridder.pol_groups(P, N, TS) == TWO_GROUPS
        for c, freq in enumerate(dirty_step.frequencies(SMALL_TRAFFIC)):
            with profiling.installed(profiling.CollectProfiler()) as prof:
                got = step(*mc.channel_args(batch, c))[0][:, rows][:, :,
                                                                   cols]
            nonempty = int((batch.n_chunks[c] > 0).sum())
            assert [r.stack[-1] for r in prof.records].count(
                "k1.group") == 2 * nonempty
            ch = reference.Channel.of(reference.C_M_PER_S / freq, conf,
                                      "cpu")
            ref = ch.image(reference.weighted(draws[c], pixels=N,
                                              weight_type="natural"),
                           rows, cols)
            out.append((got, ref))
    return out


@pytest.mark.parametrize("pol", range(P))
def test_two_groups_hold_each_stokes_plane_to_its_own_peak(two_group_step,
                                                           pol):
    """Plane ``pol`` of every channel, gridded in two groups of two
    polarisations a slice, within 2e-5 of its own peak from the float64
    reference (the small cell's limit)."""
    for got, ref in two_group_step:
        assert got.shape == (P,) + ref.shape[1:]
        peak = ref[pol].abs().max()
        ratio = float(peak / ref[0].abs().max())
        assert SCALES[pol] / 3 < ratio < 3 * SCALES[pol]
        err = float((got[pol].double() - ref[pol]).abs().max() / peak)
        assert err < 2e-5, err


def slice_inputs():
    """Channel 0, slice 0 of the small batch at four polarisations."""
    batch, _, _ = dirty_step.program_batch(iquv_config(), SMALL_TRAFFIC,
                                           SEED, "cpu")
    args = [batch.kernel[0]] + [x[0, 0] for x in (
        batch.uv, batch.sub_uv, batch.w_plane, batch.vis, batch.anchor,
        batch.valid)]
    return batch, args, int(batch.n_chunks[0, 0])


def grid_one_slice(route):
    """Channel 0, slice 0 through ``grid_slice`` (route ``grid``) or
    ``slice_planes`` into K23 and K4 (route ``image``)."""
    batch, (kernel, uv, sub, wp, vis, anc, val), n = slice_inputs()
    if route == "grid":
        return fused_gridder.grid_slice(kernel, None, uv, sub, wp, vis, anc,
                                        val, n, pixels=N, ts=TS)
    stack = fused_fft.SliceStack(torch.zeros((P, N, N)), batch.taper1d[0],
                                 batch.pixel_size[0], slices=1, pixels=N,
                                 ts=TS)
    stack.add(fused_gridder.slice_planes(kernel, None, uv, sub, wp, vis, anc,
                                         val, n, pixels=N, ts=TS),
              batch.mid_w[0, 0])
    return stack.flush()


@pytest.mark.parametrize("route", ["grid", "image"])
def test_one_groups_planes_are_alive_at_a_time(route, monkeypatch):
    """When the second group's colour planes are made, the first group's
    are gone: ``grid_slice`` and ``SliceStack.add`` drop each
    group's planes before asking ``slice_planes`` for the next, and the
    generator holds none while it waits."""
    monkeypatch.setattr(mxu_gridder, "MAX_ACC_GB", two_group_cap())
    made, alive = [], []
    original = fused_gridder.grid_chunks_planes

    def tracked(*args, **kwargs):
        alive.append([r() is not None for pair in made for r in pair])
        planes = original(*args, **kwargs)
        made.append((weakref.ref(planes[0]), weakref.ref(planes[1])))
        return planes

    monkeypatch.setattr(fused_gridder, "grid_chunks_planes", tracked)
    grid_one_slice(route)
    assert alive == [[], [False, False]]


@pytest.mark.parametrize("cap,groups", [(None, 1), ("two", 2)])
def test_k1_group_spans_and_counter(cap, groups, monkeypatch):
    """``k1.group`` spans count one group a slice under the cap at the
    small size and two with the cap forced down, in a slice gridded alone
    and in the step (one span a group inside each non-empty slice's
    ``multichannel.slice``); each group's ``k1.prep`` holds one
    ``k1.prep_shared``, the prep that no polarisation changes."""
    if cap is not None:
        monkeypatch.setattr(mxu_gridder, "MAX_ACC_GB", two_group_cap())
    with profiling.installed(profiling.CollectProfiler()) as prof:
        grid_one_slice("grid")
    stacks = [r.stack for r in prof.records]
    shared = ("k1.group", "k1.prep", "k1.prep_shared")
    assert [s[-1] for s in stacks].count("k1.group") == groups
    assert [s[-1] for s in stacks].count("k1.prep") == groups
    assert stacks.count(shared) == groups
    assert stacks.count(shared + ("k1.occupancy",)) == groups

    batch, _, _ = slice_inputs()
    step = mc.single_channel_step(dirty_step.step_config(iquv_config()))
    with profiling.installed(profiling.CollectProfiler()) as prof:
        step(*mc.channel_args(batch, 0))
    slices = [r for r in prof.records if r.stack[-1] == "multichannel.slice"]
    spans = [r for r in prof.records if r.stack[-1] == "k1.group"]
    nonempty = int((batch.n_chunks[0] > 0).sum())
    assert len(slices) == nonempty > 0
    assert len(spans) == groups * nonempty
    assert all("multichannel.slice" in r.stack for r in spans)
    assert sum(r.stack[-3:] == shared for r in prof.records) == (
        groups * nonempty)


def test_the_configuration_follows_its_source():
    """8192 px at the pixel size of katsdpimager's sizing rule for the full
    MeerKAT array at ``--q-fov 1.8`` and ``--image-oversample 5`` (13.5 m
    dishes, 7.7 km), at every channel of the cell; 6 W slices by
    ``parameters.w_slices`` at that pixel size at every channel; and the
    accumulator cap splits its four polarisations into two groups."""
    cell = manifest.cell(CELL)
    conf, traffic = cell.config, cell.traffic
    fixed = parameters.FixedImageParameters(
        (polarization.STOKES_I,) * conf["num_pols"])
    array = parameters.ArrayParameters(13.5, 7700.0)
    freqs = dirty_step.frequencies(traffic)
    first = parameters.make_image_parameters(fixed, 1.8, 5, freqs[0], array)
    assert conf["pixel_size"] == first.pixel_size
    for freq in freqs:
        ip = parameters.make_image_parameters(fixed, 1.8, 5, freq, array)
        assert ip.pixels == conf["pixels"] == 8192
        at = parameters.ImageParameters(
            fixed, parameters.units.wavelength_m(freq),
            pixel_size=conf["pixel_size"], pixels=conf["pixels"])
        assert parameters.w_slices(
            at, conf["max_w_m"], 0.001, conf["kernel_width"],
            conf["antialias_width"]) == conf["w_slices"] == 6
    # The default --q-fov of 1.0 gives a size the kernels do not take.
    assert parameters.make_image_parameters(
        fixed, 1.0, 5, freqs[0], array).pixels == 4608
    assert mxu_gridder.pol_groups(
        conf["num_pols"], conf["pixels"], conf["tile_size"]) == TWO_GROUPS
    assert traffic["vis_per_slice"] == 2 ** 21 // conf["w_slices"]


def test_a_slice_of_the_cells_traffic_packs_without_halving():
    """The first (channel, slice) of the cell's own draws at 8192 px packs
    into the configuration's 16384 chunks with all 349,525 visibilities,
    where the 4k cells' 8192 (and 12288) chunks would not hold it."""
    cell = manifest.cell(CELL)
    conf, traffic = cell.config, cell.traffic
    cfg = dirty_step.step_config(conf)
    counts = []

    def pack(c, s, d):
        counts.append(mc.chunk_channel(cfg, d.uv, d.sub_uv, d.w_plane,
                                       d.vis, d.weights)[1])

    draws = example_batch.draw_slices(
        SEED, channels=1, w_slices=1, pixels=conf["pixels"],
        kernel_width=conf["kernel_width"], oversample=conf["oversample"],
        w_planes=conf["w_planes"], num_pols=conf["num_pols"],
        vis_per_slice=traffic["vis_per_slice"], pack=pack)
    assert len(draws[0][0].uv) == traffic["vis_per_slice"] == 349525
    assert len(counts) == 1
    assert 12288 < counts[0] <= conf["chunks_per_slice"] == 16384


#: The per-layer metrics the cell reports, in the manifest's order: the
#: existing readers of K1's prep, wrappers, roofline, ms per polarisation
#: and the device's idle share, and the cell's own.
READERS = ("dirty.k1_prep_ms", "dirty.k1_prep_device_ms", "dirty.launch_ms",
           "iquv.k1_roofline", "iquv.k1_ms_per_pol", "iquv.idle_share",
           "iquv8k.group_overhead_ms")


def reader(name):
    path = os.path.join(manifest.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_the_cell_loads_with_its_metrics():
    cell = manifest.cell(CELL)
    assert cell.chips == 1
    assert cell.config["num_pols"] == P
    assert cell.config["weight_type"] == "natural"
    assert cell.config["precision"] == "single"
    assert cell.config["reduced"] == []
    assert cell.traffic["runner"] == "dirty_step"
    assert cell.traffic["metric_prefix"] == "dirty"
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "dirty_mvis_per_s", "dirty_step_p95_ms"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert all(m["moves"] == "dirty_mvis_per_s" for m in cell.per_layer)
    # The kernel, the W planes and max_w as the 4k IQUV cell's.
    base = manifest.cell("mkat_l_4k_iquv.dirty")
    same = ("num_pols", "precision", "kernel_width", "oversample",
            "antialias_width", "image_oversample", "w_planes", "max_w_m",
            "chunk_size", "tile_size", "weight_type")
    assert {k: cell.config[k] for k in same} == {
        k: base.config[k] for k in same}
    assert cell.traffic["channels"] == base.traffic["channels"]
    assert cell.traffic["limits"] == base.traffic["limits"]


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_on_an_empty_trace(name):
    assert reader(name)(Trace([], {}, [], 1.0)) is None


WORK = {"chunks": 13800, "valid": 349525, "runs": 13800, "pols": P,
        "ts": 64, "kernel_width": 60, "table_rows": 256}

K1 = "void grid_planes_kernel<128>(Args)"


def group_events():
    """One profiled step of two slices, each with two ``k1.group`` spans.
    Each group's ``k1.prep`` launches, inside its ``k1.prep_shared``, a
    kernel of 4 us, then outside it the group's samples (3 us), and the
    group launches K1 (20 us); the slice launches K23 outside its groups
    (30 us)."""
    events, corr = [], [0]

    def ann(name, ts, dur):
        events.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "ts": ts, "dur": dur})

    def launch(ts, kernel, dev_ts, dur):
        corr[0] += 1
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                       "args": {"correlation": corr[0]}})
        events.append({"ph": "X", "cat": "kernel", "name": kernel,
                       "ts": dev_ts, "dur": dur,
                       "args": {"correlation": corr[0]}})

    dev = 1000
    for s0 in (0, 200):
        ann("multichannel.slice", s0, 100)
        for g0 in (s0 + 10, s0 + 50):
            ann("k1.group", g0, 30)
            ann("k1.prep", g0 + 1, 16)
            ann("k1.prep_shared", g0 + 1, 8)
            launch(g0 + 2, "elementwise_kernel", dev, 4)
            launch(g0 + 12, "samples_kernel", dev + 4, 3)
            launch(g0 + 20, K1, dev + 7, 20)
            dev += 27
        launch(s0 + 90, "combine_cb_col_fft_kernel", dev, 30)
        dev += 30
    return events


def test_each_reader_reads_a_synthetic_trace():
    trace = Trace([], {"trace.steps": 2, "k1.work": [WORK] * 2,
                       "k1.launches": 8},
                  [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 80000,
                    "name": K1}], 0.100, host_events=group_events())
    got = reader("iquv.k1_roofline")(trace)
    assert got == pytest.approx(reader("dirty.k1_roofline")(trace))
    # The colour-plane writes bound the floor at this layout: 2 steps of
    # 2 slices, each 13,800 runs x 4 planes x 128^2 x 8 B, over 80 ms.
    planes_s = 13800 * P * 128 ** 2 * 8 / 3.35e12
    assert got == pytest.approx(100 * 2 * 2 * planes_s / 0.080, rel=0.01)
    # K1's 80 ms over 2 steps and 4 polarisations.
    assert reader("iquv.k1_ms_per_pol")(trace) == pytest.approx(10.0)

    overhead = reader("iquv8k.group_overhead_ms")
    # The second group of each slice: its shared prep (4 us), not its
    # samples, not its K1, not the first group's work, not K23.
    assert overhead(trace) == pytest.approx(2 * 4e-3)
    # One group a slice: nothing to read.
    single = [ev for ev in group_events()
              if not (ev.get("name") == "k1.group" and ev["ts"] % 200 == 50)]
    assert overhead(Trace([], {}, [], 0.01, host_events=single)) is None
    # A program without the shared prep's span: nothing read.
    bare = [ev for ev in group_events()
            if ev.get("name") != "k1.prep_shared"]
    assert overhead(Trace([], {}, [], 0.01, host_events=bare)) is None
