"""The port's profilers (``katsdpimager_tpu_torch.profiling``) as the JAX
package's are tested (tests/test_misc.py): the flamegraph and collecting
profilers, the decorator bare and named, the device trace round trip on
the CPU, and the CLI's ``--write-profile`` and
``--write-device-profile``."""

import io

import pytest
import torch

from katsdpimager_tpu import profiling as jax_profiling
from katsdpimager_tpu import simulate
from katsdpimager_tpu_torch import imager, profiling


@pytest.fixture
def installed():
    """Install a profiler for one test, restoring the old one."""
    old = profiling.Profiler.get_profiler()

    def install(prof):
        profiling.Profiler.set_profiler(prof)
        return prof

    yield install
    profiling.Profiler.set_profiler(old)


def test_flamegraph_exclusive(installed):
    prof = installed(profiling.FlamegraphProfiler())
    with profiling.profile("outer"):
        with profiling.profile("inner"):
            pass
    assert ("outer",) in prof.inclusive
    assert ("outer", "inner") in prof.inclusive
    excl = prof.exclusive()
    assert excl[("outer",)] <= prof.inclusive[("outer",)]


def test_collect(installed):
    prof = installed(profiling.CollectProfiler())
    with profiling.profile("a"):
        pass
    assert [r.stack for r in prof.records] == [("a",)]


def test_profile_function_bare_and_named(installed):
    """``@profile_function`` bare (as the frontend uses it), called and
    named; each call records its stack, as the JAX decorator does."""
    prof = installed(profiling.CollectProfiler())

    @profiling.profile_function
    def bare():
        return 1

    @profiling.profile_function()
    def called():
        return bare() + 1

    @profiling.profile_function("stage")
    def named():
        return called() + 1

    assert named() == 3
    prefix = "test_profile_function_bare_and_named.<locals>."
    assert [r.stack for r in prof.records] == [
        ("stage", prefix + "called", prefix + "bare"),
        ("stage", prefix + "called"), ("stage",)]


def test_flamegraph_output_matches_jax_format():
    """The same stacks give the same flamegraph lines' stacks in both
    packages (``a;b microseconds``)."""
    lines = []
    for mod in (profiling, jax_profiling):
        old = mod.Profiler.get_profiler()
        prof = mod.FlamegraphProfiler()
        mod.Profiler.set_profiler(prof)
        try:
            prof.record(mod.Record(("a",), 0.75))
            prof.record(mod.Record(("a", "b"), 0.25))
        finally:
            mod.Profiler.set_profiler(old)
        sink = io.StringIO()
        prof.write_flamegraph(sink)
        lines.append(sink.getvalue())
    assert lines[0] == lines[1] == "a 500000\na;b 250000\n"


def test_device_profile_capture(tmp_path):
    """device_trace -> parse_device_profile -> write_device_profile on
    the CPU: with no device events the host's operators are summed, each
    named range shows, and the file has ``line;op microseconds`` lines,
    largest first."""
    d = str(tmp_path / "trace")
    with profiling.device_trace(d):
        x = torch.ones((256, 256))
        with profiling.profile("stage_x"):
            for _ in range(3):
                x = x @ x / 256
    totals = profiling.parse_device_profile(d)
    assert totals, "no events parsed from the trace"
    assert all(line == "host" for line, _ in totals)
    assert any(op == "stage_x" for _, op in totals)
    assert any(op == "aten::mm" for _, op in totals)
    out = tmp_path / "prof.txt"
    with open(out, "w") as f:
        profiling.write_device_profile(totals, f)
    lines = out.read_text().strip().splitlines()
    assert lines and all(";" in ln and ln.rsplit(" ", 1)[1].isdigit()
                         for ln in lines)
    us = [int(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert us == sorted(us, reverse=True)


def test_parse_device_profile_sums_kernels_by_stream(tmp_path):
    """Device kernels, copies and memsets are summed by (stream, name);
    host events are then left out; annotations are not device work."""
    import json

    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "dur": 5.0,
         "args": {"stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "k1", "dur": 3.0,
         "args": {"stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 2.0,
         "args": {"stream": 8}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "stage",
         "dur": 40.0, "args": {"stream": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9.0},
    ]
    d = tmp_path / "t"
    d.mkdir()
    (d / "trace.json").write_text(json.dumps({"traceEvents": events}))
    totals = profiling.parse_device_profile(str(d))
    assert totals == {("stream 7", "k1"): pytest.approx(8e-6),
                      ("stream 8", "Memcpy DtoH"): pytest.approx(2e-6)}


def test_cli_writes_both_profiles(tmp_path):
    """``--write-profile`` names the frontend's stages, stacked as the JAX
    CLI stacks them; ``--write-device-profile`` writes flamegraph lines and keeps
    the raw trace beside them."""
    path = tmp_path / "sim.h5"
    simulate.make_sim_dataset(str(path), num_antennas=16, num_times=24,
                              num_channels=1, max_radius=800.0)
    prof, dprof = tmp_path / "p.txt", tmp_path / "d.txt"
    assert imager.main([str(path), str(tmp_path / "c_%c.fits"), "--pixels",
                        "256", "--kernel-width", "12", "--major", "1",
                        "--no-tmp-file", "--host", "--write-profile",
                        str(prof), "--write-device-profile",
                        str(dprof)]) == 0
    stacks = {ln.rsplit(" ", 1)[0] for ln in prof.read_text().splitlines()}
    for stage in ("preprocess_visibilities", "process_channel",
                  "process_channel;make_weights",
                  "process_channel;make_dirty"):
        assert stage in stacks, stage
    lines = dprof.read_text().splitlines()
    assert lines and all(ln.rsplit(" ", 1)[1].isdigit() for ln in lines)
    assert any("process_channel" in ln for ln in lines)
    assert (tmp_path / "d.txt.trace" / "trace.json").exists()
    # the profiler that was installed before the run is back
    assert type(profiling.Profiler.get_profiler()) is profiling.Profiler


def test_profile_with_nothing_listening_is_a_shared_noop(monkeypatch):
    """With the null profiler installed and ``torch.profiler`` off,
    ``profile`` hands out one shared context that reads no clock, sets no
    stack, enters no ``record_function`` and records nothing."""
    assert type(profiling.Profiler.get_profiler()) is profiling.Profiler

    def refuse(*args, **kwargs):
        raise AssertionError("touched while nothing listens")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    monkeypatch.setattr(profiling.Profiler, "record", refuse)
    assert profiling.profile("a") is profiling.profile("b")
    with profiling.profile("outer"):
        with profiling.profile("inner"):
            assert profiling._current_stack.get() == ()


def test_records_enclose_their_spans_in_the_trace(installed, tmp_path):
    """Under ``torch.profiler`` with CPU activity each span's record,
    stamped on ``time.time_ns()``, encloses the ``user_annotation`` of the
    same span in the exported trace (``baseTimeNanoseconds`` + ``ts``);
    the median gap at each end is under 50 us.  The first span of the
    process's profiler is a warm-up and is not compared."""
    import json

    prof = installed(profiling.CollectProfiler())
    x = torch.ones((64, 64))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        with profiling.profile("warm-up"):
            x = x @ x
        for i in range(20):
            with profiling.profile(f"span{i}"):
                x = x @ x / 64
    path = tmp_path / "trace.json"
    tp.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    annotations = {ev["name"]: ev for ev in trace["traceEvents"]
                   if ev.get("cat") == "user_annotation"}
    heads, tails = [], []
    for rec in prof.records[1:]:
        ev = annotations[rec.stack[-1]]
        start = base + ev["ts"] * 1e3
        end = start + ev["dur"] * 1e3
        heads.append((start - rec.start_ns) / 1e3)
        tails.append((rec.end_ns - end) / 1e3)
        assert rec.end_ns - rec.start_ns == pytest.approx(rec.elapsed * 1e9)
    assert len(heads) == 20
    # enclosed (to the trace's rounding of its microseconds)
    assert min(heads) >= -1.0 and min(tails) >= -1.0
    assert sorted(heads)[10] <= 50.0 and sorted(tails)[10] <= 50.0


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_step_span_tree(installed, weight_type):
    """One channel of the step at 256 px on the CPU: one
    ``multichannel.channel`` span; under it the weights (uniform only)
    and a ``multichannel.slice`` per non-empty slice, each holding one
    polarisation group's ``k1.group`` (in it K1's prep, whose
    polarisation-independent part ``k1.prep_shared`` holds the occupancy
    mask's ``k1.occupancy``, and K1's wrapper) and the
    wrapper of K23 (``k3.launch``: the slice loop takes it in place of
    K2 then K3, so no ``k2.launch``); after the last slice, K4's wrapper
    once (``k4.launch``: one launch takes the channel's slices)."""
    import collections

    from katsdpimager_tpu_torch.parallel import multichannel as mc

    cfg = mc.MultiChannelConfig(
        pixels=256, num_pols=1, kernel_width=16, oversample=8, w_planes=8,
        w_slices=4, chunks_per_slice=64, chunk_size=128, rv=32, ru=32,
        weight_type=weight_type)
    batch = mc.make_example_batch(cfg, 1, seed=3, vis_per_slice=500,
                                  device="cpu")
    *args, nc = mc.channel_args(batch, 0)
    nc[1] = 0                       # slice 1 is skipped
    prof = installed(profiling.CollectProfiler())
    mc.single_channel_step(cfg)(*args, nc)
    counts = collections.Counter(r.stack for r in prof.records)
    channel = ("multichannel.channel",)
    sl = channel + ("multichannel.slice",)
    group = sl + ("k1.group",)
    want = {channel: 1, sl: 3, group: 3}
    want[sl + ("k3.launch",)] = 3
    want[channel + ("k4.launch",)] = 1
    want.update({group + (name,): 3 for name in ("k1.prep", "k1.launch")})
    shared = group + ("k1.prep", "k1.prep_shared")
    want[shared] = 3
    want[shared + ("k1.occupancy",)] = 3
    if weight_type == "uniform":
        want[channel + ("multichannel.weights",)] = 1
    assert counts == want
    for rec in prof.records:
        assert rec.start_ns <= rec.end_ns
    # children lie inside their parents
    outer = [r for r in prof.records if r.stack == channel][0]
    assert all(outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
               for r in prof.records)


def test_clean_stage_spans(installed):
    """A cube CLEAN stage: its span holds each batch of minor cycles
    (``clean.batch``) and each read of the stop flag (``clean.sync``),
    one of each per batch."""
    from katsdpimager_tpu_torch.parallel import cube

    cfg = cube.CubeConfig(
        pixels=128, num_pols=1, kernel_width=16, oversample=8, w_planes=8,
        w_slices=2, chunks_per_slice=16, chunk_size=128, rv=32, ru=32,
        majors=1, minor=150, patch=17, psf_core=32, loop_gain=0.1,
        threshold_sigma=0.0, major_gain=1.0)
    gen = torch.Generator().manual_seed(4)
    residual = torch.randn((1, 128, 128), generator=gen)
    residual[0, 64, 64] = 50.0
    psf = torch.zeros((1, 17, 17))
    psf[0, 8, 8] = 1.0
    prof = installed(profiling.CollectProfiler())
    cube._clean_stage(cfg, residual, torch.zeros_like(residual), psf)
    stacks = [r.stack for r in prof.records]
    stage = ("cube.clean_stage",)
    batches = stacks.count(stage + ("clean.batch",))
    # 1 cycle, then 149 in batches of 64: 1 + 3 batches, none stopped early
    assert batches == 4
    assert stacks.count(stage + ("clean.sync",)) == batches
    assert stacks[-1] == stage and len(stacks) == 2 * batches + 1


def test_cli_profile_names_the_programs_spans(tmp_path):
    """``--write-profile`` names the per-channel path's spans inside the
    frontend's stages: the slice plans, the polarisation group (K1's prep
    and wrapper), K2's wrapper, and CLEAN's batches and stop-flag
    reads."""
    path = tmp_path / "sim.h5"
    simulate.make_sim_dataset(str(path), num_antennas=16, num_times=24,
                              num_channels=1, max_radius=800.0)
    prof = tmp_path / "p.txt"
    assert imager.main([str(path), str(tmp_path / "c_%c.fits"), "--pixels",
                        "256", "--kernel-width", "12", "--major", "1",
                        "--no-tmp-file", "--host", "--write-profile",
                        str(prof)]) == 0
    stacks = {ln.rsplit(" ", 1)[0] for ln in prof.read_text().splitlines()}
    grid = "process_channel;make_dirty;grid_slice_0"
    for stack in (grid + ";imaging.slice_plan", grid + ";k1.group",
                  grid + ";k1.group;k1.prep", grid + ";k1.group;k1.launch",
                  grid + ";k2.launch",
                  "process_channel;clean.batch",
                  "process_channel;clean.sync"):
        assert stack in stacks, stack
