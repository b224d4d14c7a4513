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
