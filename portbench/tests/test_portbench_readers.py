"""Every per-layer metric's reader on a synthetic trace, the trace's
reduction and the work-count arithmetic."""

import importlib.util
import os

import pytest

from portbench import manifest
from portbench.common import peaks
from portbench.common.trace import (Recorder, Trace, idle_gaps,
                                    top_device_ops, union_s)


def reader_module(name):
    path = os.path.join(manifest.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def host(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


WORK = {"chunks": 4905, "valid": 524288, "runs": 3848, "pols": 1, "ts": 64,
        "kernel_width": 60, "table_rows": 256}

# Two steps of one K1 launch each (1000 us and 1200 us of K1), a K4, a
# copy, an annotation (not device work) and what the host did meanwhile.
EVENTS = [
    kernel("void grid_planes_kernel<128>(Args)", 0, 1000),
    kernel("epi_col_fft_kernel", 1000, 500),
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 1400,
     "dur": 200},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "span", "ts": 0,
     "dur": 10000},
    kernel("void grid_planes_kernel<128>(Args)", 3000, 1200),
    host("dirty step", 0, 5000, "user_annotation"),
    host("aten::index_select", 1700, 1000),
    host("aten::zeros", 2000, 100),
]


def synthetic(**counters):
    base = {"trace.steps": 2, "k1.work": [WORK], "k1.launches": 2}
    base.update(counters)
    spans = [("dirty.step", 0.0, 0.070), ("dirty.step", 0.1, 0.180),
             ("other", 0.0, 5.0)]
    return Trace(spans, base, EVENTS, window_s=0.010, host_events=EVENTS)


def test_union_and_busy_time():
    assert union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
    # 0-1600 covered (kernel, K4, copy), 3000-4200: 2800 us.
    assert synthetic().busy_s() == pytest.approx(2800e-6)
    assert synthetic().kernel_seconds("grid_planes_kernel") == pytest.approx(
        2200e-6)


def test_breakdown_lists():
    ops = top_device_ops(synthetic())
    assert ops[0] == ["void grid_planes_kernel<128>(Args)",
                      pytest.approx(2200e-6)]
    assert len(ops) == 3
    gaps = idle_gaps(synthetic())
    # one gap, 1600-3000 us; at its middle (2300) the host runs
    # index_select (the innermost event covering it).
    assert gaps == [["aten::index_select", pytest.approx(1400e-6)]]


def test_host_enqueue_reader():
    read = reader_module("dirty.host_enqueue_ms").read
    assert read(synthetic()) == pytest.approx(75.0)
    assert read(Trace([], {}, [], 1.0)) is None


def test_k1_work_counts():
    m = reader_module("dirty.k1_roofline")
    nbytes = (2 * 4905 * 4 + 524288 * (16 + 8) + 256 * 60 * 8
              + 3848 * 1 * 128 ** 2 * 8)
    assert m.launch_bytes(WORK) == nbytes
    assert m.launch_flops(WORK) == 8.0 * 60 ** 2 * 524288
    # The production slice is bound by bytes: ~0.154 ms.
    assert m.floor_s(WORK) == pytest.approx(nbytes / 3.35e12)
    assert 0.15e-3 < m.floor_s(WORK) < 0.16e-3
    assert peaks.F32_ACCURATE_FLOP_PER_S == pytest.approx(165e12)


def test_k1_roofline_reader():
    m = reader_module("dirty.k1_roofline")
    got = m.read(synthetic())
    assert got == pytest.approx(100 * 2 * m.floor_s(WORK) / 2200e-6)
    assert 0 < got < 100
    # Nothing read where K1 did not run, or no steps were traced.
    no_k1 = Trace([], {"trace.steps": 2, "k1.work": [WORK],
                       "k1.launches": 2},
                  [e for e in EVENTS if "grid_planes" not in e["name"]], 1.0)
    assert m.read(no_k1) is None
    assert m.read(synthetic(**{"trace.steps": 0})) is None
    assert m.read(synthetic(**{"k1.launches": 0})) is None


def test_recorder_spans_and_counts():
    rec = Recorder()
    rec.add_span("a", 1.0, 1.5)
    rec.count("n", 2)
    rec.count("n", 3)
    assert rec.spans == [("a", 1.0, 1.5)] and rec.counters["n"] == 5
    assert Trace(rec.spans, rec.counters, [], 1.0).span_seconds("a") == [0.5]


def test_every_manifest_metric_has_a_reader():
    for m in manifest.load()["per_layer"]:
        assert callable(reader_module(m["name"]).read)


@pytest.mark.parametrize("name", ["dirty.idle_share", "uniform.idle_share",
                                  "clean.idle_share"])
def test_idle_share_readers(name):
    read = reader_module(name).read
    assert read(synthetic()) == pytest.approx(100 * (1 - 2800e-6 / 0.010))
    assert read(Trace([], {}, [], 1.0)) is None


def test_weight_grid_reader():
    read = reader_module("uniform.weight_grid_ms").read
    spans = [("dirty.step", 0.0, 6.0), ("weight_grid", 0.1, 0.85),
             ("weight_grid", 1.0, 1.75), ("dirty.step", 6.0, 12.0),
             ("weight_grid", 6.1, 6.6)]
    assert read(Trace(spans, {}, [], 1.0)) == pytest.approx(1e3 * 2.0 / 2)
    assert read(Trace(spans[:1], {}, [], 1.0)) is None


def test_clean_readers():
    spans = [("wave", 0.0, 3.0), ("clean.stage", 0.1, 1.1),
             ("clean.stage", 1.5, 3.0), ("wave", 3.0, 5.0),
             ("clean.stage", 3.2, 4.7)]
    trace = Trace(spans, {"minor": 1500}, [], 1.0)
    share = reader_module("clean.clean_share").read
    rate = reader_module("clean.minor_cycles_per_s").read
    assert share(trace) == pytest.approx(100 * 4.0 / 5.0)
    assert rate(trace) == pytest.approx(1500 / 4.0)
    empty = Trace([], {}, [], 1.0)
    assert share(empty) is None and rate(empty) is None
