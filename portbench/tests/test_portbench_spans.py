"""The program's spans in a profiled stretch (``common/spans.py``) and the
four readers of them, on synthetic traces; and, on the CPU at the small
size, that the stretch they read is one step."""

import pytest

from portbench.common import spans
from portbench.common.trace import Trace
from portbench.runners import dirty_step
from portbench.tests.small import SEED, small_cell
from portbench.tests.test_portbench_readers import reader_module


def annotation(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def launch(corr, ts, cat="cuda_runtime", name="cudaLaunchKernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 5,
            "args": {"correlation": corr}}


def device(corr, ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# A step of two slices: K1's prep (100-200, 1000-1150) launches a kernel
# and a copy in the first and a kernel in the second; the launch spans
# hold K1 and K2 (300-340, 400-430) and K3, K4 (500-520, 600-610).  A
# kernel launched at 90, before the first prep, runs 150-400 and is not
# the prep's; the weights (0-80) launch two overlapping kernels.
EVENTS = [
    annotation("multichannel.channel", 0, 2000),
    annotation("multichannel.weights", 0, 80),
    launch(1, 10), device(1, 20, 3000, name="indexing_backward_kernel"),
    launch(2, 30), device(2, 1000, 3000),
    launch(3, 90), device(3, 150, 250),
    annotation("multichannel.slice", 95, 900),
    annotation("k1.prep", 100, 100),
    launch(4, 110), device(4, 400, 100),
    launch(5, 120, name="cudaMemcpyAsync"),
    device(5, 450, 100, cat="gpu_memcpy", name="Memcpy DtoD"),
    annotation("k1.launch", 300, 40), launch(6, 310, "cuda_driver"),
    device(6, 600, 1000, name="grid_planes_kernel"),
    annotation("k2.launch", 400, 30),
    annotation("k3.launch", 500, 20),
    annotation("k4.launch", 600, 10),
    {"ph": "X", "cat": "gpu_user_annotation", "name": "k1.prep", "ts": 400,
     "dur": 2000, "args": {"correlation": 4}},
    annotation("multichannel.slice", 995, 600),
    annotation("k1.prep", 1000, 150), launch(7, 1100),
    device(7, 2000, 40),
    {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 2000, "id": 7},
]


def trace(events=EVENTS):
    return Trace([], {}, [], 1.0, host_events=events)


def test_spans_by_name():
    assert spans.spans(EVENTS, ("k1.prep",)) == [(100, 200), (1000, 1150)]
    assert spans.host_ms(EVENTS, ("k1.prep",)) == pytest.approx(0.25)
    assert spans.host_ms(EVENTS, ("k1.launch", "k4.launch")) == (
        pytest.approx(0.05))
    assert spans.host_ms(EVENTS, ("nothing",)) is None


def test_work_is_the_spans_that_launched_it():
    """By the launch's start inside the span, matched by correlation: not
    the kernel launched before it, not the device-side annotation."""
    assert sorted(spans.launched(EVENTS, ("k1.prep",))) == [
        (400, 500), (450, 550), (2000, 2040)]
    assert spans.launched(EVENTS, ("k1.launch",)) == [(600, 1600)]
    assert spans.launched(EVENTS, ("k2.launch",)) == []
    # the union: 400-550 and 2000-2040
    assert spans.device_ms(EVENTS, ("k1.prep",)) == pytest.approx(0.19)
    # the weights' two kernels overlap: 20-4000
    assert spans.device_ms(EVENTS, ("multichannel.weights",)) == (
        pytest.approx(3.98))
    assert spans.device_ms(EVENTS, ("k2.launch",)) is None


def test_a_launch_at_a_spans_edges_is_its_own():
    events = [annotation("k1.prep", 100, 50), launch(1, 100),
              device(1, 500, 10), launch(2, 150), device(2, 600, 10),
              launch(3, 151), device(3, 700, 10)]
    assert spans.launched(events, ("k1.prep",)) == [(500, 510), (600, 610)]


@pytest.mark.parametrize("name, want", [
    ("dirty.k1_prep_ms", 0.25),
    ("dirty.k1_prep_device_ms", 0.19),
    ("dirty.launch_ms", 0.1),
    ("uniform.weight_grid_device_ms", 3.98)])
def test_span_readers(name, want):
    """Each reader sums over the whole stretch (one step: the readers do
    not divide), and reads nothing where its spans are missing."""
    read = reader_module(name).read
    assert read(trace()) == pytest.approx(want)
    assert read(trace([ev for ev in EVENTS
                       if ev.get("cat") != "user_annotation"])) is None
    assert read(Trace([], {}, [], 1.0)) is None


def test_the_host_stretch_is_one_step():
    """The traced run's stretch with the host's operations holds one step
    of the small cell: one ``multichannel.channel`` span a channel, and
    K1's prep and wrappers once a non-empty slice; the host readers sum
    those spans."""
    cell = small_cell()
    out = dirty_step.run(cell, seed=SEED, seconds=0.3, trace=True,
                         device="cpu")
    events = out["trace"].host_events
    channels = cell.traffic["channels"]
    slices = channels * cell.config["w_slices"]
    assert len(spans.spans(events, ("multichannel.channel",))) == channels
    for name in ("multichannel.slice", "k1.prep", "k1.launch", "k2.launch",
                 "k3.launch", "k4.launch"):
        assert len(spans.spans(events, (name,))) == slices, name
    assert spans.spans(events, ("multichannel.weights",)) == []
    assert reader_module("dirty.k1_prep_ms").read(out["trace"]) == (
        pytest.approx(spans.host_ms(events, ("k1.prep",))))
    launch_ms = reader_module("dirty.launch_ms").read(out["trace"])
    channel_ms = spans.host_ms(events, ("multichannel.channel",))
    assert 0 < launch_ms + spans.host_ms(events, ("k1.prep",)) <= channel_ms
    # no device on the CPU: the device readers read nothing
    assert reader_module("dirty.k1_prep_device_ms").read(out["trace"]) is None
