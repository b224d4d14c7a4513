"""``chip_smoke.device_busy_ms``: the device's busy time in a profiler
trace is the union of its kernel, copy and memset intervals; the
profiler's ``record_function`` ranges and host events are not device
work."""

import json

import pytest

import chip_smoke


class FakeProfile:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.mark.parametrize("events, busy_us, by_name", [
    # overlapping kernels count once; a copy after them adds its own span
    ([x("kernel", "a", 0, 10), x("kernel", "b", 5, 15),
      x("gpu_memcpy", "Memcpy DtoH", 30, 5)],
     25, {"a": 10, "b": 15, "Memcpy DtoH": 5}),
    # a range annotation on the device and host events are left out
    ([x("gpu_user_annotation", "grid_slice", 0, 100),
      x("user_annotation", "grid_slice", 0, 100),
      x("cpu_op", "aten::add", 0, 50), x("cuda_runtime", "cudaLaunch", 1, 2),
      x("kernel", "k", 10, 4), x("gpu_memset", "Memset", 12, 4),
      {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0}],
     6, {"k": 4, "Memset": 4}),
    # a kernel inside another, and one that starts where the last ended
    ([x("kernel", "a", 0, 20), x("kernel", "a", 5, 5), x("kernel", "c", 20, 1)],
     21, {"a": 25, "c": 1}),
    ([x("cpu_op", "aten::mm", 0, 9)], 0, {}),
])
def test_device_busy_is_the_union_of_device_work(events, busy_us, by_name):
    busy_ms, names = chip_smoke.device_busy_ms(FakeProfile(events))
    assert busy_ms == pytest.approx(busy_us / 1e3, abs=1e-12)
    assert names == pytest.approx({k: v / 1e3 for k, v in by_name.items()})
