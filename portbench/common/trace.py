"""Spans, counters and the device trace of one run, and their reduction.

The benchmark records its own spans (host clock) and counters around the
calls it makes into the program; with ``--trace 1`` it also profiles a
stretch of the run under ``torch.profiler`` and hands the readers in
``metrics/`` a :class:`Trace` of all three.  The device's busy time is the
union of its kernel, copy and memset intervals; ``record_function`` ranges
also appear on the device (``gpu_user_annotation``) and are not device
work, so they are left out.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile

#: Trace categories that are work on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: Trace categories of what the host does.
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   "cuda_runtime")


class Recorder:
    """The benchmark's own spans (name, start, end in host seconds) and
    counters."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}

    def add_span(self, name: str, t0: float, t1: float) -> None:
        self.spans.append((name, t0, t1))

    def count(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + value


@dataclasses.dataclass
class Trace:
    """What a per-layer metric's reader gets: the benchmark's spans and
    counters over the whole run, the profiler's events over the traced
    stretch, and that stretch's seconds."""

    spans: list
    counters: dict
    events: list
    window_s: float
    #: Events of a second stretch profiled with the host's operations too
    #: (which slow a host-bound path, so the busy time is not read from
    #: it): the idle gaps are named from it.
    host_events: list = dataclasses.field(default_factory=list)

    def span_seconds(self, name: str) -> list:
        return [t1 - t0 for n, t0, t1 in self.spans if n == name]

    def device_intervals(self) -> list:
        """(start us, end us, name) of each device operation."""
        return [(ev["ts"], ev["ts"] + ev["dur"], ev["name"])
                for ev in self.events
                if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES]

    def kernel_seconds(self, pattern: str) -> float:
        """Seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, name in self.device_intervals()
                   if rx.search(name)) / 1e6

    def busy_s(self) -> float:
        return union_s([(s, e) for s, e, _ in self.device_intervals()])

    def idle_share(self):
        """The share of the traced stretch in which the device ran
        nothing, %; None where the trace holds no device work."""
        busy = self.busy_s()
        if self.window_s <= 0 or busy <= 0:
            return None
        return 100.0 * (1.0 - busy / self.window_s)


def union_s(intervals) -> float:
    """Seconds covered by the union of (start us, end us) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e6


@contextlib.contextmanager
def profiled(cuda: bool, host: bool):
    """``torch.profiler`` over the block: the device's operations (with
    ``cuda``) and, with ``host``, the host's; yields a list that holds
    the trace's events once the block has ended."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    events: list = []
    with torch.profiler.profile(activities=acts) as prof:
        yield events
    events.extend(events_of(prof))


def events_of(prof) -> list:
    """The events of a profiler run's chrome trace (written to a
    temporary directory under ``TMPDIR`` and read back)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def top_device_ops(trace: Trace, count: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    by_name: dict = {}
    for s, e, name in trace.device_intervals():
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    return [[n, t] for n, t in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:count]]


def idle_gaps(trace: Trace, count: int = 10) -> list:
    """[host activity, seconds] of the ``count`` longest gaps between the
    device's operations in the stretch profiled with the host's
    operations, each named by the innermost host operation that was
    running at the gap's middle ("host idle" where none was)."""
    named = Trace([], {}, trace.host_events, 0.0)
    spans = sorted((s, e) for s, e, _ in named.device_intervals())
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    host = sorted((ev["ts"], ev["ts"] + ev.get("dur", 0), ev["name"])
                  for ev in named.events
                  if ev.get("ph") == "X" and ev.get("cat") in HOST_CATEGORIES)
    starts = [h[0] for h in host]
    out = []
    for dur, g0, g1 in gaps[:count]:
        mid = 0.5 * (g0 + g1)
        best = None
        for s, e, name in reversed(host[:bisect.bisect_right(starts, mid)]):
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        out.append([best[1] if best else "host idle", dur / 1e6])
    return out
