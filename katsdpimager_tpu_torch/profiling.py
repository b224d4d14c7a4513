"""Host-side frame-stack profiler plus the device trace of a run.

Counterpart of :mod:`katsdpimager_tpu.profiling`: an interned frame tree
of stopwatches (contextvars), the ``profile`` context and the
``profile_function`` decorator, a pluggable profiler (the null
:class:`Profiler`, :class:`FlamegraphProfiler`, :class:`CollectProfiler`)
and flamegraph.pl-format output.  Each ``profile`` range is also a
:func:`torch.profiler.record_function`, so under ``torch.profiler`` it
shows as a named span (a ``user_annotation``) around the host calls and
the device work they enqueue.  The device trace is ``torch.profiler``
with CPU and CUDA activities (the JAX package's is XProf);
:func:`parse_device_profile` sums each device kernel's time by stream
and name.

With nothing listening (the null :class:`Profiler` installed and
``torch.profiler`` not recording) :func:`profile` returns one shared
no-op context: no clock, no contextvar, no ``record_function``, so the
spans on the imaging path cost a fraction of a microsecond each.  A
:class:`Record` carries its span's start and end in nanoseconds on
``time.time_ns()``'s clock, the one a ``torch.profiler`` Chrome trace
stamps its events on (``baseTimeNanoseconds`` plus ``ts`` microseconds),
so records a :class:`CollectProfiler` holds can be laid over an exported
trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import glob
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

_current_stack: contextvars.ContextVar[Tuple[str, ...]] = \
    contextvars.ContextVar("katsdpimager_tpu_torch_profile_stack",
                           default=())

#: Trace event categories of device work (kernels, copies, memsets).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_TRACE_FILE = "trace.json"


class Record:
    """One span: its stack of names (the last its own, the one before its
    parent's), host seconds, and start and end on ``time.time_ns()``'s
    clock (None where not stamped)."""

    __slots__ = ("stack", "elapsed", "start_ns", "end_ns")

    def __init__(self, stack: Tuple[str, ...], elapsed: float,
                 start_ns: Optional[int] = None,
                 end_ns: Optional[int] = None):
        self.stack = stack
        self.elapsed = elapsed
        self.start_ns = start_ns
        self.end_ns = end_ns


class Profiler:
    """Base profiler: does nothing (NullProfiler semantics)."""

    _instance: "Profiler" = None  # set below
    #: Whether the installed profiler is anything but the null one.
    _listening = False

    @classmethod
    def set_profiler(cls, profiler: "Profiler"):
        cls._instance = profiler
        Profiler._listening = type(profiler) is not Profiler

    @classmethod
    def get_profiler(cls) -> "Profiler":
        return cls._instance

    def record(self, record: Record):
        pass


class CollectProfiler(Profiler):
    """Collects every record (for tests)."""

    def __init__(self):
        self.records: List[Record] = []

    def record(self, record: Record):
        self.records.append(record)

    def seconds(self, name: str) -> float:
        """Host seconds in the spans named ``name``."""
        return sum(r.elapsed for r in self.records if r.stack[-1] == name)


class FlamegraphProfiler(Profiler):
    """Aggregates exclusive time per stack for flamegraph.pl."""

    def __init__(self):
        self.inclusive: Dict[Tuple[str, ...], float] = {}

    def record(self, record: Record):
        self.inclusive[record.stack] = (
            self.inclusive.get(record.stack, 0.0) + record.elapsed)

    def exclusive(self) -> Dict[Tuple[str, ...], float]:
        out = dict(self.inclusive)
        for stack, elapsed in self.inclusive.items():
            if len(stack) > 1:
                parent = stack[:-1]
                if parent in out:
                    out[parent] -= elapsed
        return out

    def write_flamegraph(self, f):
        for stack, elapsed in sorted(self.exclusive().items()):
            if elapsed > 0:
                f.write(";".join(stack) + f" {int(elapsed * 1e6)}\n")


Profiler._instance = Profiler()


class _Off:
    """The context :func:`profile` returns when nothing listens."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Span:
    """A :func:`profile` range while something listens."""

    __slots__ = ("name", "stack", "token", "start_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.stack = _current_stack.get() + (self.name,)
        self.token = _current_stack.set(self.stack)
        self.range = torch.profiler.record_function(self.name)
        self.start_ns = time.time_ns()
        self.range.__enter__()

    def __exit__(self, *exc):
        try:
            self.range.__exit__(*exc)
        finally:
            end_ns = time.time_ns()
            _current_stack.reset(self.token)
            Profiler.get_profiler().record(Record(
                self.stack, (end_ns - self.start_ns) * 1e-9, self.start_ns,
                end_ns))


def profile(name: str):
    """Stopwatch context: times the block on the host clock, names it
    for ``torch.profiler`` (``record_function``) and reports to the
    active profiler; the shared no-op context where neither a profiler
    other than the null one is installed nor ``torch.profiler`` is
    recording."""
    if Profiler._listening or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def installed(profiler: Profiler):
    """Install ``profiler`` for the block, then the one it replaced."""
    old = Profiler.get_profiler()
    Profiler.set_profiler(profiler)
    try:
        yield profiler
    finally:
        Profiler.set_profiler(old)


def profile_function(name=None):
    """Decorator applying :func:`profile` around each call, named after
    the function or ``name``: ``@profile_function``,
    ``@profile_function()`` or ``@profile_function("stage")``."""
    if callable(name):
        return profile_function()(name)

    def decorator(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with profile(label):
                return fn(*args, **kwargs)

        return wrapper

    return decorator


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU and CUDA activities)
    and write its Chrome trace into ``log_dir`` (viewable in Perfetto or
    ``chrome://tracing``; read back by :func:`parse_device_profile`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, _TRACE_FILE))


def parse_device_profile(log_dir: str) -> Dict[Tuple[str, str], float]:
    """Per-kernel device time from the traces :func:`device_trace` wrote
    under ``log_dir``: {(``"stream <id>"``, kernel name): total seconds}
    over every kernel, copy and memset on the device.

    A trace with no device events (a run on the CPU) gives the host's
    PyTorch operators and :func:`profile` ranges instead, keyed
    ``("host", name)``, as the JAX package falls back to its host
    executor lines."""
    device: Dict[Tuple[str, str], float] = {}
    host: Dict[Tuple[str, str], float] = {}
    for path in sorted(glob.glob(os.path.join(log_dir, "**", "*.json"),
                                 recursive=True)):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for ev in events:
            dur = ev.get("dur")
            if ev.get("ph") != "X" or not dur:
                continue
            cat = ev.get("cat")
            if cat in DEVICE_CATEGORIES:
                stream = ev.get("args", {}).get("stream", ev.get("tid"))
                key = (f"stream {stream}", ev["name"])
                device[key] = device.get(key, 0.0) + dur * 1e-6
            elif cat in ("cpu_op", "user_annotation"):
                key = ("host", ev["name"])
                host[key] = host.get(key, 0.0) + dur * 1e-6
    return device or host


def write_device_profile(totals: Dict[Tuple[str, str], float], f) -> None:
    """Write aggregated device times in flamegraph.pl format
    (``line;op microseconds``), largest first (the reference's
    ``--write-device-profile`` output)."""
    for (line, op), secs in sorted(totals.items(), key=lambda kv: -kv[1]):
        us = int(secs * 1e6)
        if us > 0:
            f.write(f"{line};{op} {us}\n")
