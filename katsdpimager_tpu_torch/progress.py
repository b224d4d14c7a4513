"""Progress reporting: TTY-aware progress bars and step contexts (parity
with reference ``progress.py``), with no external dependency.

The port's own copy of :mod:`katsdpimager_tpu.progress` (host code, no kernel); the
port imports nothing of the JAX package."""

from __future__ import annotations

import contextlib
import sys
import time


class ProgressBar:
    def __init__(self, label: str, max: int = 100, stream=None):
        self.label = label
        self.max = max(1, int(max)) if not isinstance(max, int) or max <= 0 else max
        self.value = 0
        self.stream = stream if stream is not None else sys.stderr
        self._isatty = hasattr(self.stream, "isatty") and self.stream.isatty()
        self._last_render = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()

    def next(self, n: int = 1):
        self.value += n
        self._render()

    def goto(self, value: int):
        self.value = value
        self._render()

    def iter(self, iterable):
        for item in iterable:
            yield item
            self.next()

    def _render(self, force=False):
        if not self._isatty:
            return
        now = time.monotonic()
        if not force and now - self._last_render < 0.1:
            return
        self._last_render = now
        frac = min(1.0, self.value / self.max)
        width = 30
        filled = int(width * frac)
        bar = "#" * filled + "-" * (width - filled)
        self.stream.write(f"\r{self.label}: [{bar}] {frac * 100:5.1f}%")
        self.stream.flush()

    def finish(self):
        if self._isatty:
            self._render(force=True)
            self.stream.write("\n")
            self.stream.flush()


def make_progressbar(label: str, max: int = 100) -> ProgressBar:
    return ProgressBar(label, max=max)


@contextlib.contextmanager
def step(label: str):
    """Context manager reporting a single long-running step."""
    bar = ProgressBar(label, max=1)
    try:
        yield
    finally:
        bar.value = 1
        bar.finish()
