"""Named ranges around the frontend's stages.

Counterpart of the ``profile`` context and the ``profile_function``
decorator of :mod:`katsdpimager_tpu.profiling`, on top of
:func:`torch.profiler.record_function`: under ``torch.profiler`` each
range shows as a named span around the host calls and the device work
they enqueue.  Outside a profiler a range costs one small host call.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def profile(name: str):
    """A named range (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


def profile_function(fn):
    """Decorator applying :func:`profile` around each call of ``fn``,
    named after the function."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with profile(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper
