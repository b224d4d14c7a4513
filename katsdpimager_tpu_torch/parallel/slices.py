"""The W-slice loop.

Counterpart of :mod:`katsdpimager_tpu.parallel.slices`, which unrolls
``lax.scan`` over the small, static slice axis.  PyTorch runs eagerly, so
the loop is a Python loop.
"""

from __future__ import annotations


def scan_slices(body, init, xs):
    """``carry = body(carry, [x[s] for x in xs])`` for each slice ``s``
    of the equal leading axes of ``xs``; returns the final carry."""
    carry = init
    for s in range(len(xs[0])):
        carry = body(carry, [x[s] for x in xs])
    return carry
