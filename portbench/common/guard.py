"""The import guard: the benchmark never loads JAX or the JAX package.

A module is judged by its top-level name, the part before the first dot,
compared whole: ``katsdpimager_tpu_torch`` (the port, measured) begins
with ``katsdpimager_tpu`` (the JAX package, never loaded) and is not it.
"""

from __future__ import annotations

import sys

#: Top-level names that no process of the benchmark may load.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "katsdpimager_tpu"})

#: What the reference may not load besides: the program itself.
PROGRAM = "katsdpimager_tpu_torch"


def top_level(names) -> set:
    """The top-level names of dotted module names."""
    return {name.split(".", 1)[0] for name in names}


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list:
    """The forbidden top-level names among ``modules`` (default: those
    loaded in this process), sorted."""
    names = sys.modules.keys() if modules is None else modules
    return sorted(top_level(names) & set(forbidden))
