"""Argument round-tripping for provenance (parity with reference
``arguments.py``): track which options differ from their defaults and
reconstruct a canonical command line for FITS HISTORY headers.

The port's own copy of :mod:`katsdpimager_tpu.arguments` (host code, no kernel); the
port imports nothing of the JAX package."""

from __future__ import annotations

import argparse
from typing import Iterable, List


class SmartNamespace(argparse.Namespace):
    """Namespace that records which attributes were set to a *different*
    value after their default (reference arguments.py:9-34 semantics).

    Value comparison rather than set counting matters: argparse sets
    string-typed defaults twice (once up front, once through ``type``
    conversion at the end of parsing), which a set counter would
    misreport as changed."""

    def __init__(self, **kwargs):
        self.__dict__["_is_changed"] = set()
        super().__init__(**kwargs)

    def __setattr__(self, name, value):
        if (not name.startswith("_") and name in self
                and getattr(self, name) != value):
            self.__dict__["_is_changed"].add(name)
        super().__setattr__(name, value)

    def changed(self, name) -> bool:
        return name in self.__dict__["_is_changed"]


def _format_value(value) -> List[str]:
    if isinstance(value, bool):
        return []
    if isinstance(value, (list, tuple)):
        return [",".join(str(v) for v in value)]
    return [str(value)]


def unparse_args(args: SmartNamespace, exclude: Iterable[str] = (),
                 arg_handlers=None) -> List[str]:
    """Reconstruct command-line arguments for options changed from default."""
    arg_handlers = arg_handlers or {}
    exclude = set(exclude)
    out: List[str] = []
    for name in sorted(vars(args)):
        if name.startswith("_") or name in exclude:
            continue
        if not args.changed(name):
            continue
        value = getattr(args, name)
        flag = "--" + name.replace("_", "-")
        if name in arg_handlers:
            out.extend(arg_handlers[name](name, value))
        elif isinstance(value, bool):
            out.append(flag if value else "--no-" + name.replace("_", "-"))
        elif value is not None:
            formatted = _format_value(value)
            out.append(flag + "=" + formatted[0] if formatted else flag)
    return out
