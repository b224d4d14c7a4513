"""Which torch device an entry point runs on, and which version of a
kernel runs there.

Every entry point of the port takes ``device=None``, which means the CUDA
device, where its kernels run; there is no fallback to the CPU.  A caller
that wants the kernels' plain PyTorch versions on the CPU (the tests,
``--host``) passes ``device="cpu"``.  Every kernel wrapper asks
:func:`runs_plain` whether to launch its kernel or run its plain
version: CPU tensors always take the plain version, and inside
:func:`plain_versions` CUDA tensors do too (the reference the kernels
are held to on the card).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_plain = contextvars.ContextVar("plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Inside the block every kernel wrapper runs its plain PyTorch
    version, whatever the device; blocks nest.  A context variable: it
    holds in the calling thread only (no worker thread calls a kernel)."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper given ``t`` runs its plain version: ``t``
    is on the CPU, or the call is inside :func:`plain_versions`."""
    return _plain.get() or t.device.type == "cpu"


def resolve(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; None is the CUDA device,
    which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs its kernels on a "
                           "CUDA card (pass device='cpu', or --host, for the "
                           "plain versions on the CPU)")
    return torch.device("cuda")


def select(host: bool) -> torch.device:
    """``--host``: the CPU (the kernels' plain versions); otherwise the
    CUDA device, which must exist."""
    return resolve("cpu" if host else None)
