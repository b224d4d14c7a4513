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
import functools
import os

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


@functools.lru_cache(maxsize=None)
def _card_memory(index: int) -> int:
    """The bytes CUDA card ``index`` had free when this process first
    asked, plus what PyTorch's caching allocator had reserved then: read
    once a process, since ``cudaMemGetInfo`` waits for the device."""
    free, _ = torch.cuda.mem_get_info(index)
    return free + torch.cuda.memory_reserved(index)


def free_memory(device) -> int:
    """Bytes a new allocation on ``device`` could take now.  On a CUDA
    device: what the card had free when this process first asked, and
    what PyTorch's caching allocator had reserved then
    (:func:`_card_memory`), less what it holds allocated now, so that
    only the first call waits for the device (what other processes take
    later is not seen).  On the CPU the free physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        index = (torch.cuda.current_device() if device.index is None
                 else device.index)
        return _card_memory(index) - torch.cuda.memory_allocated(index)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
