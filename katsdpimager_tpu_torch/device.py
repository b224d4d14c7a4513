"""Which torch device an entry point runs on.

Every entry point of the port takes ``device=None``, which means the CUDA
device, where its kernels run; there is no fallback to the CPU.  A caller
that wants the kernels' plain PyTorch versions on the CPU (the tests,
``--host``) passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


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
