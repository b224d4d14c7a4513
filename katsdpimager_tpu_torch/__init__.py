"""katsdpimager_tpu_torch: the imager's PyTorch/CUDA port for NVIDIA Hopper.

A second package beside :mod:`katsdpimager_tpu` (the JAX reference, which
it is tested against).  Plain tensor code is PyTorch; every kernel that
the JAX package wrote in Pallas is a hand-written CUDA C++ kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`.ops._build`).  Each kernel wrapper launches its kernel for CUDA
tensors and runs the kernel's plain PyTorch version for CPU tensors, or
for any tensor inside :func:`.device.plain_versions`.

The package imports no JAX and nothing of the JAX package.  Its host
modules (``units``, ``polarization``, ``parameters``, ``arguments``,
``progress``, ``io``, ``sky_model``, ``primary_beam``, ``ephem``, the
loaders, ``simulate``, ``ops.wkernel`` and ``native``) are its own copies
of the JAX package's framework-free ones, under the same names; the C++
preprocessing core builds at first use into ``_build/native/``.  Its entry
points run on the CUDA device unless the caller passes ``device="cpu"``
(:mod:`.device`).
"""

__version__ = "0.1.0"
