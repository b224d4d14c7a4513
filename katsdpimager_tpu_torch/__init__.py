"""katsdpimager_tpu_torch: the imager's PyTorch/CUDA port for NVIDIA Hopper.

A second package beside :mod:`katsdpimager_tpu` (the JAX reference, which
it is tested against).  Plain tensor code is PyTorch; every kernel that
the JAX package wrote in Pallas is a hand-written CUDA C++ kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`.ops._build`).  Each kernel wrapper launches its kernel for CUDA
tensors and runs the kernel's plain PyTorch version for CPU tensors.

The package imports no JAX.  It reuses the JAX package's framework-free
modules (``parameters``, ``polarization``, ``units``, ``ops.wkernel``,
``native``) as they are.
"""

__version__ = "0.1.0"
