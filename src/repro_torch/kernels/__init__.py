"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

Every kernel sits beside its plain PyTorch version in the same module.  A
wrapper runs the plain version for CPU tensors and launches the kernel for
CUDA tensors, counting each launch on the wrapper (``fn.launches``).  The
CUDA sources in ``csrc/`` are compiled at first use by :mod:`.build`.
"""
