"""repro_torch — the PyTorch/CUDA port of ``repro``, slice by slice.

Ported so far: serving and training of dense decoder LMs (tinyllama-1.1b),
serving of the Mamba2 family (mamba2-1.3b), and data-parallel training
over a ``pod × data`` mesh with int8 cross-pod gradient compression, on
NVIDIA H100s.  Attention (prefill, its backward, paged decode), the fused
cross-entropy, the SSD scan and the int8 quantizer run in hand-written
CUDA kernels (``repro_torch.kernels``); everything else is plain PyTorch.
The package imports ``torch`` and ``numpy`` only — never ``jax`` or
``repro``.
"""
