"""repro_torch — the PyTorch/CUDA port of ``repro``, slice by slice.

The first slice serves dense decoder LMs (tinyllama-1.1b) on one NVIDIA
H100: prefill attention and paged decode run in hand-written CUDA kernels
(``repro_torch.kernels``); everything else is plain PyTorch.  The package
imports ``torch`` and ``numpy`` only — never ``jax`` or ``repro``.
"""
