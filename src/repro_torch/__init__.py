"""repro_torch — the PyTorch/CUDA port of ``repro``, slice by slice.

Two slices are ported: serving and training of dense decoder LMs
(tinyllama-1.1b) on one NVIDIA H100.  Attention (prefill, its backward,
paged decode) and the fused cross-entropy run in hand-written CUDA kernels
(``repro_torch.kernels``); everything else is plain PyTorch.  The package
imports ``torch`` and ``numpy`` only — never ``jax`` or ``repro``.
"""
