"""repro_torch — the PyTorch/CUDA port of ``repro`` (Whale), on NVIDIA H100s.

``import repro_torch as wh`` gives the paper's API surface, as ``import
repro as wh`` does: the cluster / replica / split / stage / pipeline /
auto-parallel scopes and ``wh.sub``, the TaskGraph IR, the graph
optimizer, the engine and the cost model (:mod:`repro_torch.core`), and
``model_graph``.

The port serves and trains the dense decoder LMs (tinyllama-1.1b,
qwen3-1.7b, gemma-2b, stablelm-3b), the Mamba2 family (mamba2-1.3b), the
MoE family (deepseek-moe-16b) and the hybrid family (jamba-v0.1-52b),
over data, model and stage axes.
Attention (prefill, its backward, paged decode), the fused cross-entropy,
the SSD scan and the int8 quantizer run in hand-written CUDA kernels
(``repro_torch.kernels``), built on their first launch; everything else
is plain PyTorch.  The package imports ``torch`` and ``numpy`` only —
never ``jax`` or ``repro``.
"""
from repro_torch.core import *  # noqa: F401,F403
from repro_torch.models.lm import model_graph  # noqa: F401  (segment-aware meta)
