"""Fused vocab-tiled softmax cross-entropy: CUDA kernels (forward, and the
backward's elementwise pass) with their plain PyTorch versions, and the
differentiable ops (``ops.xent``, ``ops.xent_with_lse``)."""
from repro_torch.kernels.xent.ops import xent_with_lse  # noqa: F401
from repro_torch.kernels.xent.xent import (  # noqa: F401
    xent_bwd, xent_bwd_plain, xent_fwd, xent_fwd_plain)
