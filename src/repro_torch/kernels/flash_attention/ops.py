"""The differentiable flash attention op: a ``torch.autograd.Function``
over the forward and backward kernels.

Mirrors ``repro/kernels/flash_attention/ops.py::flash`` (a
``jax.custom_vjp``).  Residual policy follows the stack's
``attn_bwd_remat`` flag:

- ``bwd_remat=True``: save only (q, k, v, lse) and re-run the forward
  kernel in the backward to rebuild ``o`` for δ = rowsum(do∘o);
- ``bwd_remat=False``: save ``o`` too and skip that forward launch.

Either way no (Sq, Sk) matrix is stored: both backward kernels rebuild
score tiles from (q, k, lse).  On CPU tensors every step runs the plain
versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash import (flash_attention,
                                                       flash_attention_bwd)


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, bwd_remat: bool):
        out, lse = flash_attention(q, k, v, causal)
        ctx.causal, ctx.bwd_remat = causal, bwd_remat
        if bwd_remat:
            ctx.save_for_backward(q, k, v, lse)
        else:
            ctx.save_for_backward(q, k, v, lse, out)
        return out

    @staticmethod
    def backward(ctx, do):
        if ctx.bwd_remat:
            q, k, v, lse = ctx.saved_tensors
            out, _ = flash_attention(q, k, v, ctx.causal)
        else:
            q, k, v, lse, out = ctx.saved_tensors
        B, Sq, H, D = q.shape
        K = k.shape[2]
        # δ_i = Σ_d do_i·o_i: a cheap reduction, laid out like lse
        delta = (do.float() * out.float()).sum(-1).reshape(B, Sq, K, H // K)
        # autograd may hand over a strided cotangent; the kernels want rows
        dq, dk, dv = flash_attention_bwd(q, k, v, do.contiguous(), lse,
                                         delta.contiguous(), ctx.causal)
        return dq, dk, dv, None, None


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool = True, bwd_remat: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, K, D) → (B, Sq, H, D).
    Differentiable: forward and backward both run the flash kernels."""
    return _Flash.apply(q, k, v, causal, bwd_remat)
