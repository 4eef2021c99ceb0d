"""The differentiable fused cross-entropy: ``torch.autograd.Function``s
over the forward kernel, with the reference's analytic backward.

Mirrors ``repro/kernels/xent/ops.py`` (``xent`` and ``xent_with_lse``,
``jax.custom_vjp``s).  With g = (g_nll, g_lse), the backward recomputes the
logits one vocab chunk at a time (the saved residual is ``lse``, not the
(T, V) logits) and per chunk:

    logits = h·W_c                     f32 matmul
    d      = g_nll·(p − onehot) + g_lse·p    the fused pass (xent_bwd)
    dh    += d·W_cᵀ,   dW_c = hᵀ·d     f32 matmuls

The three products are plain matmuls, as in the reference (left to XLA
there); with TF32 off (PyTorch's default) they run in full f32, as the
reference computes them.  Only one f32 (T, chunk) tile is ever live
(:func:`.xent.bwd_chunk`), so the loss head never materialises (T, V).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.xent.xent import bwd_chunk, xent_bwd, xent_fwd


def _bwd(hidden, head_w, labels, lse, g_nll, g_lse, vocab):
    T, E = hidden.shape
    V = head_w.shape[1]
    vocab = V if vocab is None else vocab
    hf = hidden.float()
    g_nll = g_nll.float().contiguous()
    g_lse = g_lse.float().contiguous()
    dh = torch.zeros((T, E), dtype=torch.float32, device=hidden.device)
    dw = torch.empty((E, V), dtype=torch.float32, device=hidden.device)
    chunk = bwd_chunk(T, V)
    for c0 in range(0, V, chunk):
        w_c = head_w[:, c0:c0 + chunk].float()               # (E, C)
        d = xent_bwd(hf @ w_c, lse, labels, g_nll, g_lse, c0, vocab)
        dh.addmm_(d, w_c.t())
        dw[:, c0:c0 + chunk] = hf.t() @ d
    return dh.to(hidden.dtype), dw.to(head_w.dtype)


class _Xent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, head_w, labels, vocab, with_lse: bool):
        labels = labels.to(torch.int32).contiguous()
        nll, lse = xent_fwd(hidden, head_w, labels, vocab)
        ctx.save_for_backward(hidden, head_w, labels, lse)
        ctx.vocab, ctx.with_lse = vocab, with_lse
        return (nll, lse) if with_lse else nll

    @staticmethod
    def backward(ctx, g_nll, g_lse=None):
        hidden, head_w, labels, lse = ctx.saved_tensors
        if g_lse is None:
            g_lse = torch.zeros_like(lse)
        dh, dw = _bwd(hidden, head_w, labels, lse, g_nll, g_lse, ctx.vocab)
        return dh, dw, None, None, None


def xent(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
         vocab: int | None = None) -> torch.Tensor:
    """hidden (T, E), head_w (E, V), labels (T,) → nll (T,) f32."""
    return _Xent.apply(hidden, head_w, labels, vocab, False)


def xent_with_lse(hidden: torch.Tensor, head_w: torch.Tensor,
                  labels: torch.Tensor, vocab: int | None = None):
    """Like :func:`xent` but also returns lse (T,), differentiably: the
    z-loss term differentiates through the same backward, with
    d logits = g_nll·(softmax − onehot) + g_lse·softmax."""
    return _Xent.apply(hidden, head_w, labels, vocab, True)
