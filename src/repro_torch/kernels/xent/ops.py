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

:func:`xent_vocab_shard` is the loss head on one rank's column shard
``W[:, c0:c0+Vs]`` of a vocab-parallel head (the paper's Fig-4 split
softmax), over the same two kernels unchanged: the forward kernel runs on
the shard with the labels shifted by ``-c0`` (a label outside the shard
finds no target column, so the shard's nll is its lse) and the shards'
(lse, target logit) pairs are all-gathered and combined; the backward
runs the chunk loop on the shard with the global lse, ``col0 = c0 +
chunk offset`` and the global ``vocab``, then all-reduces ``dh``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import sharding
from repro_torch.kernels.xent.xent import (NEG_INF, bwd_chunk, xent_bwd,
                                           xent_fwd)


def _bwd(hidden, head_w, labels, lse, g_nll, g_lse, vocab, c0: int = 0):
    """(dh in f32, dW) of the head's columns ``[c0, c0 + V)``; ``labels``
    and ``vocab`` count columns of the whole head."""
    T, E = hidden.shape
    V = head_w.shape[1]
    vocab = V if vocab is None else vocab
    hf = hidden.float()
    g_nll = g_nll.float().contiguous()
    g_lse = g_lse.float().contiguous()
    dh = torch.zeros((T, E), dtype=torch.float32, device=hidden.device)
    dw = torch.empty((E, V), dtype=torch.float32, device=hidden.device)
    chunk = bwd_chunk(T, V)
    for j in range(0, V, chunk):
        w_c = head_w[:, j:j + chunk].float()                 # (E, C)
        d = xent_bwd(hf @ w_c, lse, labels, g_nll, g_lse, c0 + j, vocab)
        dh.addmm_(d, w_c.t())
        dw[:, j:j + chunk] = hf.t() @ d
    return dh, dw.to(head_w.dtype)


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
        return dh.to(hidden.dtype), dw, None, None, None


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


class _XentShard(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, w_s, labels, c0: int, vocab: int, group):
        Vs = w_s.shape[1]
        labels = labels.to(torch.int32).contiguous()
        local = (labels - c0).to(torch.int32)
        live = max(0, min(vocab - c0, Vs))
        if live:
            nll_s, lse_s = xent_fwd(hidden, w_s, local, live)
        else:                        # a shard of padding columns only
            lse_s = torch.full(labels.shape, NEG_INF, dtype=torch.float32,
                               device=hidden.device)
            nll_s = lse_s
        own = (local >= 0) & (local < Vs)
        tgt_s = torch.where(own, lse_s - nll_s, torch.zeros_like(lse_s))
        both = sharding.gather_cat(torch.stack([lse_s, tgt_s])[None], group,
                                   0)
        lse = torch.logsumexp(both[:, 0], dim=0)
        nll = lse - both[:, 1].sum(0)
        ctx.save_for_backward(hidden, w_s, labels, lse)
        ctx.c0, ctx.vocab, ctx.group = c0, vocab, group
        return nll, lse

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        hidden, w_s, labels, lse = ctx.saved_tensors
        dh, dw = _bwd(hidden, w_s, labels, lse, g_nll, g_lse, ctx.vocab,
                      ctx.c0)
        dist.all_reduce(dh, op=dist.ReduceOp.SUM, group=ctx.group)
        return dh.to(hidden.dtype), dw, None, None, None, None


def xent_vocab_shard(hidden: torch.Tensor, w_s: torch.Tensor,
                     labels: torch.Tensor, c0: int, vocab: int, group):
    """The vocab-parallel :func:`xent_with_lse`: hidden (T, E) the same on
    every rank of ``group``, ``w_s`` (E, Vs) this rank's columns ``[c0,
    c0 + Vs)`` of the head, labels (T,) and ``vocab`` (the live columns)
    of the whole head → (nll, lse) (T,) f32 of the whole head, the same on
    every rank; differentiable, ``dh`` summed over the group."""
    return _XentShard.apply(hidden, w_s, labels, c0, vocab, group)
