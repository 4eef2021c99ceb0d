"""The modality frontends' stub, as ``repro.models.frontends``: the vision
(qwen2-vl) and audio (seamless) towers are not modelled; the batch carries
their precomputed embeddings, (B, P, D) patch embeddings or (B, S_src, D)
frame embeddings, and one trainable linear adapter maps them into the
backbone, so the frontend takes part in the parameters and their layout.

:func:`mrope_positions` gives qwen2-vl's (B, 3, S) M-RoPE positions: a
(t, h, w) grid over the patch prefix, then the text continuing after it.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers


def init_adapter(gen, d_model: int, dtype, device) -> dict:
    return {"w": layers.dense_init(gen, d_model, (d_model, d_model), dtype,
                                   device),
            "b": torch.zeros((d_model,), dtype=dtype, device=device)}


def axes_adapter() -> dict:
    return {"w": ("embed", None), "b": (None,)}


def adapt(params: dict, embeds: torch.Tensor) -> torch.Tensor:
    """``embeds @ w + b``, the weights cast to the embeddings' dtype."""
    return embeds @ params["w"].to(embeds.dtype) \
        + params["b"].to(embeds.dtype)


def mrope_positions(batch: int, seq: int, n_patches: int,
                    grid: int | None = None, device=None) -> torch.Tensor:
    """qwen2-vl's (B, 3, S) int64 positions: over the first ``n_patches``
    positions t = 0 and (h, w) the row and column of a ``grid``-wide grid
    (default the square root of ``n_patches``); the text after them at
    ``index − n_patches + n_patches // grid`` in all three components (the
    reference's continuation after the largest grid row).  ``n_patches``
    0 is plain positions in all three.  A sequence shorter than the patch
    prefix raises ``ValueError`` (the reference fails on it inside a
    broadcast)."""
    if n_patches == 0:
        p = torch.arange(seq, device=device)
        return p[None, None].expand(batch, 3, seq)
    if seq < n_patches:
        raise ValueError(f"a sequence of {seq} positions is shorter than "
                         f"the {n_patches}-position patch prefix (M-RoPE "
                         f"needs seq >= frontend_len)")
    g = grid or max(int(n_patches ** 0.5), 1)
    idx = torch.arange(n_patches, device=device)
    text = torch.arange(seq - n_patches, device=device) + n_patches // g
    pos3 = torch.stack([torch.cat([torch.zeros_like(idx), text]),
                        torch.cat([idx // g, text]),
                        torch.cat([idx % g, text])])           # (3, S)
    return pos3[None].expand(batch, 3, seq)
