"""Config base: re-exports LMCfg and provides the generic smoke-reduction.

Each architecture lives in its own module (``repro_torch/configs/<id>.py``)
exposing ``CONFIG`` (the exact published configuration) and ``SMOKE`` (a
reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm import LMCfg  # noqa: F401  (re-export)


def shrink(cfg: LMCfg, **overrides) -> LMCfg:
    """Reduced same-family config: small widths, few layers and experts,
    tiny vocab — the GQA ratio preserved (tinyllama's 32:4 becomes 4:1);
    an attention-free config stays so (mamba2: 8 SSD heads of 32, state
    16, chunk 32); an MoE keeps its period of layers, at most 8 experts of
    64 columns, top-2 and one shared expert; a hybrid one period of
    ``attn_period`` layers; an encoder–decoder 2 + 2 layers, a vlm 16
    patch positions (the reference's ``shrink``)."""
    heads = min(cfg.n_heads, 4)
    kv = max(1, heads * cfg.n_kv_heads // cfg.n_heads) if heads else 0
    if cfg.family == "hybrid":
        n_layers = cfg.attn_period
    else:
        n_layers = max(2, cfg.moe_every if cfg.family == "moe" else 1)
    small = dict(
        n_layers=n_layers,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32 if heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        n_shared=min(cfg.n_shared, 1),
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_dec_layers=2 if cfg.n_dec_layers else 0,
        frontend_len=16 if cfg.frontend_len else 0,
        ssd_headdim=32,
        ssd_state=16,
        ssd_chunk=32,
        loss_chunk=64,
        remat="none",
        dtype="float32",
        param_dtype="float32",
        vocab_pad_multiple=16,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
