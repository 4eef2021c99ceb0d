"""The layer stack of the dense decoder: a pattern of blocks repeated
``n_rep`` times, parameters stacked on a leading ``layers`` dim as in
``repro.models.transformer`` (so the two packages share leaf shapes).
The reference's ``lax.scan`` over repeats is a Python loop here.

Each block: pre-norm attention + pre-norm gated MLP, residual connections.
Only the dense pattern (attention + MLP) is ported so far.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.attention import AttnCfg


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    d_model: int
    attn: AttnCfg
    d_ff: int


@dataclasses.dataclass(frozen=True)
class StackCfg:
    pattern: tuple                        # tuple[BlockCfg, ...]
    n_rep: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_rep


def _layer(tree: dict, r: int) -> dict:
    """Repeat ``r``'s slice of a stacked tree (views, no copies)."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_block(gen, cfg: BlockCfg, dtype, device, lead: tuple = ()) -> dict:
    return {
        "norm1": layers.init_rmsnorm(lead + (cfg.d_model,), dtype, device),
        "attn": attn_mod.init_attention(gen, cfg.attn, dtype, device, lead),
        "norm2": layers.init_rmsnorm(lead + (cfg.d_model,), dtype, device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                               lead),
    }


def init_stack(gen, stack: StackCfg, dtype, device) -> dict:
    return {f"p{i}": init_block(gen, bcfg, dtype, device, (stack.n_rep,))
            for i, bcfg in enumerate(stack.pattern)}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def apply_block(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: BlockCfg, *, return_kv: bool = False):
    """x: (B, S, E) → (x', kv-or-None).  Forward only."""
    h = layers.rmsnorm(params["norm1"], x)
    out = attn_mod.attention(params["attn"], h, positions, cfg.attn,
                             return_kv=return_kv)
    kv = None
    if return_kv:
        out, kv = out
    x = x + out
    x = x + layers.mlp(params["mlp"], layers.rmsnorm(params["norm2"], x))
    return x, kv


def prefill_stack(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  stack: StackCfg):
    """Forward returning per-block KV caches ``{"p<i>": {"k", "v"}}`` of
    shape (n_rep, B, S, K, D) for subsequent decode."""
    kvs = {f"p{i}": {"k": [], "v": []} for i in range(len(stack.pattern))}
    for r in range(stack.n_rep):
        for i, bcfg in enumerate(stack.pattern):
            x, (k, v) = apply_block(_layer(params[f"p{i}"], r), x, positions,
                                    bcfg, return_kv=True)
            kvs[f"p{i}"]["k"].append(k)
            kvs[f"p{i}"]["v"].append(v)
    caches = {name: {key: torch.stack(vals) for key, vals in kv.items()}
              for name, kv in kvs.items()}
    return x, caches


# ---------------------------------------------------------------------------
# dense-cache decode
# ---------------------------------------------------------------------------

def decode_block(params: dict, x: torch.Tensor, state: dict,
                 pos: torch.Tensor, cfg: BlockCfg):
    """x: (B, E) one token; state: this block's {"k", "v"} cache, written
    in place."""
    h = layers.rmsnorm(params["norm1"], x)
    out, _, _ = attn_mod.decode_attention(params["attn"], h, state["k"],
                                          state["v"], pos, cfg.attn)
    x = x + out
    return x + layers.mlp(params["mlp"], layers.rmsnorm(params["norm2"], x))


def init_stack_state(stack: StackCfg, batch: int, max_len: int, dtype,
                     device) -> dict:
    state = {}
    for i, bcfg in enumerate(stack.pattern):
        a = bcfg.attn
        shape = (stack.n_rep, batch, max_len, a.n_kv_heads, a.head_dim)
        state[f"p{i}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
    return state


def decode_stack(params: dict, x: torch.Tensor, state: dict,
                 pos: torch.Tensor, stack: StackCfg):
    """x: (B, E) → (x', state), the caches in ``state`` written in place."""
    for r in range(stack.n_rep):
        for i, bcfg in enumerate(stack.pattern):
            x = decode_block(_layer(params[f"p{i}"], r), x,
                             _layer(state[f"p{i}"], r), pos, bcfg)
    return x, state


# ---------------------------------------------------------------------------
# paged decode (block/paged KV cache)
# ---------------------------------------------------------------------------

def init_paged_stack_state(stack: StackCfg, n_pages: int, page_size: int,
                           dtype, device) -> dict:
    """Per-pattern-position page pools ``(n_rep, n_pages, page_size, K, D)``,
    shared by every decode slot through its block-table row."""
    pools = {}
    for i, bcfg in enumerate(stack.pattern):
        a = bcfg.attn
        shape = (stack.n_rep, n_pages, page_size, a.n_kv_heads, a.head_dim)
        pools[f"p{i}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
    return pools


def paged_decode_block(params: dict, x: torch.Tensor, pools: dict,
                       block_table: torch.Tensor, pos: torch.Tensor,
                       cfg: BlockCfg):
    """Paged twin of :func:`decode_block`; ``pools`` written in place."""
    h = layers.rmsnorm(params["norm1"], x)
    out, _, _ = attn_mod.paged_decode_attention(
        params["attn"], h, pools["k"], pools["v"], block_table, pos, cfg.attn)
    x = x + out
    return x + layers.mlp(params["mlp"], layers.rmsnorm(params["norm2"], x))


def decode_stack_paged(params: dict, x: torch.Tensor, pools: dict,
                       block_table: torch.Tensor, pos: torch.Tensor,
                       stack: StackCfg):
    """x: (B, E) → (x', pools).  :func:`decode_stack` against page pools;
    the block table and positions are shared by every layer."""
    for r in range(stack.n_rep):
        for i, bcfg in enumerate(stack.pattern):
            x = paged_decode_block(_layer(params[f"p{i}"], r), x,
                                   _layer(pools[f"p{i}"], r), block_table,
                                   pos, bcfg)
    return x, pools
