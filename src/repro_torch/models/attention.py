"""Attention for the dense LM: prefill and training (the differentiable
flash op), dense-cache decode and paged-cache decode (paged kernel).

Grouped-query attention in the grouped layout: q heads ``h = k·G + g``
over K kv heads, so KV is never repeated per query head.

Under sharding rules that split the heads over the model axis
(:mod:`repro_torch.core.sharding`), training attention is head-parallel:
the leaves are this rank's heads (their counts read off the leaf shapes),
the input's gradient and the output after ``wo`` are summed over the
split's group.  :func:`choose_layout` is the reference's: ``grouped`` when
the kv heads divide the axis; ``repeat`` when only the q heads do, where
``wk``/``wv`` stay whole on every rank and each rank keeps the kv heads of
its q-head groups (the flash kernel still sees whole GQA groups), their
gradient summed over the group; ``seq`` (context parallelism) raises.
The decode paths run unsplit (serving over a mesh waits for its slice).

Where the reference returns new KV arrays, the port writes the caches and
page pools in place (saving a copy of the whole cache per step) and
returns the same tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sharding
from repro_torch.kernels.flash_attention import paged_decode
from repro_torch.kernels.flash_attention.ops import flash
from repro_torch.models import layers

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads


def init_attention(gen, cfg: AttnCfg, dtype, device, lead: tuple = ()) -> dict:
    E, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": layers.dense_init(gen, E, lead + (E, H, D), dtype, device),
        "wk": layers.dense_init(gen, E, lead + (E, K, D), dtype, device),
        "wv": layers.dense_init(gen, E, lead + (E, K, D), dtype, device),
        "wo": layers.dense_init(gen, H * D, lead + (H, D, E), dtype, device),
    }


def axes_attention() -> dict:
    return {"wq": ("embed", "q_heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("q_heads", "head_dim", "embed")}


LAYOUT_SLICE = ("the 'seq' attention layout (context parallelism, where "
                "neither head count divides the model axis) comes with a "
                "later slice of the port (ROADMAP.md queue A item 4)")


def choose_layout(cfg: AttnCfg) -> str:
    """``grouped`` / ``repeat`` / ``seq`` under the active rules, as the
    reference picks (see the module doc); ``grouped`` without rules."""
    rules = sharding.current_rules()
    if rules is None:
        return "grouped"
    tp = rules.axis_size(rules.rules.get("kv_heads"))
    if cfg.n_kv_heads % tp == 0:
        return "grouped"
    if cfg.n_heads % tp == 0:
        return "repeat"
    return "seq"


def _own_kv(w: torch.Tensor, split, cfg: AttnCfg) -> torch.Tensor:
    """``repeat``: the whole (E, K, D) ``wk`` or ``wv`` → the kv heads of
    this rank's q heads (the reference's KV repeated to the q heads and
    split with them).  Where this rank's q heads lie in one group, that
    group's kv head; where a group straddles two ranks, one kv head per q
    head.  The gradient of the whole leaf is summed over the split's
    group."""
    hl = cfg.n_heads // split.n
    h0 = split.index * hl
    w = sharding.copy_to(w, split)
    G = cfg.group
    if G % hl == 0:
        return w[:, h0 // G:h0 // G + 1]
    return w[:, [(h0 + j) // G for j in range(hl)]]


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: AttnCfg, *, return_kv: bool = False,
              bwd_remat: bool = False):
    """x: (B, S, E) → (B, S, E); optionally also the roped (B, S, K, D) k
    and v.  The score/softmax/value core is :func:`ops.flash` — the flash
    kernels forward and backward, so prefill and training share it;
    ``bwd_remat`` is its residual policy.  Head-parallel where the rules
    split ``q_heads`` (the module doc)."""
    B, S, E = x.shape
    layout = choose_layout(cfg)
    if layout == "seq":
        raise NotImplementedError(LAYOUT_SLICE)
    split = sharding.split_of("q_heads", cfg.n_heads)
    wk, wv = params["wk"], params["wv"]
    if split is not None:
        if layout == "repeat":
            wk, wv = _own_kv(wk, split, cfg), _own_kv(wv, split, cfg)
        x = sharding.copy_to(x, split)
    q = torch.einsum("bse,ehd->bshd", x, params["wq"].to(x.dtype))
    k = torch.einsum("bse,ekd->bskd", x, wk.to(x.dtype))
    v = torch.einsum("bse,ekd->bskd", x, wv.to(x.dtype))
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = flash(q.contiguous(), k.contiguous(), v.contiguous(), cfg.causal,
                bwd_remat)
    y = torch.einsum("bshd,hde->bse", out.to(x.dtype),
                     params["wo"].to(x.dtype))
    y = sharding.reduce_from(y, split)
    return (y, (k, v)) if return_kv else y


# ---------------------------------------------------------------------------
# decode (one token per sequence)
# ---------------------------------------------------------------------------

def _decode_qkv(params: dict, x: torch.Tensor, pos: torch.Tensor,
                cfg: AttnCfg):
    """x (B, E) → q (B, H, D), k/v (B, K, D), q and k roped at ``pos``.
    Shared by the dense and paged decode paths."""
    q = torch.einsum("be,ehd->bhd", x, params["wq"].to(x.dtype))
    k = torch.einsum("be,ekd->bkd", x, params["wk"].to(x.dtype))
    v = torch.einsum("be,ekd->bkd", x, params["wv"].to(x.dtype))
    posb = pos[:, None]
    q = layers.apply_rope(q[:, None], posb, cfg.rope_theta)[:, 0]
    k = layers.apply_rope(k[:, None], posb, cfg.rope_theta)[:, 0]
    return q, k, v


def decode_attention(params: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, cfg: AttnCfg,
                     k_sc=None, v_sc=None):
    """x: (B, E); k_cache/v_cache: (B, Smax, K, D); pos: (B,) — the index
    the new KV is written at.  Returns (y (B, E), k_cache, v_cache), the
    caches updated in place.

    The write ADDs the new KV into the cell (zero by the server's
    invariant), as the reference's one-hot add does; a ``pos`` past the
    cache writes nothing.  Plain PyTorch: the reference has no kernel here.
    """
    if k_sc is not None or v_sc is not None:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    B, E = x.shape
    K, G, D = cfg.n_kv_heads, cfg.group, cfg.head_dim
    Smax = k_cache.shape[1]

    q, k, v = _decode_qkv(params, x, pos, cfg)
    live = (pos < Smax)[:, None, None]
    cell = (torch.arange(B, device=x.device), pos.long().clamp(max=Smax - 1))
    k_cache.index_put_(cell, torch.where(live, k, 0).to(k_cache.dtype),
                       accumulate=True)
    v_cache.index_put_(cell, torch.where(live, v, 0).to(v_cache.dtype),
                       accumulate=True)

    qg = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * (D ** -0.5)
    valid = (torch.arange(Smax, device=x.device)[None, :]
             <= pos.long()[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    # p rounds to the cache dtype before the value product, as in the reference
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = (out / l.clamp_min(1e-30)).to(x.dtype).reshape(B, cfg.n_heads, D)
    y = torch.einsum("bhd,hde->be", out, params["wo"].to(x.dtype))
    return y, k_cache, v_cache


# ---------------------------------------------------------------------------
# paged decode (block/paged KV cache)
# ---------------------------------------------------------------------------

def paged_scatter(pool: torch.Tensor, block_table: torch.Tensor,
                  pos: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, K, D) into the pool cell each slot's ``pos`` maps to
    through its block table, in place; returns ``pool``.

    pool: (P, page_size, K, D); block_table: (B, max_pages) int32 (0 = the
    reserved trash page); pos: (B,).  An ADD, like the reference's one-hot
    outer product, into a cell that is zero by the allocator invariant —
    but writes that resolve to the trash page (inactive slots, unallocated
    entries) or past the table are dropped, keeping page 0 all-zero.
    """
    ps = pool.shape[1]
    mp = block_table.shape[1]
    page_idx = pos.long() // ps
    phys = torch.gather(block_table.long(), 1,
                        page_idx.clamp(max=mp - 1)[:, None])[:, 0]
    live = ((phys != 0) & (page_idx < mp))[:, None, None]
    pool.index_put_((phys, pos.long() % ps),
                    torch.where(live, new, 0).to(pool.dtype), accumulate=True)
    return pool


def paged_decode_attention(params: dict, x: torch.Tensor,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_table: torch.Tensor, pos: torch.Tensor,
                           cfg: AttnCfg):
    """Decode step against a paged KV cache: scatter the new KV into the
    pools first, then attend through the block table with the paged
    kernel.  x: (B, E); pools: (P, page_size, K, D); block_table:
    (B, max_pages) int32; pos: (B,) int32.  Returns (y, k_pool, v_pool),
    the pools updated in place."""
    q, k_new, v_new = _decode_qkv(params, x, pos, cfg)
    paged_scatter(k_pool, block_table, pos, k_new)
    paged_scatter(v_pool, block_table, pos, v_new)
    out = paged_decode(q.contiguous(), k_pool, v_pool, block_table, pos)
    y = torch.einsum("bhd,hde->be", out.to(x.dtype), params["wo"].to(x.dtype))
    return y, k_pool, v_pool
