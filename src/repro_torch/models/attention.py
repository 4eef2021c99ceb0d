"""Attention for the LM: prefill and training (the differentiable flash
op), the encoder–decoder's cross-attention (the same op, non-causal over
the encoder's memory), dense-cache decode and paged-cache decode (paged
kernel).  RoPE, or qwen2-vl's M-RoPE over (B, 3, S) positions.

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
Decode is head-parallel in the ``grouped`` layout (:func:`decode_split`):
the paged path on this rank's kv heads, the dense path on its heads or,
where the cache's sequence is split, over its rows with the softmax
merged across ranks (:func:`decode_attention`).

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
    qk_norm: bool = False               # per-head RMSNorm of q and k (qwen3)
    mrope_sections: tuple | None = None   # M-RoPE bands (qwen2-vl)

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads


def init_attention(gen, cfg: AttnCfg, dtype, device, lead: tuple = ()) -> dict:
    E, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": layers.dense_init(gen, E, lead + (E, H, D), dtype, device),
        "wk": layers.dense_init(gen, E, lead + (E, K, D), dtype, device),
        "wv": layers.dense_init(gen, E, lead + (E, K, D), dtype, device),
        "wo": layers.dense_init(gen, H * D, lead + (H, D, E), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(lead + (D,), dtype, device)
        p["k_norm"] = layers.init_rmsnorm(lead + (D,), dtype, device)
    return p


def axes_attention(cfg: AttnCfg) -> dict:
    a = {"wq": ("embed", "q_heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("q_heads", "head_dim", "embed")}
    if cfg.qk_norm:
        a["q_norm"] = {"scale": ("head_dim",)}
        a["k_norm"] = {"scale": ("head_dim",)}
    return a


def _qk_norm(params: dict, q: torch.Tensor, k: torch.Tensor, cfg: AttnCfg):
    """q and k each RMS-normed over the head dim, per head, after the
    projections and before RoPE (the reference's order), where
    ``cfg.qk_norm``."""
    if not cfg.qk_norm:
        return q, k
    return (layers.rmsnorm(params["q_norm"], q),
            layers.rmsnorm(params["k_norm"], k))


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
    norms = params
    if split is not None and cfg.qk_norm:
        # whole on every rank, applied to this rank's heads: the scales'
        # gradient is summed over the split's group
        norms = {n: {"scale": sharding.copy_to(params[n]["scale"], split)}
                 for n in ("q_norm", "k_norm")}
    q, k = _qk_norm(norms, q, k, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    out = flash(q.contiguous(), k.contiguous(), v.contiguous(), cfg.causal,
                bwd_remat)
    y = out_proj("bshd,hde->bse", out, params["wo"], split, x.dtype)
    return (y, (k, v)) if return_kv else y


CROSS_SPLIT_SLICE = ("cross-attention split over a model axis (the "
                     "encoder–decoder family under split or ZeRO) comes "
                     "with a later slice of the port (ROADMAP.md queue A "
                     "item 7)")


def cross_attention(params: dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: AttnCfg, *, bwd_remat: bool = False) -> torch.Tensor:
    """x: (B, Sq, E) queries against the encoder's ``memory`` (B, Sk, E) →
    (B, Sq, E): the keys and values are ``memory``'s projections, nothing
    is roped and no position is masked (``Sq ≠ Sk`` welcome).  The
    reference's blocked core is :func:`ops.flash` with ``causal=False``,
    the flash kernels forward and backward on the card.  A model axis
    that splits the heads raises (the family is not split yet)."""
    if sharding.split_of("q_heads", cfg.n_heads) is not None:
        raise NotImplementedError(CROSS_SPLIT_SLICE)
    q = torch.einsum("bse,ehd->bshd", x, params["wq"].to(x.dtype))
    k = torch.einsum("bse,ekd->bskd", memory, params["wk"].to(x.dtype))
    v = torch.einsum("bse,ekd->bskd", memory, params["wv"].to(x.dtype))
    out = flash(q.contiguous(), k.contiguous(), v.contiguous(), False,
                bwd_remat)
    return out_proj("bshd,hde->bse", out, params["wo"], None, x.dtype)


def out_proj(eq: str, out: torch.Tensor, wo: torch.Tensor, split,
             dtype) -> torch.Tensor:
    """The heads of ``out`` through ``wo``'s rows (``torch.einsum(eq)``) in
    ``dtype``, summed over the split's group where the heads are split: the
    partial products stay in ``dtype``, as the reference's ``wo`` product
    does."""
    return sharding.reduce_from(
        torch.einsum(eq, out.to(dtype), wo.to(dtype)), split)


# ---------------------------------------------------------------------------
# decode (one token per sequence)
# ---------------------------------------------------------------------------

def _decode_qkv(params: dict, x: torch.Tensor, pos: torch.Tensor,
                cfg: AttnCfg):
    """x (B, E) → q (B, H, D), k/v (B, K, D), q and k normed (qk_norm)
    and roped at ``pos``.  Shared by the dense and paged decode paths, so
    the two stay numerically identical by construction."""
    q = torch.einsum("be,ehd->bhd", x, params["wq"].to(x.dtype))
    k = torch.einsum("be,ekd->bkd", x, params["wk"].to(x.dtype))
    v = torch.einsum("be,ekd->bkd", x, params["wv"].to(x.dtype))
    q, k = _qk_norm(params, q, k, cfg)
    # M-RoPE ropes every section at ``pos`` (the reference's decode)
    posb = (pos[:, None] if cfg.mrope_sections is None
            else pos[:, None, None].expand(pos.shape[0], 3, 1))
    q = layers.apply_rope(q[:, None], posb, cfg.rope_theta,
                          cfg.mrope_sections)[:, 0]
    k = layers.apply_rope(k[:, None], posb, cfg.rope_theta,
                          cfg.mrope_sections)[:, 0]
    return q, k, v


DECODE_LAYOUT_SLICE = ("decoding in the {layout!r} attention layout (a model "
                       "axis the kv heads do not divide) comes with a later "
                       "slice of the port (ROADMAP.md queue A item 4)")


def decode_split(cfg: AttnCfg):
    """The q heads' :class:`~repro_torch.core.sharding.Split` of a decode
    step under the active rules (``None`` unsplit).  Decode is
    head-parallel in the ``grouped`` layout only: ``repeat`` and ``seq``
    raise."""
    layout = choose_layout(cfg)
    if layout != "grouped":
        raise NotImplementedError(DECODE_LAYOUT_SLICE.format(layout=layout))
    return sharding.split_of("q_heads", cfg.n_heads)


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 row: torch.Tensor) -> None:
    """ADD ``new`` (B, K, D) into each slot's cell ``row`` (B,) of
    ``cache`` (B, S, K, D) in place; a row outside the cache writes
    nothing."""
    B, S = cache.shape[:2]
    live = ((row >= 0) & (row < S))[:, None, None]
    cell = (torch.arange(B, device=cache.device),
            row.long().clamp(min=0, max=S - 1))
    cache.index_put_(cell, torch.where(live, new, 0).to(cache.dtype),
                     accumulate=True)


def _attend_cache(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: torch.Tensor, cfg: AttnCfg,
                  split=None, row0: int = 0) -> torch.Tensor:
    """q (B, K·G, D) against the cache's rows → (B, K·G, D) in q's dtype.
    Rows ``row0 + i <= pos`` are attended.  With ``split`` the cache holds
    rows ``[row0, row0 + S)`` of a sequence split over its group: the max
    is all-reduced before the exponentials and the sum and the
    unnormalised output after them, the reference's explicit max and
    sum-of-exponentials."""
    B, S, K, D = k_cache.shape
    qg = q.reshape(B, K, cfg.group, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * (D ** -0.5)
    rows = torch.arange(S, device=q.device) + row0
    valid = rows[None, :] <= pos.long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    if split is not None:
        m = sharding.all_reduce_max(m, split)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    # p rounds to the cache dtype before the value product, as in the reference
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    if split is not None:
        out_l = sharding.all_reduce_(torch.cat([out, l], -1), split.group)
        out, l = out_l[..., :D], out_l[..., D:]
    return (out / l.clamp_min(1e-30)).to(q.dtype).reshape(B, K * cfg.group,
                                                         D)


def decode_attention(params: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, cfg: AttnCfg,
                     k_sc=None, v_sc=None, seq_split: bool = False):
    """x: (B, E); k_cache/v_cache: (B, Smax, K, D); pos: (B,) — the index
    the new KV is written at.  Returns (y (B, E), k_cache, v_cache), the
    caches updated in place.

    The write ADDs the new KV into the cell (zero by the server's
    invariant), as the reference's one-hot add does; a ``pos`` past the
    cache writes nothing.  Plain PyTorch: the reference has no kernel here.

    Under rules that split the heads (:func:`decode_split`) the leaves are
    this rank's heads, ``wo``'s output is summed over the split's group,
    and the cache is this rank's block of the state spec
    (``ExecutionPlan.state_specs``), whose layout the caller passes
    (``seq_split``); a cache of another shape raises:

    - *head-split* (the cache length does not divide the model axis, so
      ``kv_heads`` took it): this rank's K/tp heads, all rows; the step
      runs on them as unsplit.
    - *sequence-split* (``seq_split``: ``kv_seq`` took the axis first): rows
      ``[r·Smax/tp, (r+1)·Smax/tp)`` of all K heads.  This step's q, k
      and v are gathered to all heads, the new KV is added on the rank
      whose rows hold ``pos``, each rank scores its rows (``valid`` on
      global rows) and the softmax is merged over the group by the
      reference's explicit max and sums; the rank keeps its heads for
      ``wo``.  The max is all-reduced before the exponentials, so ``p``
      is the unsplit step's, rounded to the cache dtype against the same
      max; only the f32 sums run in another order.  In f32 it equals the
      unsplit step within f32's tolerance; in bf16 the output's rounding
      to bf16 may move by an ulp, so it agrees within bf16's.
    """
    if k_sc is not None or v_sc is not None:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    split = decode_split(cfg)
    n = 1 if split is None or seq_split else split.n
    if seq_split and split is None:
        raise ValueError("a sequence-split cache needs rules that split the "
                         "heads")
    if k_cache.shape[2] != cfg.n_kv_heads // n:
        raise ValueError(f"a {'sequence' if seq_split else 'head'}-split "
                         f"cache holds {cfg.n_kv_heads // n} kv heads a "
                         f"rank, got {k_cache.shape[2]}")
    q, k, v = _decode_qkv(params, x, pos, cfg)
    if not seq_split:
        _cache_write(k_cache, k, pos)
        _cache_write(v_cache, v, pos)
        out = _attend_cache(q, k_cache, v_cache, pos, cfg)
    else:
        q, k, v = (sharding.gather_cat(t, split.group, 1) for t in (q, k, v))
        S = k_cache.shape[1]
        row0 = split.index * S
        _cache_write(k_cache, k, pos - row0)
        _cache_write(v_cache, v, pos - row0)
        out = _attend_cache(q, k_cache, v_cache, pos, cfg, split, row0)
        hl = cfg.n_heads // split.n
        out = out[:, split.index * hl:(split.index + 1) * hl]
    return (out_proj("bhd,hde->be", out, params["wo"], split, x.dtype),
            k_cache, v_cache)


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
    the pools updated in place.

    Under rules that split the heads (:func:`decode_split`) the pools hold
    this rank's kv heads (``ExecutionPlan.paged_state_specs``: pages and
    rows whole), so the kernel runs unchanged on this rank's q heads
    against them, and ``wo``'s output is summed over the split's group:
    no softmax crosses ranks."""
    split = decode_split(cfg)
    q, k_new, v_new = _decode_qkv(params, x, pos, cfg)
    paged_scatter(k_pool, block_table, pos, k_new)
    paged_scatter(v_pool, block_table, pos, v_new)
    out = paged_decode(q.contiguous(), k_pool, v_pool, block_table, pos)
    return (out_proj("bhd,hde->be", out, params["wo"], split, x.dtype),
            k_pool, v_pool)
