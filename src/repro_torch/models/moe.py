"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch, the
port of ``repro.models.moe``.

Dispatch is sort-based (a stable sort of the token→expert assignments, a
rank-in-expert capacity cutoff), so no (B, S, E, C) tensor is made: the
buffers are (B, E, C, D).  An assignment past its expert's capacity goes
to the sentinel slot E·C and its token index is S; the scatters write one
column more than the buffer and slice it off (the reference's
``mode="drop"``), and the combine adds into S + 1 rows and drops the last.
The expert products are ``torch.bmm`` over the experts, as the reference
computes them with einsums outside any kernel.

Where the active rules split the ``experts`` dim over the model axis
(:mod:`repro_torch.core.sharding`), each rank holds E/n whole experts and
runs them on the model-replicated tokens, so dispatch needs no
communication.  Where the axis does not divide the experts (grok-1's 8 on
the reference's 16-way axis), the rules prune ``experts`` and split each
expert's d_ff (``expert_mlp``) instead, the reference's expert tensor
parallelism: a rank keeps every expert's capacity slots and runs its
d_ff/n columns of ``w_in`` and ``w_gate`` and its rows of ``w_out``, so
its combine is a row-parallel partial.  Either way routing is computed on
every rank alike and the tokens enter the experts through ``copy_to``;
the combine weights' gradient, a partial on each rank (a rank sees only
its experts' weights, or its columns' share of every expert's output), is
summed over the axis at the router logits, while the aux losses'
gradient, whole on every rank, is not.  The combine's partial sums (f32)
and the shared expert's row-parallel partial are summed in one
all-reduce, as the dense MLP's.

Where a loss is taken under rules that deal the batch over data axes
(a data-parallel step, a pipeline's stage at ``dp > 1``), the balance is
the reference's over the global batch: ``me``, ``ce`` and the router
z-loss's mean of lse² are means over the data axes
(:func:`~repro_torch.core.sharding.mean_from`, one all-reduce a layer)
before the aux losses, so the mean of the ranks' gradients is the global
loss's.  Without autograd (serving) the block runs no collective over
data.

:func:`moe_block_ep` is the reference's explicit expert-parallel executor
(its ``shard_map``): the batch split over a process group, the experts'
weights split over the same group, and dispatch and combine as
all-to-all exchanges.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import sharding
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25
    act: str = "silu"
    router_z_coef: float = 1e-3
    lb_coef: float = 1e-2

    def capacity(self, seq_len: int) -> int:
        c = int(seq_len * self.top_k * self.capacity_factor / self.n_experts) + 1
        return max(8, -(-c // 8) * 8)  # round up to 8 for layout friendliness


def init_moe(gen, cfg: MoECfg, dtype, device, lead: tuple = ()) -> dict:
    """The router in f32 whatever ``dtype`` (as the reference's), the
    experts stacked on an ``experts`` dim, and the shared experts as one
    gated MLP of ``n_shared · d_ff_expert`` columns."""
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {
        "router": {"w": layers.dense_init(gen, D, lead + (D, E),
                                          torch.float32, device)},
        "w_in": layers.dense_init(gen, D, lead + (E, D, Fe), dtype, device),
        "w_gate": layers.dense_init(gen, D, lead + (E, D, Fe), dtype, device),
        "w_out": layers.dense_init(gen, Fe, lead + (E, Fe, D), dtype, device),
    }
    if cfg.n_shared:
        p["shared"] = layers.init_mlp(gen, D, Fe * cfg.n_shared, dtype,
                                      device, lead)
    return p


def axes_moe(cfg: MoECfg) -> dict:
    a = {
        "router": {"w": ("embed", None)},           # router stays replicated
        "w_in": ("experts", "embed", "expert_mlp"),
        "w_gate": ("experts", "embed", "expert_mlp"),
        "w_out": ("experts", "expert_mlp", "embed"),
    }
    if cfg.n_shared:
        a["shared"] = layers.axes_mlp()
    return a


# ---------------------------------------------------------------------------
# routing, dispatch, experts, combine
# ---------------------------------------------------------------------------

def _dispatch_indices(expert_idx: torch.Tensor, weights: torch.Tensor,
                      E: int, C: int, seq_len: int):
    """expert_idx/weights: (B, S, k) → per-slot token indices + weights.

    Returns tok (B, E, C) int64 in [0, S] (S = dropped) and w (B, E, C)
    f32."""
    B, S, k = expert_idx.shape
    T = S * k
    flat_e = expert_idx.reshape(B, T)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    # rank of each assignment within its expert = i - first index of expert
    start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(T, device=flat_e.device)[None, :] - start
    slot = torch.where(rank < C, sorted_e * C + rank,
                       torch.full_like(rank, E * C))  # E*C = dropped sentinel
    tok_sorted = order // k
    w_sorted = torch.gather(weights.reshape(B, T), -1, order)
    tok = torch.full((B, E * C + 1), seq_len, dtype=torch.long,
                     device=flat_e.device).scatter(1, slot, tok_sorted)
    wbuf = torch.zeros((B, E * C + 1), dtype=torch.float32,
                       device=flat_e.device).scatter(1, slot,
                                                     w_sorted.float())
    return (tok[:, :E * C].reshape(B, E, C),
            wbuf[:, :E * C].reshape(B, E, C))


def _route(params: dict, x: torch.Tensor, cfg: MoECfg, split=None):
    """Per-token routing (f32): (logits, normalized top-k weights, expert
    ids, per-batch mean prob ``me``, per-batch assignment fraction ``ce``).
    With ``split`` (the experts, or their d_ff, over the model axis) the
    top-k weights' gradient is summed over the split's group at the
    logits, and ``me``'s (the load-balance loss's, whole on every rank) is
    not."""
    logits = x.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=(0, 1))                                    # (E,)
    if split is not None:
        probs = torch.softmax(sharding.copy_to(logits, split), dim=-1)
    w_topk, e_idx = torch.topk(probs, cfg.top_k, dim=-1)           # (B, S, k)
    w_topk = w_topk / w_topk.sum(-1, keepdim=True).clamp_min(1e-9)
    ce = F.one_hot(e_idx, cfg.n_experts).float().mean(dim=(0, 1, 2))
    return logits, w_topk, e_idx, me, ce


def _aux_losses(cfg: MoECfg, me, ce, mean_sq_lse):
    """Load balance (GShard-style) + router z-loss from routing stats."""
    lb_loss = cfg.lb_coef * cfg.n_experts * torch.sum(me * ce)
    z_loss = cfg.router_z_coef * mean_sq_lse
    return lb_loss, z_loss


def _mean_sq_lse(logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))


def _gather_tokens(x: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """x (B, S, D), tok (B, E', C) in [0, S] → (B, E', C, D), a dropped
    slot reading token S − 1 (its weight is 0)."""
    B = x.shape[0]
    safe = tok.clamp_max(x.shape[1] - 1)
    return x[torch.arange(B, device=x.device)[:, None, None], safe]


def _expert_ffn(params: dict, xin: torch.Tensor, dtype,
                act: str) -> torch.Tensor:
    """The gated MLP (SwiGLU, GeGLU: ``act`` from the activation table)
    over per-expert capacity buffers: (B, E', C, D) → (B, E', C, D), one
    ``bmm`` per product over the weights' E' experts."""
    B, Ep, C, D = xin.shape
    xe = xin.transpose(0, 1).reshape(Ep, B * C, D)
    h = torch.bmm(xe, params["w_in"].to(dtype))
    g = torch.bmm(xe, params["w_gate"].to(dtype))
    out = torch.bmm(layers.ACTS[act](g) * h, params["w_out"].to(dtype))
    return out.reshape(Ep, B, C, D).transpose(0, 1)


def _combine(tok: torch.Tensor, out: torch.Tensor,
             seq_len: int) -> torch.Tensor:
    """Weighted capacity buffers (B, E', C, D) → (B, S, D) scatter-add in
    f32 (a bf16 ``index_add`` rounds at every atomic add, in whatever order
    the card runs them); a dropped slot (token S) lands on an extra row
    that is dropped."""
    B, D = out.shape[0], out.shape[-1]
    rows = (tok + torch.arange(B, device=tok.device)[:, None, None]
            * (seq_len + 1)).reshape(-1)
    y = torch.zeros((B * (seq_len + 1), D), dtype=torch.float32,
                    device=out.device).index_add(
                        0, rows, out.reshape(-1, D).float())
    return y.reshape(B, seq_len + 1, D)[:, :seq_len]


def _expert_split(cfg: MoECfg) -> tuple:
    """How the active rules split the experts: ``(split, dim)``, ``dim``
    ``"experts"`` (whole experts a rank) or ``"expert_mlp"`` (every
    expert's d_ff, where the axis does not divide the experts), or
    ``(None, None)``: whole.  The reference's first-come-wins rule: the
    ``experts`` dim comes first in the weights' axes."""
    dim = "experts"
    split = sharding.split_of(dim, cfg.n_experts)
    if split is None:
        dim = "expert_mlp"
        split = sharding.split_of(dim, cfg.d_ff_expert)
    if cfg.n_shared and (split is None) != (sharding.split_of(
            "mlp", cfg.d_ff_expert * cfg.n_shared) is None):
        raise NotImplementedError(
            "the routed experts and the shared experts' columns must both "
            "split over the model axis or both stay whole")
    return split, (dim if split is not None else None)


def moe_block(params: dict, x: torch.Tensor, cfg: MoECfg):
    """x: (B, S, D) → (B, S, D), aux-loss dict (``lb_loss``, ``z_loss``,
    ``expert_load``)."""
    layers.check_act(cfg.act)
    B, S, D = x.shape
    E = cfg.n_experts
    C = cfg.capacity(S)
    split, dim = _expert_split(cfg)

    # --- routing (f32; replicated over the model axis) ---
    logits, w_topk, e_idx, me, ce = _route(params, x, cfg, split)
    msl = _mean_sq_lse(logits)
    balance = sharding.batch_splits() if torch.is_grad_enabled() else ()
    if balance:
        # the balance of the global batch: one all-reduce of the routing
        # statistics over the data axes (serving takes no loss, so none)
        stats = sharding.mean_from(torch.cat([me, ce, msl[None]]), balance)
        me, ce, msl = stats[:E], stats[E:2 * E], stats[2 * E]
    lb_loss, z_loss = _aux_losses(cfg, me, ce, msl)

    tok, w = _dispatch_indices(e_idx, w_topk, E, C, S)             # (B, E, C)
    if dim == "experts":                   # this rank's experts' slots
        El = E // split.n
        tok = tok[:, split.index * El:(split.index + 1) * El]
        w = w[:, split.index * El:(split.index + 1) * El]
    # whole experts or their d_ff columns: each rank's input gradient is
    # a partial
    x = sharding.copy_to(x, split)

    out = _expert_ffn(params, _gather_tokens(x, tok), x.dtype, cfg.act)
    out = out * w[..., None].to(out.dtype)
    y = _combine(tok, out, S)
    if cfg.n_shared:
        # this rank's columns where the rules split them: a partial, summed
        # with the combine's below (``mlp`` without d_ff reduces nothing)
        y = y + layers.mlp(params["shared"], x, act=cfg.act).float()
    # the partial sums (f32) → one all-reduce
    y = sharding.reduce_from(y, split).to(x.dtype)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "expert_load": ce.detach()}
    return y, aux


# ---------------------------------------------------------------------------
# explicit expert parallelism: the nested replica{split[experts]} executor
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """Dim 0 of ``x`` in ``n`` equal blocks, block j sent to rank j and
    rank i's block received in place i; the backward is the same exchange
    of the gradient.  Under gloo a CUDA tensor crosses through host
    memory."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    src = x.contiguous()
    if sharding._via_host(group, src):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


def moe_block_ep(params: dict, x: torch.Tensor, cfg: MoECfg, group):
    """Expert-parallel :func:`moe_block` over the process ``group`` of
    ``ep`` ranks (the reference's ``moe_block_ep`` over one mesh axis).

    ``x`` is this rank's block of the batch (B/ep, S, D); ``params`` hold
    the router and shared experts whole and this rank's E/ep experts
    (the leading dim of ``w_in``, ``w_gate``, ``w_out``).  Each rank
    routes its tokens into per-expert capacity buffers, an all-to-all
    regroups them so that a rank holds every rank's tokens for its
    experts ((B/ep, E, C, D) → (B, E/ep, C, D)), and the reverse
    all-to-all returns the outputs for the weighted scatter-add.  The aux
    statistics are the group's means; the router's and the shared
    experts' gradients come back summed over the group (whole on every
    rank), the experts' as this rank's block, ``x``'s as its rows.
    """
    layers.check_act(cfg.act)
    ep = dist.get_world_size(group)
    Bl, S, D = x.shape
    E = cfg.n_experts
    if E % ep:
        raise ValueError(f"expert parallelism needs n_experts % ep == 0; "
                         f"got E={E} over {ep} ranks")
    El, C = E // ep, cfg.capacity(S)
    whole = sharding.Split(group, ep, dist.get_rank(group))

    def pmean(t):
        # the cotangent of a replicated output is given on every rank:
        # each keeps its own share, so the backward sends nothing
        return sharding.reduce_from(t, whole) / ep

    p = dict(params, router={"w": sharding.copy_to(params["router"]["w"],
                                                   whole)})
    logits, w_topk, e_idx, me, ce = _route(p, x, cfg)
    ce = pmean(ce)
    lb_loss, z_loss = _aux_losses(cfg, pmean(me), ce,
                                  pmean(_mean_sq_lse(logits)))

    tok, w = _dispatch_indices(e_idx, w_topk, E, C, S)
    xin = _gather_tokens(x, tok)                              # (Bl, E, C, D)
    # dispatch: rank j receives every rank's slots of its experts
    xg = _AllToAll.apply(xin.reshape(Bl, ep, El, C, D).transpose(0, 1),
                         group)                          # (ep, Bl, El, C, D)
    out = _expert_ffn(params, xg.reshape(ep * Bl, El, C, D), x.dtype,
                      cfg.act)
    # combine: each rank's outputs return to the rank of their tokens
    out = _AllToAll.apply(out.reshape(ep, Bl, El, C, D), group)
    out = out.transpose(0, 1).reshape(Bl, E, C, D)
    out = out * w[..., None].to(out.dtype)
    y = _combine(tok, out, S)
    if cfg.n_shared:
        shared = {k: sharding.copy_to(v, whole)
                  for k, v in params["shared"].items()}
        y = y + layers.mlp(shared, x, act=cfg.act).float()
    y = y.to(x.dtype)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "expert_load": ce.detach()}
    return y, aux
