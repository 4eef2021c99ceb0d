"""The layer stack: a pattern of blocks repeated ``n_rep`` times,
parameters stacked on a leading ``layers`` dim as in
``repro.models.transformer`` (so the two packages share leaf shapes).
The reference's ``lax.scan`` over repeats is a Python loop here, and its
``jax.checkpoint`` around each repeat is ``torch.utils.checkpoint``.

Each block: a pre-norm mixer (attention | SSD) and, unless ``mlp`` is
``"none"``, a pre-norm MLP (gated or plain, through the config's
activation) or mixture of experts (:mod:`repro_torch.models.moe`), with
residual connections; the norms are the config's (RMSNorm or LayerNorm).
Ported patterns: dense (attention + MLP), MoE (attention + experts, with
dense blocks between where ``moe_every`` > 1), mamba2 (SSD, no MLP) and
the hybrid (jamba: a period of SSD blocks with one attention block, each
with experts or a dense MLP).
The stack sums the experts' aux losses over its layers.  Each mixer runs
under the plan's rules: attention head-parallel, the SSD mixer split over
its heads (:mod:`repro_torch.models.mamba2`), in training and decode.

Under ZeRO-3 (:func:`repro_torch.core.sharding.fsdp_specs`) each repeat's
slices of the parameters are gathered over the data axes inside its
checkpointed region, so the recompute gathers again and the backward
reduce-scatters, as GSPMD's scan does; the whole tree is never gathered.
The decode states' logical dims (:func:`axes_stack_state`,
:func:`axes_paged_stack_state`) are the reference's; a serving plan lays
the states out by them, and each block's decode runs on its rank's block.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import AttnCfg
from repro_torch.models.mamba2 import SSDCfg
from repro_torch.models.moe import MoECfg


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    d_model: int
    mixer: str = "attn"                   # "attn" | "ssd"
    mlp: str = "dense"                    # "dense" | "moe" | "none"
    attn: AttnCfg | None = None
    ssd: SSDCfg | None = None
    moe: MoECfg | None = None
    d_ff: int = 0
    norm: str = "rms"                     # "rms" | "ln"
    act: str = "silu"
    gated_mlp: bool = True


@dataclasses.dataclass(frozen=True)
class StackCfg:
    pattern: tuple                        # tuple[BlockCfg, ...]
    n_rep: int
    remat: str = "full"                   # "none" | "full" | "dots"
    attn_bwd_remat: bool = False          # flash-style attention backward

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_rep


def _unstack(tree: dict, n: int) -> list:
    """Every repeat's slice of a stacked tree (views, no copies), through
    one ``unbind`` per leaf, so a backward stacks the n slices' gradients
    into each leaf once (indexing each repeat would add n full-size
    gradients)."""
    parts = [{} for _ in range(n)]
    for k, v in tree.items():
        for r, sub in enumerate(_unstack(v, n) if isinstance(v, dict)
                                else v.unbind(0)):
            parts[r][k] = sub
    return parts


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_block(gen, cfg: BlockCfg, dtype, device, lead: tuple = ()) -> dict:
    norm_init = layers.make_norm(cfg.norm)[0]
    p = {"norm1": norm_init(lead + (cfg.d_model,), dtype, device)}
    if cfg.mixer == "attn":
        p["attn"] = attn_mod.init_attention(gen, cfg.attn, dtype, device,
                                            lead)
    else:
        p["ssd"] = mamba2.init_ssd(gen, cfg.ssd, dtype, device, lead)
    if cfg.mlp != "none":
        p["norm2"] = norm_init(lead + (cfg.d_model,), dtype, device)
        if cfg.mlp == "moe":
            p["moe"] = moe_mod.init_moe(gen, cfg.moe, dtype, device, lead)
        else:
            p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                       device, lead, gated=cfg.gated_mlp)
    return p


def init_stack(gen, stack: StackCfg, dtype, device) -> dict:
    return {f"p{i}": init_block(gen, bcfg, dtype, device, (stack.n_rep,))
            for i, bcfg in enumerate(stack.pattern)}


def axes_block(cfg: BlockCfg) -> dict:
    norm_axes = layers.make_norm(cfg.norm)[1]
    a = {"norm1": norm_axes()}
    if cfg.mixer == "attn":
        a["attn"] = attn_mod.axes_attention(cfg.attn)
    else:
        a["ssd"] = mamba2.axes_ssd()
    if cfg.mlp != "none":
        a["norm2"] = norm_axes()
        if cfg.mlp == "moe":
            a["moe"] = moe_mod.axes_moe(cfg.moe)
        else:
            a["mlp"] = layers.axes_mlp(cfg.gated_mlp)
    return a


def axes_stack(stack: StackCfg) -> dict:
    """Each leaf's logical dims, ``layers`` first (the stacked repeats)."""
    def lead(tree):
        return {k: lead(v) if isinstance(v, dict) else ("layers",) + v
                for k, v in tree.items()}
    return {f"p{i}": lead(axes_block(bcfg))
            for i, bcfg in enumerate(stack.pattern)}


# ---------------------------------------------------------------------------
# the stack: training forward and prefill
# ---------------------------------------------------------------------------

def _zero_aux(device) -> dict:
    return {"lb_loss": torch.zeros((), dtype=torch.float32, device=device),
            "z_loss": torch.zeros((), dtype=torch.float32, device=device)}


def _mlp_out(params: dict, h: torch.Tensor, cfg: BlockCfg):
    """The block's MLP or experts on the normed ``h`` (B, S, E), or (B, E)
    of one decode token (the experts route it as a sequence of one):
    (out, aux or ``None``)."""
    if cfg.mlp == "moe":
        out, aux = moe_mod.moe_block(params["moe"],
                                     h if h.dim() == 3 else h[:, None],
                                     cfg.moe)
        return (out if h.dim() == 3 else out[:, 0],
                {"lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"]})
    return layers.mlp(params["mlp"], h, cfg.d_ff, cfg.act), None


def apply_block(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: BlockCfg, *, return_state: bool = False,
                bwd_remat: bool = False,
                last_idx: torch.Tensor | None = None,
                train: bool = False):
    """x: (B, S, E) → (x', aux, state-or-None); aux is the experts'
    ``lb_loss`` and ``z_loss`` (zero without experts).  With
    ``return_state`` the block's decode state comes back: the roped
    ``{"k", "v"}`` (B, S, K, D) of attention, or the SSD's ``{"h",
    "conv"}`` after position ``last_idx``.  ``train``: the SSD mixer scans
    through the differentiable chunked form, not its forward-only
    kernel."""
    norm = layers.make_norm(cfg.norm)[2]
    h = norm(params["norm1"], x)
    state = None
    if cfg.mixer == "attn":
        out = attn_mod.attention(params["attn"], h, positions, cfg.attn,
                                 return_kv=return_state, bwd_remat=bwd_remat)
        if return_state:
            out, (k, v) = out
            state = {"k": k, "v": v}
    else:
        out = mamba2.ssd_block(params["ssd"], h, cfg.ssd, last_idx=last_idx,
                               return_state=return_state,
                               differentiable=train)
        if return_state:
            out, state = out
    x = x + out
    aux = None
    if cfg.mlp != "none":
        out, aux = _mlp_out(params, norm(params["norm2"], x), cfg)
        x = x + out
    return x, aux or _zero_aux(x.device), state


_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep matrix-product outputs, recompute the
    rest (the reference's ``dots_with_no_batch_dims_saveable``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, mode: str):
    """``"none"`` runs ``fn`` as it is; ``"full"`` checkpoints it, saving
    nothing; ``"dots"`` checkpoints it saving matrix-product outputs."""
    if mode == "none":
        return fn
    if mode == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if mode == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat must be none, full or dots, got {mode!r}")


def apply_stack(params: dict, x: torch.Tensor, positions: torch.Tensor,
                stack: StackCfg, specs: dict | None = None):
    """x: (B, S, E) → (x', summed aux), the training forward (an SSD
    mixer scans through :func:`~repro_torch.models.mamba2.ssd_scan`).
    One checkpoint per pattern repeat under ``stack.remat``.  ``params``
    is the stacked tree, or a list of each repeat's tree (a pipeline
    stage's leaves of its own, whose gradients reach them as each is
    computed).  ``specs`` (ZeRO-3: the stacked leaves' specs) gathers
    each repeat's slices inside its checkpoint."""
    rules = sharding.current_rules()

    def rep_body(x, rep_params):
        # the rules again: a checkpoint's recompute runs in the backward,
        # on the autograd engine's device thread on the card, which does
        # not see this thread's rules
        with sharding.use_rules(rules):
            if specs is not None:
                rep_params = sharding.gather_fsdp(rep_params, specs, rules,
                                                  lead=1)
            aux = _zero_aux(x.device)
            for i, bcfg in enumerate(stack.pattern):
                x, a, _ = apply_block(rep_params[f"p{i}"], x, positions,
                                      bcfg, bwd_remat=stack.attn_bwd_remat,
                                      train=True)
                aux = {k: aux[k] + a[k] for k in aux}
        return x, aux

    body = _remat_wrap(rep_body, stack.remat)
    aux = _zero_aux(x.device)
    reps = params if isinstance(params, list) else _unstack(params,
                                                            stack.n_rep)
    for rep_params in reps:
        x, a = body(x, rep_params)
        aux = {k: aux[k] + a[k] for k in aux}
    return x, aux


def prefill_stack(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  stack: StackCfg, last_idx: torch.Tensor | None = None):
    """Forward returning each pattern position's decode state for
    subsequent decode, stacked over repeats: ``{"p<i>": {"k", "v"}}`` of
    shape (n_rep, B, S, K, D) for attention, ``{"p<i>": {"h", "conv"}}``
    of shape (n_rep, B, H, P, N) and (n_rep, B, d_conv − 1, H, P) for SSD
    (the state after ``last_idx``)."""
    states = [{} for _ in stack.pattern]
    for rep_params in _unstack(params, stack.n_rep):
        for i, bcfg in enumerate(stack.pattern):
            x, _, st = apply_block(rep_params[f"p{i}"], x, positions, bcfg,
                                   return_state=True, last_idx=last_idx)
            for key, val in st.items():
                states[i].setdefault(key, []).append(val)
    caches = {f"p{i}": {key: torch.stack(vals) for key, vals in st.items()}
              for i, st in enumerate(states)}
    return x, caches


# ---------------------------------------------------------------------------
# dense-cache decode
# ---------------------------------------------------------------------------

def decode_block(params: dict, x: torch.Tensor, state: dict,
                 pos: torch.Tensor, cfg: BlockCfg, seq_split: bool = False):
    """x: (B, E) one token; state: this block's {"k", "v"} cache (this
    rank's rows of a split sequence where ``seq_split``) or SSD {"h",
    "conv"} state, written in place."""
    norm = layers.make_norm(cfg.norm)[2]
    h = norm(params["norm1"], x)
    if cfg.mixer == "attn":
        out, _, _ = attn_mod.decode_attention(params["attn"], h, state["k"],
                                              state["v"], pos, cfg.attn,
                                              seq_split=seq_split)
    else:
        out = mamba2.ssd_decode_step(params["ssd"], h, state, cfg.ssd)
    x = x + out
    if cfg.mlp != "none":
        x = x + _mlp_out(params, norm(params["norm2"], x), cfg)[0]
    return x


def init_stack_state(stack: StackCfg, batch: int, max_len: int, dtype,
                     device) -> dict:
    """Zeroed decode state per pattern position, stacked over repeats: a
    (n_rep, B, max_len, K, D) KV cache for attention, the SSD state (its
    size independent of ``max_len``) for SSD."""
    state = {}
    for i, bcfg in enumerate(stack.pattern):
        if bcfg.mixer == "ssd":
            state[f"p{i}"] = mamba2.init_ssd_state(batch, bcfg.ssd, dtype,
                                                   device, (stack.n_rep,))
            continue
        a = bcfg.attn
        shape = (stack.n_rep, batch, max_len, a.n_kv_heads, a.head_dim)
        state[f"p{i}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
    return state


def axes_block_state(cfg: BlockCfg) -> dict:
    """A block's decode state's logical dims (the reference's
    ``axes_block_state``): the KV cache's sequence is named ``kv_seq``
    before its ``kv_heads``, so where both map to ``model`` the sequence
    takes the axis and the heads stay whole (first come wins)."""
    if cfg.mixer == "attn":
        n = ("batch", "kv_seq", "kv_heads", None)
        return {"k": n, "v": n}
    return mamba2.axes_ssd_state()


def axes_stack_state(stack: StackCfg) -> dict:
    """:func:`init_stack_state`'s logical dims, ``layers`` first."""
    return {f"p{i}": {k: ("layers",) + v
                      for k, v in axes_block_state(bcfg).items()}
            for i, bcfg in enumerate(stack.pattern)}


def decode_stack(params: dict, x: torch.Tensor, state: dict,
                 pos: torch.Tensor, stack: StackCfg, seq_split: bool = False):
    """x: (B, E) → (x', state), the caches in ``state`` written in place
    (:func:`decode_block`)."""
    for rep_params, rep_state in zip(_unstack(params, stack.n_rep),
                                     _unstack(state, stack.n_rep)):
        for i, bcfg in enumerate(stack.pattern):
            x = decode_block(rep_params[f"p{i}"], x, rep_state[f"p{i}"], pos,
                             bcfg, seq_split)
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


def axes_paged_stack_state(stack: StackCfg) -> dict:
    """The pools' logical dims (the reference's): the dense cache's less
    its batch and sequence, so pages and rows stay whole and the kv heads
    split over ``model``."""
    n = ("layers", None, None, "kv_heads", None)
    return {f"p{i}": {"k": n, "v": n} for i in range(len(stack.pattern))}


def paged_decode_block(params: dict, x: torch.Tensor, pools: dict,
                       block_table: torch.Tensor, pos: torch.Tensor,
                       cfg: BlockCfg):
    """Paged twin of :func:`decode_block`; ``pools`` written in place."""
    norm = layers.make_norm(cfg.norm)[2]
    h = norm(params["norm1"], x)
    out, _, _ = attn_mod.paged_decode_attention(
        params["attn"], h, pools["k"], pools["v"], block_table, pos, cfg.attn)
    x = x + out
    return x + _mlp_out(params, norm(params["norm2"], x), cfg)[0]


def decode_stack_paged(params: dict, x: torch.Tensor, pools: dict,
                       block_table: torch.Tensor, pos: torch.Tensor,
                       stack: StackCfg):
    """x: (B, E) → (x', pools).  :func:`decode_stack` against page pools;
    the block table and positions are shared by every layer."""
    for rep_params, rep_pools in zip(_unstack(params, stack.n_rep),
                                     _unstack(pools, stack.n_rep)):
        for i, bcfg in enumerate(stack.pattern):
            x = paged_decode_block(rep_params[f"p{i}"], x, rep_pools[f"p{i}"],
                                   block_table, pos, bcfg)
    return x, pools
