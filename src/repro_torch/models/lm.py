"""The LM: one config dataclass → {init, loss_fn, prefill, serve_step,
serve_step_paged} for the dense and moe decoder families, and {init,
loss_fn, prefill, serve_step} for the ssm family (mamba2, its embedding
tied to its head) and the hybrid family (jamba: a period of SSD blocks
with one attention block, experts on every other block); and the cost
model's view of a config (:func:`model_graph`, pure arithmetic).

The port's counterpart of ``repro.models.lm`` for training and serving.
The loss head is chosen by device, as the reference's ``xent_impl``
chooses it: :func:`fused_xent` over the fused cross-entropy kernels on the
card, :func:`chunked_xent` (the reference's plain, sequence-chunked head)
on the CPU; ``Model(..., xent_impl=)`` picks one on either.  Under
sharding rules that split the vocab (:mod:`repro_torch.core.sharding`)
both heads are vocab-parallel: the chunked one by the reference's explicit
max / sum-of-exponentials / target logit all-reduces, the fused one
through :func:`repro_torch.kernels.xent.ops.xent_vocab_shard`.
Parameters are nested dicts of tensors with the reference's leaf paths and
shapes (``embed/table``, ``blocks/p0/attn/wq`` …), so
:func:`repro_torch.models.convert.params_from_numpy` moves a reference
parameter tree across unchanged.  State constructors allocate on the
model's device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sharding
from repro_torch.core.cost_model import ModelGraph, SegmentMeta
from repro_torch.device import resolve_device
from repro_torch.kernels.xent.ops import xent_vocab_shard, xent_with_lse
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import AttnCfg
from repro_torch.models.mamba2 import SSDCfg
from repro_torch.models.moe import MoECfg
from repro_torch.tree import tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LMCfg:
    name: str
    family: str                        # dense | moe | ssm | hybrid (ported)
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    norm: str = "rms"                  # "rms" | "ln"
    act: str = "silu"                  # silu | gelu (tanh) | relu
    gated_mlp: bool = True
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False       # head = embed/tableᵀ, no head leaf
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssd_headdim: int = 64
    ssd_state: int = 128
    d_conv: int = 4
    ssd_chunk: int = 256
    attn_period: int = 0               # hybrid: one attn layer per period
    attn_offset: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"                # "full" | "dots" | "none"
    loss_chunk: int = 512
    vocab_pad_multiple: int = 256
    z_loss_coef: float = 1e-4
    attn_bwd_remat: bool = False       # re-run flash fwd in its backward

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return layers.pad_vocab(self.vocab, self.vocab_pad_multiple)

    @property
    def has_experts(self) -> bool:
        """Whether the model carries experts: the moe family, and the
        hybrid's odd blocks."""
        return self.n_experts > 0 and self.family in ("moe", "hybrid")

    @property
    def adtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def attn_cfg(self) -> AttnCfg:
        return AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                       n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                       rope_theta=self.rope_theta, qk_norm=self.qk_norm)

    def ssd_cfg(self) -> SSDCfg:
        n_heads = (2 * self.d_model) // self.ssd_headdim   # expand = 2
        return SSDCfg(d_model=self.d_model, n_heads=n_heads,
                      headdim=self.ssd_headdim, d_state=self.ssd_state,
                      d_conv=self.d_conv, chunk=self.ssd_chunk)

    def moe_cfg(self) -> MoECfg:
        return MoECfg(d_model=self.d_model, n_experts=self.n_experts,
                      top_k=self.top_k, d_ff_expert=self.d_ff_expert,
                      n_shared=self.n_shared,
                      capacity_factor=self.capacity_factor, act=self.act)


def build_stack_cfg(cfg: LMCfg) -> tfm.StackCfg:
    """The stack's pattern, the reference's: one block repeated; for the
    moe family with ``moe_every`` > 1 a period of blocks whose
    ``moe_offset``-th carries the experts; for the hybrid family a period
    of ``attn_period`` blocks, attention at ``attn_offset`` and SSD
    elsewhere, experts on the odd blocks and a dense MLP on the even."""
    # an unknown norm or activation raises here, before a leaf is drawn
    layers.make_norm(cfg.norm)
    layers.check_act(cfg.act)

    def block(mixer: str, mlp: str) -> tfm.BlockCfg:
        return tfm.BlockCfg(d_model=cfg.d_model, mixer=mixer, mlp=mlp,
                            attn=cfg.attn_cfg() if mixer == "attn" else None,
                            ssd=cfg.ssd_cfg() if mixer == "ssd" else None,
                            moe=cfg.moe_cfg() if mlp == "moe" else None,
                            d_ff=cfg.d_ff, norm=cfg.norm, act=cfg.act,
                            gated_mlp=cfg.gated_mlp)

    if cfg.family == "dense":
        pattern, n_rep = (block("attn", "dense"),), cfg.n_layers
    elif cfg.family == "moe" and cfg.moe_every == 1:
        pattern, n_rep = (block("attn", "moe"),), cfg.n_layers
    elif cfg.family == "moe":
        pattern = tuple(block("attn", "moe" if i % cfg.moe_every
                              == cfg.moe_offset else "dense")
                        for i in range(cfg.moe_every))
        n_rep = cfg.n_layers // cfg.moe_every
    elif cfg.family == "ssm":
        pattern, n_rep = (block("ssd", "none"),), cfg.n_layers
    elif cfg.family == "hybrid":
        p = cfg.attn_period
        pattern = tuple(block("attn" if i % p == cfg.attn_offset else "ssd",
                              "moe" if i % 2 == 1 else "dense")
                        for i in range(p))
        n_rep = cfg.n_layers // p
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense, moe, ssm, "
            f"hybrid)")
    return tfm.StackCfg(pattern=pattern, n_rep=n_rep, remat=cfg.remat,
                        attn_bwd_remat=cfg.attn_bwd_remat)


# ---------------------------------------------------------------------------
# the loss head: sequence-chunked cross-entropy and the fused-kernel twin
# ---------------------------------------------------------------------------

def _chunk_sums(h, head_w, lab, msk, vocab: int, split=None):
    logits = h.float() @ head_w.to(h.dtype).float()   # (B, c, Vp) in f32
    Vp = head_w.shape[1]
    c0 = 0 if split is None else split.index * Vp
    col = c0 + torch.arange(Vp, device=h.device)
    if c0 + Vp > vocab:                          # mask padded vocab columns
        logits = torch.where(col < vocab, logits,
                             torch.full_like(logits, -1e30))
    m = logits.amax(-1)
    if split is not None:                        # AR(max) over vocab shards
        m = sharding.all_reduce_max(m.detach(), split)
    se = sharding.reduce_from(torch.exp(logits - m[..., None]).sum(-1),
                              split)             # AR(sum)
    z = torch.log(se) + m
    correct = sharding.reduce_from(torch.where(
        col == lab[..., None], logits, torch.zeros_like(logits)).sum(-1),
        split)                                   # AR(sum)
    return ((z - correct) * msk).sum(), (z.square() * msk).sum()


def chunked_xent(hidden: torch.Tensor, head_w: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor, *, vocab: int,
                 chunk: int, z_loss_coef: float = 0.0, split=None):
    """hidden: (B, T, E); head_w: (E, Vp), or with ``split`` (a
    :class:`~repro_torch.core.sharding.Split` of the vocab) this rank's
    columns of it; labels/mask: (B, T).

    Returns (sum_nll, z_loss_coef·sum_z_loss, token_count), as
    ``repro.models.lm.chunked_xent``.  Sequence-chunked, each chunk
    checkpointed, so one (B, chunk, Vp) f32 logits block is the only live
    logits tensor.  Vocab-parallel with ``split``: three all-reduces per
    chunk (the max, detached; the sum of exponentials; the target logit),
    and the hidden's gradient summed over the split's group.
    """
    B, T, _ = hidden.shape
    chunk = min(chunk, T)
    mask = mask.float()
    hidden = sharding.copy_to(hidden, split)
    s_nll = s_zl = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for t0 in range(0, T, chunk):
        nll, zl = torch.utils.checkpoint.checkpoint(
            _chunk_sums, hidden[:, t0:t0 + chunk], head_w,
            labels[:, t0:t0 + chunk], mask[:, t0:t0 + chunk], vocab, split,
            use_reentrant=False)
        s_nll, s_zl = s_nll + nll, s_zl + zl
    return s_nll, z_loss_coef * s_zl, mask.sum()


def fused_xent(hidden: torch.Tensor, head_w: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor, *, vocab: int,
               z_loss_coef: float = 0.0, split=None):
    """The fused-kernel twin of :func:`chunked_xent` (same contract).

    The forward kernel never writes a logits tensor; nll and lse come back
    together, so the z-loss term differentiates through the same
    chunk-by-chunk backward (:func:`repro_torch.kernels.xent.ops.
    xent_with_lse`; with ``split``, :func:`~repro_torch.kernels.xent.ops.
    xent_vocab_shard` on this rank's columns).
    """
    B, T, E = hidden.shape
    m2 = mask.reshape(B * T).float()
    if split is None:
        nll, lse = xent_with_lse(hidden.reshape(B * T, E), head_w,
                                 labels.reshape(B * T), vocab)
    else:
        nll, lse = xent_vocab_shard(
            hidden.reshape(B * T, E), head_w, labels.reshape(B * T),
            split.index * head_w.shape[1], vocab, split.group)
    s_nll = (nll * m2).sum()
    s_zl = (lse.square() * m2).sum()
    return s_nll, z_loss_coef * s_zl, m2.sum()


def param_count(params: dict) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else param_count(v)
               for v in params.values())


class Model:
    """Functional model bundle for one LMCfg on one device (``None`` means
    the card; see :func:`repro_torch.device.resolve_device`).
    ``xent_impl``: the loss head, ``"chunked"`` or ``"fused"`` (the
    reference's ``"ref"`` and ``"pallas"``); ``None`` picks by device."""

    def __init__(self, cfg: LMCfg, device=None, *,
                 xent_impl: str | None = None):
        if xent_impl not in (None, "chunked", "fused"):
            raise ValueError(f"xent_impl must be chunked or fused, got "
                             f"{xent_impl!r}")
        self.cfg = cfg
        self.xent_impl = xent_impl
        self.device = resolve_device(device)
        self.stack = build_stack_cfg(cfg)
        self._shapes = None

    # ---- params ----
    def init(self, seed: int) -> dict:
        """Random parameters from ``seed``, drawn on the model's device."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.pdtype
        gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
        gen.manual_seed(seed)
        p = {
            "embed": layers.init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                           dt, dev),
            "final_norm": layers.make_norm(cfg.norm)[0]((cfg.d_model,), dt,
                                                        dev),
        }
        if not cfg.tie_embeddings:
            p["head"] = layers.init_lm_head(gen, cfg.d_model,
                                            cfg.padded_vocab, dt, dev)
        p["blocks"] = tfm.init_stack(gen, self.stack, dt, dev)
        return p

    def param_shapes(self) -> dict:
        """The parameter tree as ``meta`` tensors: every leaf's shape and
        dtype, nothing allocated (the reference's ``jax.eval_shape`` of
        ``init``)."""
        if self._shapes is None:
            self._shapes = Model(self.cfg, "meta").init(0)
        return self._shapes

    def axes(self) -> dict:
        """Each parameter leaf's logical dims (the reference's
        ``Model.axes``), the tree the sharding rules map to specs."""
        a = {"embed": layers.axes_embedding(),
             "final_norm": layers.make_norm(self.cfg.norm)[1](),
             "blocks": tfm.axes_stack(self.stack)}
        if not self.cfg.tie_embeddings:
            a["head"] = layers.axes_lm_head()
        return a

    def graph(self, batch: int, seq: int, *, act_dtype_bytes: int = 2,
              param_dtype_bytes: int = 4) -> ModelGraph:
        """Segment-aware cost-model view of this model (see
        :func:`model_graph`), flattenable to a WorkloadMeta via
        ``.workload_meta()``."""
        return model_graph(self.cfg, batch, seq,
                           act_dtype_bytes=act_dtype_bytes,
                           param_dtype_bytes=param_dtype_bytes)

    # leaves (and subtrees: the experts' router) the reference reads in
    # f32 whatever the activation dtype
    F32_LEAVES = frozenset({"scale", "wdt", "dt_bias", "A_log",
                            "norm_scale", "router"})

    def serving_params(self, params: dict) -> dict:
        """``params`` with every weight cast once to the activation dtype,
        except :attr:`F32_LEAVES`.  Each product casts its weight to that
        dtype anyway, so the results are the same; serving then stops
        re-reading (and re-casting) f32 masters every step.  The norm
        scales, dt's projection and bias, ``A_log`` and the experts'
        router stay as they are: the reference reads them in f32, and
        casting them changes the result."""
        def cast(tree):
            return {k: v if k in self.F32_LEAVES
                    else cast(v) if isinstance(v, dict)
                    else v.to(self.cfg.adtype)
                    for k, v in tree.items()}
        return cast(params)

    def final_norm(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The stack's output through ``final_norm``, the config's norm."""
        return layers.make_norm(self.cfg.norm)[2](params["final_norm"], x)

    def _head_w(self, params: dict) -> torch.Tensor:
        """The (E, Vp) head: ``embed/table``ᵀ when embeddings are tied."""
        if self.cfg.tie_embeddings:
            return params["embed"]["table"].T
        return params["head"]["w"]

    # ---- training ----
    def loss_fn(self, params: dict, batch: dict):
        """batch {"tokens": (B, S) int, optional "loss_mask": (B, S)} →
        (loss, metrics), as the reference's ``Model.loss_fn`` for the
        dense, moe, ssm and hybrid families: next-token nll plus the z-loss, both
        over the masked token count, plus the experts' load-balance and
        router z-losses summed over the layers (``moe_lb``, ``moe_z``;
        zero without experts); the head cast to the activation dtype.  The
        loss head is :func:`fused_xent` on the card and
        :func:`chunked_xent` on the CPU.  An SSD mixer (mamba2's, jamba's)
        trains through the differentiable chunked scan (the reference's
        default ``ssd_impl``; the SSD kernel is forward only), and a tied
        head's gradient adds to the embedding table's.

        Under sharding rules ``params`` are this rank's blocks; under
        ZeRO-3 the leaves outside the stack are gathered over the data
        axes here, the stack's repeat by repeat in
        :func:`~repro_torch.models.transformer.apply_stack`."""
        cfg = self.cfg
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(
                f"training the {cfg.family!r} family is not ported yet")
        specs = sharding.fsdp_specs(self)
        if specs is not None:
            top = [k for k in params if k != "blocks"]
            params = dict(params, **sharding.gather_fsdp(
                {k: params[k] for k in top}, {k: specs[k] for k in top},
                sharding.current_rules()))
        tokens = batch["tokens"].long()
        B, S = tokens.shape
        x = layers.embed(params["embed"], tokens,
                         cfg.padded_vocab).to(cfg.adtype)
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, aux = tfm.apply_stack(params["blocks"], x, positions, self.stack,
                                 None if specs is None else specs["blocks"])
        mask = torch.ones((B, S - 1), dtype=torch.float32, device=x.device)
        if "loss_mask" in batch:
            mask = mask * batch["loss_mask"][:, 1:]
        nll, zl, n = self.head_loss(params, x, tokens, mask)
        n1 = n.clamp_min(1.0)
        loss = nll / n1 + zl / n1 + aux["lb_loss"] + aux["z_loss"]
        metrics = {"nll": nll / n1, "tokens": n, "moe_lb": aux["lb_loss"],
                   "moe_z": aux["z_loss"]}
        return loss, metrics

    def head_loss(self, params: dict, x: torch.Tensor, tokens: torch.Tensor,
                  mask: torch.Tensor):
        """(Σ nll, z_loss_coef·Σ lse², Σ mask) of next-token prediction
        from the stack's output ``x`` (B, S, E): the final norm, the head
        cast to the activation dtype, and the loss head chosen by device
        (:func:`fused_xent` on the card, :func:`chunked_xent` on the CPU)
        unless ``xent_impl`` picks one.  ``mask`` (B, S − 1) weights the
        labels ``tokens[:, 1:]``; the head is vocab-parallel where the
        rules split the vocab.  Reads
        only ``final_norm`` and the head (``embed`` when tied) of
        ``params``, so a pipeline's last stage calls it too.  A tied
        head, ``embed/table``ᵀ, is made contiguous in the same pass that
        casts it (the fused kernel reads (E, Vp) rows)."""
        cfg = self.cfg
        x = self.final_norm(params, x)
        head_w = self._head_w(params).to(
            cfg.adtype, memory_format=torch.contiguous_format).contiguous()
        labels = tokens[:, 1:]
        split = sharding.split_of("vocab", cfg.padded_vocab)
        impl = self.xent_impl or ("fused" if x.device.type == "cuda"
                                  else "chunked")
        if impl == "fused":
            return fused_xent(x[:, :-1], head_w, labels, mask,
                              vocab=cfg.vocab, z_loss_coef=cfg.z_loss_coef,
                              split=split)
        return chunked_xent(x[:, :-1], head_w, labels, mask, vocab=cfg.vocab,
                            chunk=cfg.loss_chunk, z_loss_coef=cfg.z_loss_coef,
                            split=split)

    # ---- serving ----
    # Under sharding rules (``ExecutionPlan.prefill_fn`` and the step
    # functions set them) the embedding is vocab-parallel, attention and
    # the MLP head- and column-parallel, and the logits are this rank's
    # vocab columns: the plan's functions gather them over ``model``.
    def prefill(self, params: dict, batch: dict, gen_budget: int = 64,
                last_idx: torch.Tensor | None = None):
        """→ (last-token logits (B, Vp), decode state).

        ``last_idx`` (B,): index of each prompt's last real token when
        prompts are right-padded to a shared (bucketed) length — logits
        are read there, ``pos`` starts at ``last_idx + 1``, and the KV
        cache is zeroed beyond ``last_idx`` so pad tokens' KV is never
        attended (decode's ADD write at ``pos`` lands on a zero cell).
        SSD blocks return their exact state after ``last_idx``; those
        leaves are not KV and are not padded to ``S + gen_budget``.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = layers.embed(params["embed"], tokens,
                         cfg.padded_vocab).to(cfg.adtype)
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        if last_idx is not None:
            last_idx = last_idx.to(device=x.device, dtype=torch.long)
        x, caches = tfm.prefill_stack(params["blocks"], x, positions,
                                      self.stack, last_idx)
        x = self.final_norm(params, x)
        if last_idx is None:
            h_last = x[:, -1]
            pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
        else:
            h_last = x[torch.arange(B, device=x.device), last_idx]
            pos = (last_idx + 1).to(torch.int32)
        logits = h_last @ self._head_w(params).to(cfg.adtype)

        keep = None
        if last_idx is not None:
            keep = (torch.arange(S + gen_budget, device=x.device)[None, :]
                    <= last_idx[:, None])                      # (B, S+gb)

        def pad_kv(a):
            # (L, B, S, K, D) → (L, B, S + budget, K, D)
            a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, gen_budget))
            if keep is not None:
                a = torch.where(keep[None, :, :, None, None], a, 0)
            return a

        cache = {}
        for i, bcfg in enumerate(self.stack.pattern):
            st = caches[f"p{i}"]
            cache[f"p{i}"] = ({key: pad_kv(val) for key, val in st.items()}
                              if bcfg.mixer == "attn" else st)
        return logits, {"cache": cache, "pos": pos}

    def serve_step(self, params: dict, tokens: torch.Tensor, state: dict,
                   seq_split: bool = False):
        """tokens: (B,) → (logits (B, Vp), state').  The cache in ``state``
        is written in place; ``pos`` advances for every slot.
        ``seq_split``: the KV caches are this rank's rows of a sequence
        split over the heads' split (the state spec's ``kv_seq``; the plan's
        :meth:`~repro_torch.core.planner.ExecutionPlan.serve_step_fn` reads
        it off the spec)."""
        cfg = self.cfg
        pos = state["pos"]
        x = layers.embed(params["embed"], tokens,
                         cfg.padded_vocab).to(cfg.adtype)
        x, cache = tfm.decode_stack(params["blocks"], x, state["cache"], pos,
                                    self.stack, seq_split)
        x = self.final_norm(params, x)
        logits = x @ self._head_w(params).to(cfg.adtype)
        return logits, {"cache": cache, "pos": pos + 1}

    # ---- decode-state templates (the plan's state specs read them) ----
    def decode_state_shapes(self, batch: int, cache_len: int) -> dict:
        """The dense decode state's leaves (the cache, ``pos``) as
        ``(torch.Size, dtype)`` pairs; nothing is allocated (the
        reference's ``jax.eval_shape``).  ``ExecutionPlan.local_zeros``
        makes a rank's block of it."""
        return _pairs({"cache": tfm.init_stack_state(
            self.stack, batch, cache_len, self.cfg.adtype, "meta"),
            "pos": torch.empty((batch,), dtype=torch.int32, device="meta")})

    def state_axes(self) -> dict:
        """The dense decode state's logical dims (the reference's)."""
        return {"cache": tfm.axes_stack_state(self.stack), "pos": ("batch",)}

    # ---- paged serving (block-table KV cache) ----
    @property
    def supports_paged(self) -> bool:
        """Paged KV needs every mixer to be attention (SSD state is O(1)
        per slot and gains nothing from pages)."""
        return all(b.mixer == "attn" for b in self.stack.pattern)

    def serve_step_paged(self, params: dict, tokens: torch.Tensor,
                         state: dict):
        """tokens: (B,) → (logits (B, Vp), state').  ``state`` holds the
        shared page pools plus per-slot ``block_table`` (B, max_pages) and
        ``pos`` (B,); the pools are written in place."""
        cfg = self.cfg
        pos = state["pos"]
        x = layers.embed(params["embed"], tokens,
                         cfg.padded_vocab).to(cfg.adtype)
        x, pools = tfm.decode_stack_paged(params["blocks"], x, state["pools"],
                                          state["block_table"], pos,
                                          self.stack)
        x = self.final_norm(params, x)
        logits = x @ self._head_w(params).to(cfg.adtype)
        return logits, {"pools": pools, "block_table": state["block_table"],
                        "pos": pos + 1}

    def paged_pools(self, n_pages: int, page_size: int) -> dict:
        """Zeroed page pools on the model's device."""
        return tfm.init_paged_stack_state(self.stack, n_pages, page_size,
                                          self.cfg.adtype, self.device)

    def paged_state_shapes(self, batch: int, n_pages: int, page_size: int,
                           max_pages: int) -> dict:
        """The paged decode state's leaves (pools, ``block_table``,
        ``pos``) as ``(torch.Size, dtype)`` pairs; nothing is allocated."""
        i32 = torch.int32
        return _pairs({
            "pools": tfm.init_paged_stack_state(self.stack, n_pages,
                                                page_size, self.cfg.adtype,
                                                "meta"),
            "block_table": torch.empty((batch, max_pages), dtype=i32,
                                       device="meta"),
            "pos": torch.empty((batch,), dtype=i32, device="meta")})

    def paged_state_axes(self) -> dict:
        """The paged decode state's logical dims (the reference's)."""
        return {"pools": tfm.axes_paged_stack_state(self.stack),
                "block_table": ("batch", None), "pos": ("batch",)}


def _pairs(tree: dict) -> dict:
    """A tree of tensors as ``(shape, dtype)`` pairs."""
    return tree_map(lambda t: (t.shape, t.dtype), tree)


def build(cfg: LMCfg, device=None) -> Model:
    return Model(cfg, device)


# ---------------------------------------------------------------------------
# the cost model's view: ModelGraph builders (pure arithmetic on the config)
# ---------------------------------------------------------------------------
#
# The port of ``repro/models/lm.py::model_graph`` for the families the port
# has.  Matmul-dominant terms only, in the reference's expressions and
# order, so a graph here equals the reference's bit for bit
# (tests/test_torch_planning.py).  One "stack" segment: every layer of a
# dense, moe, ssm or hybrid config is interchangeable.

FAMILY_SLICE = ("the {family} family's cost-model graph comes with the "
                "family itself, a later slice of the port")


def model_graph(cfg: LMCfg, batch: int, seq: int,
                act_dtype_bytes: int = 2,
                param_dtype_bytes: int = 4) -> ModelGraph:
    """Segment-aware workload description for one LMCfg (dense, moe, ssm
    or hybrid).

    The other families of the reference (vlm, encdec) raise
    ``NotImplementedError``: their graphs come with their models.
    """
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(FAMILY_SLICE.format(family=cfg.family))
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(f"unknown model family {cfg.family!r}")
    E, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    T = batch * seq
    hd = cfg.hd
    pdb = param_dtype_bytes

    def attn_flops(t=T, kv=seq, causal=True) -> float:
        H, K = cfg.n_heads, cfg.n_kv_heads
        proj = 2 * t * E * (H * hd) + 2 * 2 * t * E * (K * hd) \
            + 2 * t * (H * hd) * E
        scores = 2 * t * kv * H * hd * 2 * (0.5 if causal else 1.0)
        return proj + scores

    def dense_mlp_flops(t=T) -> float:
        mult = 3 if cfg.gated_mlp else 2
        return 2 * t * E * cfg.d_ff * mult

    def moe_mlp_flops() -> float:
        mult = 3
        routed = 2 * T * E * cfg.d_ff_expert * mult * cfg.top_k
        shared = 2 * T * E * cfg.d_ff_expert * mult * cfg.n_shared
        router = 2 * T * E * cfg.n_experts
        return routed + shared + router

    def ssd_flops() -> float:
        scfg = cfg.ssd_cfg()
        H, P, N, C = scfg.n_heads, scfg.headdim, scfg.d_state, scfg.chunk
        proj = 2 * T * E * (2 * H * P + 2 * N + H) + 2 * T * H * P * E
        intra = 2 * T * C * H * (N + P)
        inter = 2 * T * H * P * N * 2
        return proj + intra + inter

    def attn_params():
        return E * (cfg.n_heads * hd) * 2 + E * (cfg.n_kv_heads * hd) * 2

    def mlp_params():
        return E * cfg.d_ff * (3 if cfg.gated_mlp else 2)

    def moe_params():
        return (cfg.n_experts + cfg.n_shared) * E * cfg.d_ff_expert * 3 \
            + E * cfg.n_experts

    def ssd_params():
        scfg = cfg.ssd_cfg()
        return E * scfg.d_inner * 3 + 2 * E * scfg.d_state + E * scfg.n_heads

    act_per_layer = T * E * act_dtype_bytes * 4   # x + 3 intermediates

    def stack_segment(name: str, n_attn: int, n_ssd: int, n_moe: int,
                      n_dense: int, n_layers: int) -> SegmentMeta:
        flops = (n_attn * attn_flops() + n_ssd * ssd_flops()
                 + n_moe * moe_mlp_flops() + n_dense * dense_mlp_flops())
        p_count = (n_attn * attn_params() + n_ssd * ssd_params()
                   + n_moe * moe_params() + n_dense * mlp_params())
        expert_param_bytes = 0.0
        moe_dispatch_bytes = 0.0
        if n_moe:
            expert_param_bytes = (n_moe * cfg.n_experts * E * cfg.d_ff_expert
                                  * 3 * pdb)
            moe_dispatch_bytes = (T * cfg.top_k * cfg.capacity_factor
                                  * E * act_dtype_bytes)
        return SegmentMeta(
            name=name, n_layers=n_layers,
            fwd_flops=float(flops), param_bytes=float(p_count * pdb),
            act_bytes_per_layer=float(act_per_layer),
            n_experts=int(cfg.n_experts if n_moe else 0),
            n_moe_layers=int(n_moe),
            expert_param_bytes=float(expert_param_bytes),
            moe_dispatch_bytes=float(moe_dispatch_bytes))

    if cfg.family == "dense":
        segments = (stack_segment("stack", L, 0, 0, L, max(L, 1)),)
    elif cfg.family == "moe":
        n_moe = L // cfg.moe_every
        segments = (stack_segment("stack", L, 0, n_moe, L - n_moe,
                                  max(L, 1)),)
    elif cfg.family == "ssm":
        segments = (stack_segment("stack", 0, L, 0, 0, max(L, 1)),)
    else:                                            # hybrid
        n_attn = L // cfg.attn_period
        n_moe = L // 2
        segments = (stack_segment("stack", n_attn, L - n_attn, n_moe,
                                  L - n_moe, max(L, 1)),)

    head = 2 * T * E * V
    embed = V * E * (1 if cfg.tie_embeddings else 2)
    return ModelGraph(
        name=cfg.name, segments=segments, batch=batch,
        extra_fwd_flops=float(head),
        extra_param_bytes=float(embed * pdb),
        logits_bytes=float(T * V * 4),
        head_param_bytes=float(E * V * pdb))
