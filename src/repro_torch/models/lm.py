"""The LM: one config dataclass → {init, loss_fn, prefill, serve_step}
for every family of the reference: the decoder families over the layer
stack (dense; moe; ssm, mamba2 with its embedding tied to its head;
hybrid, jamba's period of SSD blocks with one attention block and experts
on every other block; vlm, qwen2-vl's dense stack behind a stub vision
prefix and M-RoPE), each with ``serve_step_paged`` where every mixer is
attention, and encdec (seamless-m4t's two towers,
:mod:`repro_torch.models.encdec`); and the cost model's view of a config
(:func:`model_graph`, pure arithmetic).

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
shapes (``embed/table``, ``blocks/p0/attn/wq``, ``encdec/decoder/
cross_attn/wq``, ``adapter/w`` …), so
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
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import frontends, layers
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import AttnCfg
from repro_torch.models.encdec import EncDecCfg
from repro_torch.models.mamba2 import SSDCfg
from repro_torch.models.moe import MoECfg
from repro_torch.tree import tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LMCfg:
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | encdec
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
    mrope_sections: tuple | None = None   # vlm: M-RoPE's (t, h, w) bands
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
    # encdec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # the frontend stub: a linear adapter over precomputed embeddings
    frontend: str | None = None        # "vision" | "audio"
    frontend_len: int = 0              # vlm: patch positions at the head
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

    def attn_cfg(self, causal: bool = True) -> AttnCfg:
        return AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                       n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                       rope_theta=self.rope_theta, qk_norm=self.qk_norm,
                       mrope_sections=self.mrope_sections, causal=causal)

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

    def encdec_cfg(self) -> EncDecCfg:
        """The two towers' config, the reference's: ``rope_theta`` stays at
        its default there."""
        return EncDecCfg(d_model=self.d_model, n_enc_layers=self.n_enc_layers,
                         n_dec_layers=self.n_dec_layers, n_heads=self.n_heads,
                         n_kv_heads=self.n_kv_heads, head_dim=self.hd,
                         d_ff=self.d_ff, norm=self.norm, act=self.act,
                         gated_mlp=self.gated_mlp, remat=self.remat,
                         attn_bwd_remat=self.attn_bwd_remat)


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

    if cfg.family in ("dense", "vlm"):
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
        raise ValueError(f"family {cfg.family!r} has no layer stack (dense, "
                         f"vlm, moe, ssm, hybrid; encdec has two towers)")
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
        if cfg.family == "encdec":
            # an unknown norm or activation raises here, as in
            # build_stack_cfg, before a leaf is drawn
            layers.make_norm(cfg.norm)
            layers.check_act(cfg.act)
            self.ecfg, self.stack = cfg.encdec_cfg(), None
        else:
            self.ecfg, self.stack = None, build_stack_cfg(cfg)
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
        if self.stack is None:
            p["encdec"] = encdec_mod.init_encdec(gen, self.ecfg, dt, dev)
        else:
            p["blocks"] = tfm.init_stack(gen, self.stack, dt, dev)
        if cfg.frontend is not None:
            p["adapter"] = frontends.init_adapter(gen, cfg.d_model, dt, dev)
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
             "final_norm": layers.make_norm(self.cfg.norm)[1]()}
        if self.stack is None:
            a["encdec"] = encdec_mod.axes_encdec(self.ecfg)
        else:
            a["blocks"] = tfm.axes_stack(self.stack)
        if not self.cfg.tie_embeddings:
            a["head"] = layers.axes_lm_head()
        if self.cfg.frontend is not None:
            a["adapter"] = frontends.axes_adapter()
        return a

    def graph(self, batch: int, seq: int, *, act_dtype_bytes: int = 2,
              param_dtype_bytes: int = 4,
              src_seq: int | None = None) -> ModelGraph:
        """Segment-aware cost-model view of this model (see
        :func:`model_graph`), flattenable to a WorkloadMeta via
        ``.workload_meta()``; ``src_seq`` is an encoder–decoder's source
        length (default ``seq``)."""
        return model_graph(self.cfg, batch, seq,
                           act_dtype_bytes=act_dtype_bytes,
                           param_dtype_bytes=param_dtype_bytes,
                           src_seq=src_seq)

    # leaves (and subtrees: the experts' router) the reference reads in
    # f32 whatever the activation dtype
    F32_LEAVES = frozenset({"scale", "bias", "wdt", "dt_bias", "A_log",
                            "norm_scale", "router"})

    def serving_params(self, params: dict) -> dict:
        """``params`` with every weight cast once to the activation dtype,
        except :attr:`F32_LEAVES`.  Each product casts its weight to that
        dtype anyway, so the results are the same; serving then stops
        re-reading (and re-casting) f32 masters every step.  The norm
        scales and LayerNorm biases, dt's projection and bias, ``A_log``
        and the experts' router stay as they are: the reference reads
        them in f32, and casting them changes the result."""
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

    def positions(self, B: int, S: int, device=None) -> torch.Tensor:
        """The stack's positions: (B, 3, S) M-RoPE positions over the
        ``frontend_len`` patch prefix where the config has M-RoPE
        (:func:`~repro_torch.models.frontends.mrope_positions`; a shorter
        sequence raises), else (B, S)."""
        device = self.device if device is None else device
        if self.cfg.mrope_sections is not None:
            return frontends.mrope_positions(B, S, self.cfg.frontend_len,
                                             device=device)
        return torch.arange(S, device=device)[None].expand(B, S)

    def embed_tokens(self, params: dict, tokens: torch.Tensor,
                     batch: dict) -> torch.Tensor:
        """The tokens' embeddings in the activation dtype; for the vlm
        family with ``batch["patch_embeds"]`` (B, P, E), their adapted
        embeddings over the first ``frontend_len`` positions."""
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens,
                         cfg.padded_vocab).to(cfg.adtype)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            pe = torch.as_tensor(batch["patch_embeds"], device=x.device)
            pe = frontends.adapt(params["adapter"], pe.to(cfg.adtype))
            x = torch.cat([pe, x[:, cfg.frontend_len:]], dim=1)
        return x

    def encode(self, params: dict, frames) -> torch.Tensor:
        """An encoder–decoder's memory of ``frames`` (B, S_src, E): the
        frames in the activation dtype, through the adapter where the
        config has a frontend, then the encoder."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(cfg.adtype)
        if cfg.frontend is not None:
            x = frontends.adapt(params["adapter"], x)
        return encdec_mod.encode(params["encdec"], x, self.ecfg)

    # ---- training ----
    def loss_fn(self, params: dict, batch: dict):
        """batch {"tokens": (B, S) int, optional "loss_mask": (B, S)} →
        (loss, metrics), as the reference's ``Model.loss_fn``: next-token
        nll plus the z-loss, both over the masked token count, plus the
        experts' load-balance and router z-losses summed over the layers
        (``moe_lb``, ``moe_z``; zero without experts); the head cast to
        the activation dtype.  The loss head is :func:`fused_xent` on the
        card and :func:`chunked_xent` on the CPU.  An SSD mixer (mamba2's,
        jamba's) trains through the differentiable chunked scan (the
        reference's default ``ssd_impl``; the SSD kernel is forward only),
        and a tied head's gradient adds to the embedding table's.

        The vlm family takes optional ``"patch_embeds"`` (B, P, E),
        adapted and spliced over the first ``frontend_len`` positions,
        ropes by M-RoPE positions and masks every target inside the patch
        prefix.  The encdec family takes ``"frames"`` (B, S_src, E):
        :meth:`loss_encdec`.

        Under sharding rules ``params`` are this rank's blocks; under
        ZeRO-3 the leaves outside the stack are gathered over the data
        axes here, the stack's repeat by repeat in
        :func:`~repro_torch.models.transformer.apply_stack`."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return self.loss_encdec(params, batch)
        specs = sharding.fsdp_specs(self)
        if specs is not None:
            top = [k for k in params if k != "blocks"]
            params = dict(params, **sharding.gather_fsdp(
                {k: params[k] for k in top}, {k: specs[k] for k in top},
                sharding.current_rules()))
        tokens = batch["tokens"].long()
        B, S = tokens.shape
        x = self.embed_tokens(params, tokens, batch)
        x, aux = tfm.apply_stack(params["blocks"], x,
                                 self.positions(B, S, x.device), self.stack,
                                 None if specs is None else specs["blocks"])
        mask = torch.ones((B, S - 1), dtype=torch.float32, device=x.device)
        if "loss_mask" in batch:
            mask = mask * batch["loss_mask"][:, 1:]
        if cfg.family == "vlm":
            tgt = torch.arange(1, S, device=x.device)[None]
            mask = mask * (tgt >= cfg.frontend_len)
        nll, zl, n = self.head_loss(params, x, tokens, mask)
        n1 = n.clamp_min(1.0)
        loss = nll / n1 + zl / n1 + aux["lb_loss"] + aux["z_loss"]
        metrics = {"nll": nll / n1, "tokens": n, "moe_lb": aux["lb_loss"],
                   "moe_z": aux["z_loss"]}
        return loss, metrics

    def loss_encdec(self, params: dict, batch: dict):
        """The encoder–decoder's (loss, metrics), the reference's
        ``_loss_encdec``: ``frames`` through the adapter and the encoder,
        ``tokens[:, :-1]`` through the decoder against the memory, the
        next-token nll and z-loss over the target count; ``moe_lb`` and
        ``moe_z`` zero.  A ``loss_mask`` is not read, as in the
        reference."""
        tokens = batch["tokens"].long()
        memory = self.encode(params, batch["frames"])
        x = self.decode_train(params, tokens, memory)
        mask = torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                          device=x.device)
        nll, zl, n = self.xent_sums(params, self.final_norm(params, x),
                                    tokens[:, 1:], mask)
        n1 = n.clamp_min(1.0)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return (nll + zl) / n1, {"nll": nll / n1, "tokens": n,
                                 "moe_lb": zero, "moe_z": zero}

    def decode_train(self, params: dict, tokens: torch.Tensor,
                     memory: torch.Tensor) -> torch.Tensor:
        """The decoder's output (B, S − 1, E) for ``tokens[:, :-1]``
        against ``memory``."""
        x = layers.embed(params["embed"], tokens[:, :-1],
                         self.cfg.padded_vocab).to(self.cfg.adtype)
        return encdec_mod.decode_train(params["encdec"], x, memory,
                                       self.ecfg)

    def head_loss(self, params: dict, x: torch.Tensor, tokens: torch.Tensor,
                  mask: torch.Tensor):
        """(Σ nll, z_loss_coef·Σ lse², Σ mask) of next-token prediction
        from the stack's output ``x`` (B, S, E): :meth:`xent_sums` of the
        final-normed ``x[:, :-1]`` against ``tokens[:, 1:]``.  ``mask``
        (B, S − 1) weights the labels.  Reads only ``final_norm`` and the
        head (``embed`` when tied) of ``params``, so a pipeline's last
        stage calls it too."""
        return self.xent_sums(params, self.final_norm(params, x)[:, :-1],
                              tokens[:, 1:], mask)

    def xent_sums(self, params: dict, h: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor):
        """(Σ nll, z_loss_coef·Σ lse², Σ mask) of the final-normed hidden
        ``h`` (B, T, E) against ``labels`` (B, T): the head cast to the
        activation dtype, and the loss head chosen by device
        (:func:`fused_xent` on the card, :func:`chunked_xent` on the CPU)
        unless ``xent_impl`` picks one; vocab-parallel where the rules
        split the vocab.  A tied head, ``embed/table``ᵀ, is made
        contiguous in the same pass that casts it (the fused kernel reads
        (E, Vp) rows)."""
        cfg = self.cfg
        head_w = self._head_w(params).to(
            cfg.adtype, memory_format=torch.contiguous_format).contiguous()
        split = sharding.split_of("vocab", cfg.padded_vocab)
        impl = self.xent_impl or ("fused" if h.device.type == "cuda"
                                  else "chunked")
        if impl == "fused":
            return fused_xent(h, head_w, labels, mask, vocab=cfg.vocab,
                              z_loss_coef=cfg.z_loss_coef, split=split)
        return chunked_xent(h, head_w, labels, mask, vocab=cfg.vocab,
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

        The vlm family ropes the prompt by M-RoPE positions (a prompt
        shorter than ``frontend_len`` raises) and splices
        ``batch["patch_embeds"]`` where given; its first generated token
        then ropes at ``pos`` in every section, as the reference's does.
        The encdec family takes ``{"frames"}`` and no ``last_idx``
        (:meth:`prefill_encdec`).
        """
        cfg = self.cfg
        if cfg.family == "encdec":
            if last_idx is not None:
                raise ValueError("last_idx is not supported for encdec "
                                 "prefill (frame inputs are not padded)")
            return self.prefill_encdec(params, batch, gen_budget)
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self.embed_tokens(params, tokens, batch)
        positions = self.positions(B, S, x.device)
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

    def prefill_encdec(self, params: dict, batch: dict, gen_budget: int):
        """The reference's ``_prefill_encdec``: ``frames`` encoded, the
        decode state made from the memory (a self cache of
        ``max(gen_budget, 1)`` rows), and BOS (token 0) decoded at
        position 0 → (its logits (B, Vp), state with ``pos`` 1)."""
        memory = self.encode(params, batch["frames"])
        B = memory.shape[0]
        state = encdec_mod.init_dec_state(params["encdec"], memory,
                                          self.ecfg, B, max(gen_budget, 1),
                                          self.cfg.adtype)
        zeros = torch.zeros((B,), dtype=torch.int32, device=memory.device)
        logits, state = self._serve_encdec(params, zeros.long(), state, zeros)
        return logits, {"cache": state, "pos": zeros + 1}

    def _serve_encdec(self, params, tokens, cache, pos):
        x = layers.embed(params["embed"], tokens,
                         self.cfg.padded_vocab).to(self.cfg.adtype)
        x, cache = encdec_mod.decode_step(params["encdec"], x, cache, pos,
                                          self.ecfg)
        x = self.final_norm(params, x)
        return x @ self._head_w(params).to(self.cfg.adtype), cache

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
        if cfg.family == "encdec":
            logits, cache = self._serve_encdec(params, tokens,
                                               state["cache"], pos)
            return logits, {"cache": cache, "pos": pos + 1}
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
        makes a rank's block of it.  An encoder–decoder's cache holds the
        self KV and the cross K/V of a ``cache_len``-row memory, as the
        reference's template."""
        if self.stack is None:
            meta = Model(self.cfg, "meta")
            mem = torch.empty((batch, cache_len, self.cfg.d_model),
                              dtype=self.cfg.adtype, device="meta")
            cache = encdec_mod.init_dec_state(meta.param_shapes()["encdec"],
                                              mem, self.ecfg, batch,
                                              cache_len, self.cfg.adtype)
        else:
            cache = tfm.init_stack_state(self.stack, batch, cache_len,
                                         self.cfg.adtype, "meta")
        return _pairs({"cache": cache, "pos": torch.empty(
            (batch,), dtype=torch.int32, device="meta")})

    def state_axes(self) -> dict:
        """The dense decode state's logical dims (the reference's)."""
        cache = (encdec_mod.axes_dec_state() if self.stack is None
                 else tfm.axes_stack_state(self.stack))
        return {"cache": cache, "pos": ("batch",)}

    # ---- paged serving (block-table KV cache) ----
    @property
    def supports_paged(self) -> bool:
        """Paged KV needs every mixer to be attention (SSD state is O(1)
        per slot and gains nothing from pages); an encoder–decoder is
        never paged, as in the reference."""
        return self.stack is not None and all(
            b.mixer == "attn" for b in self.stack.pattern)

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
# The port of ``repro/models/lm.py::model_graph``.  Matmul-dominant terms
# only, in the reference's expressions and order, so a graph here equals
# the reference's bit for bit (tests/test_torch_planning.py).  One "stack"
# segment where every layer is interchangeable (dense, moe, ssm, hybrid);
# the vlm family adds an atomic vision-frontend segment before its
# decoder, and the encdec family is an encoder and a decoder segment
# (behind the audio frontend's), the decoder's cross-attention priced
# over the source tokens.


def model_graph(cfg: LMCfg, batch: int, seq: int,
                act_dtype_bytes: int = 2, param_dtype_bytes: int = 4,
                src_seq: int | None = None) -> ModelGraph:
    """Segment-aware workload description for one LMCfg.

    ``src_seq`` (encdec only): the source length fed to the encoder;
    defaults to ``seq`` (the target length).
    """
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

    def cross_attn_flops(t_q, t_kv, kv_len) -> float:
        # q/o projections ride the query tokens, k/v the source tokens;
        # the scores are full rank against the encoded source
        H, K = cfg.n_heads, cfg.n_kv_heads
        proj = 2 * t_q * E * (H * hd) + 2 * 2 * t_kv * E * (K * hd) \
            + 2 * t_q * (H * hd) * E
        scores = 2 * t_q * kv_len * H * hd * 2
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

    def adapter_segment(name: str, prefix_tokens: int) -> SegmentMeta:
        # frontends.init_adapter: one d_model×d_model projection + bias
        return SegmentMeta(
            name=name, n_layers=1, atomic=True,
            fwd_flops=float(2 * prefix_tokens * E * E),
            param_bytes=float((E * E + E) * pdb),
            act_bytes_per_layer=float(prefix_tokens * E
                                      * act_dtype_bytes * 4))

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
    elif cfg.family == "hybrid":
        n_attn = L // cfg.attn_period
        n_moe = L // 2
        segments = (stack_segment("stack", n_attn, L - n_attn, n_moe,
                                  L - n_moe, max(L, 1)),)
    elif cfg.family == "vlm":
        segments = (adapter_segment("vision-frontend",
                                    batch * cfg.frontend_len),
                    stack_segment("decoder", L, 0, 0, L, max(L, 1)))
    elif cfg.family == "encdec":
        s_src = seq if src_seq is None else src_seq
        t_src = batch * s_src
        n_enc, n_dec = cfg.n_enc_layers, cfg.n_dec_layers
        enc_flops = n_enc * (attn_flops(t_src, s_src, causal=False)
                             + dense_mlp_flops(t_src))
        dec_flops = n_dec * (attn_flops(T, seq, causal=True)
                             + cross_attn_flops(T, t_src, s_src)
                             + dense_mlp_flops(T))
        enc_params = n_enc * (attn_params() + mlp_params())
        dec_params = n_dec * (2 * attn_params() + mlp_params())
        enc_act = t_src * E * act_dtype_bytes * 4
        enc = SegmentMeta(name="encoder", n_layers=max(n_enc, 1),
                          fwd_flops=float(enc_flops),
                          param_bytes=float(enc_params * pdb),
                          act_bytes_per_layer=float(enc_act))
        dec = SegmentMeta(name="decoder", n_layers=max(n_dec, 1),
                          fwd_flops=float(dec_flops),
                          param_bytes=float(dec_params * pdb),
                          act_bytes_per_layer=float(act_per_layer))
        segments = (enc, dec)
        if cfg.frontend:
            segments = (adapter_segment(f"{cfg.frontend}-frontend", t_src),
                        ) + segments
    else:
        raise ValueError(f"unknown model family {cfg.family!r}")

    head = 2 * T * E * V
    embed = V * E * (1 if cfg.tie_embeddings else 2)
    return ModelGraph(
        name=cfg.name, segments=segments, batch=batch,
        extra_fwd_flops=float(head),
        extra_param_bytes=float(embed * pdb),
        logits_bytes=float(T * V * 4),
        head_param_bytes=float(E * V * pdb))
