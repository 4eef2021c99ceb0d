"""The encoder–decoder backbone (seamless-m4t), the port of
``repro.models.encdec``.

The audio frontend is a stub: the encoder takes precomputed (B, S_src, D)
frame embeddings (after the adapter of :mod:`repro_torch.models.frontends`).
Each tower's layers are stacked on a leading ``layers`` dim under
``encoder/…`` and ``decoder/…`` with the reference's leaf paths, so a
reference tree crosses over unchanged; the reference's ``lax.scan`` over
them is a Python loop here, each layer checkpointed under ``remat`` as
:func:`repro_torch.models.transformer.apply_stack` checkpoints a repeat.
An encoder layer is pre-norm self-attention (non-causal) and an MLP; a
decoder layer adds cross-attention over the encoder's memory between its
causal self-attention and its MLP.  Both towers rope their positions
0..S−1 (the reference's deviation from the original relative positions).

Every attention core is :func:`repro_torch.kernels.flash_attention.ops.
flash`, the flash kernels forward and backward on the card: the
encoder's non-causal at S_src, the decoder's causal at the target
length, the cross-attention non-causal at Sq ≠ Sk.  The reference's
encoder–decoder reaches no kernel (its blocked ``"ref"`` path computes
the same function).  Decoding keeps the self-attention KV cache and each
layer's cross K/V, computed once from the memory (:func:`init_dec_state`);
a step writes the self cache in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.attention import AttnCfg
from repro_torch.models.transformer import _remat_wrap, _unstack


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    d_model: int
    n_enc_layers: int
    n_dec_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    norm: str = "ln"
    act: str = "relu"
    gated_mlp: bool = False
    rope_theta: float = 10000.0
    remat: str = "full"
    attn_bwd_remat: bool = False

    def attn_cfg(self, causal: bool) -> AttnCfg:
        return AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                       n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                       causal=causal, rope_theta=self.rope_theta)


def _init_layer(gen, cfg: EncDecCfg, dtype, device, n: int,
                cross: bool) -> dict:
    norm_init = layers.make_norm(cfg.norm)[0]
    lead = (n,)
    p = {"norm1": norm_init(lead + (cfg.d_model,), dtype, device),
         "self_attn": attn_mod.init_attention(gen, cfg.attn_cfg(cross),
                                              dtype, device, lead),
         "norm3": norm_init(lead + (cfg.d_model,), dtype, device),
         "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                lead, gated=cfg.gated_mlp)}
    if cross:
        p["norm2"] = norm_init(lead + (cfg.d_model,), dtype, device)
        p["cross_attn"] = attn_mod.init_attention(gen, cfg.attn_cfg(False),
                                                  dtype, device, lead)
    return p


def _axes_layer(cfg: EncDecCfg, cross: bool) -> dict:
    norm_axes = layers.make_norm(cfg.norm)[1]
    a = {"norm1": norm_axes(),
         "self_attn": attn_mod.axes_attention(cfg.attn_cfg(cross)),
         "norm3": norm_axes(),
         "mlp": layers.axes_mlp(cfg.gated_mlp)}
    if cross:
        a["norm2"] = norm_axes()
        a["cross_attn"] = attn_mod.axes_attention(cfg.attn_cfg(False))
    return a


def init_encdec(gen, cfg: EncDecCfg, dtype, device) -> dict:
    return {"encoder": _init_layer(gen, cfg, dtype, device,
                                   cfg.n_enc_layers, False),
            "decoder": _init_layer(gen, cfg, dtype, device,
                                   cfg.n_dec_layers, True)}


def axes_encdec(cfg: EncDecCfg) -> dict:
    """Each leaf's logical dims, ``layers`` first (the stacked layers)."""
    def lead(tree):
        return {k: lead(v) if isinstance(v, dict) else ("layers",) + v
                for k, v in tree.items()}
    return {"encoder": lead(_axes_layer(cfg, False)),
            "decoder": lead(_axes_layer(cfg, True))}


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def _run(tower: dict, x: torch.Tensor, body, n: int, remat: str):
    """``x`` through the ``n`` stacked layers of ``tower``, each layer one
    checkpoint under ``remat``, under the caller's sharding rules (a
    checkpoint's recompute runs on the autograd engine's thread)."""
    rules = sharding.current_rules()

    def layer(x, lp):
        with sharding.use_rules(rules):
            return body(x, lp)

    step = _remat_wrap(layer, remat)
    for lp in _unstack(tower, n):
        x = step(x, lp)
    return x


def encode(params: dict, frames: torch.Tensor, cfg: EncDecCfg
           ) -> torch.Tensor:
    """frames: (B, S_src, D) (adapted) frame embeddings → the memory."""
    norm = layers.make_norm(cfg.norm)[2]
    acfg = cfg.attn_cfg(False)
    positions = _positions(frames)

    def body(x, lp):
        h = norm(lp["norm1"], x)
        x = x + attn_mod.attention(lp["self_attn"], h, positions, acfg,
                                   bwd_remat=cfg.attn_bwd_remat)
        h = norm(lp["norm3"], x)
        return x + layers.mlp(lp["mlp"], h, cfg.d_ff, cfg.act)

    return _run(params["encoder"], frames, body, cfg.n_enc_layers, cfg.remat)


def decode_train(params: dict, tokens_emb: torch.Tensor,
                 memory: torch.Tensor, cfg: EncDecCfg) -> torch.Tensor:
    """tokens_emb: (B, S_tgt, D) target embeddings and the encoder's
    ``memory`` (B, S_src, D) → the decoder's output (B, S_tgt, D)."""
    norm = layers.make_norm(cfg.norm)[2]
    self_cfg, cross_cfg = cfg.attn_cfg(True), cfg.attn_cfg(False)
    positions = _positions(tokens_emb)

    def body(x, lp):
        h = norm(lp["norm1"], x)
        x = x + attn_mod.attention(lp["self_attn"], h, positions, self_cfg,
                                   bwd_remat=cfg.attn_bwd_remat)
        h = norm(lp["norm2"], x)
        x = x + attn_mod.cross_attention(lp["cross_attn"], h, memory,
                                         cross_cfg,
                                         bwd_remat=cfg.attn_bwd_remat)
        h = norm(lp["norm3"], x)
        return x + layers.mlp(lp["mlp"], h, cfg.d_ff, cfg.act)

    return _run(params["decoder"], tokens_emb, body, cfg.n_dec_layers,
                cfg.remat)


# ---------------------------------------------------------------------------
# decode-time state
# ---------------------------------------------------------------------------

def init_dec_state(params: dict, memory: torch.Tensor, cfg: EncDecCfg,
                   batch: int, max_len: int, dtype) -> dict:
    """The self-attention KV cache, zeroed (L, B, max_len, K, D), and
    each layer's cross K/V (L, B, S_src, K, D) computed once from
    ``memory``."""
    acfg = cfg.attn_cfg(False)
    wk = params["decoder"]["cross_attn"]["wk"].to(memory.dtype)
    wv = params["decoder"]["cross_attn"]["wv"].to(memory.dtype)
    shape = (cfg.n_dec_layers, batch, max_len, acfg.n_kv_heads,
             acfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=memory.device),
            "v": torch.zeros(shape, dtype=dtype, device=memory.device),
            "ck": torch.einsum("bse,lekd->lbskd", memory, wk),
            "cv": torch.einsum("bse,lekd->lbskd", memory, wv)}


def axes_dec_state() -> dict:
    return {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
            "v": ("layers", "batch", "kv_seq", "kv_heads", None),
            "ck": ("layers", "batch", None, "kv_heads", None),
            "cv": ("layers", "batch", None, "kv_heads", None)}


def _cross_decode(lp: dict, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, cfg: AttnCfg) -> torch.Tensor:
    """One token's cross-attention against the precomputed (B, S_src, K,
    D) K/V: scores in f32, the probabilities rounded to the cache dtype
    before the value product, as the reference's."""
    B = x.shape[0]
    K, G, D = cfg.n_kv_heads, cfg.group, cfg.head_dim
    q = torch.einsum("be,ehd->bhd", x, lp["wq"].to(x.dtype))
    q = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), ck.float()) / (D ** 0.5)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(cv.dtype).float(),
                       cv.float())
    out = out.to(x.dtype).reshape(B, cfg.n_heads, D)
    return torch.einsum("bhd,hde->be", out, lp["wo"].to(x.dtype))


def decode_step(params: dict, x: torch.Tensor, state: dict,
                pos: torch.Tensor, cfg: EncDecCfg):
    """x: (B, D) the current target token's embedding → (y, state), the
    self cache written in place at ``pos`` (a ``pos`` past it writes
    nothing)."""
    norm = layers.make_norm(cfg.norm)[2]
    self_cfg, cross_cfg = cfg.attn_cfg(True), cfg.attn_cfg(False)
    n = cfg.n_dec_layers
    for lp, st in zip(_unstack(params["decoder"], n), _unstack(state, n)):
        h = norm(lp["norm1"], x)
        out, _, _ = attn_mod.decode_attention(lp["self_attn"], h, st["k"],
                                              st["v"], pos, self_cfg)
        x = x + out
        h = norm(lp["norm2"], x)
        x = x + _cross_decode(lp["cross_attn"], h, st["ck"], st["cv"],
                              cross_cfg)
        h = norm(lp["norm3"], x)
        x = x + layers.mlp(lp["mlp"], h, cfg.d_ff, cfg.act)
    return x, state
