"""Core layers of the dense decoder: RMSNorm and LayerNorm, RoPE, the
MLP (gated or plain, through the reference's activation table),
embedding.

Plain functions on tensors over parameter dicts, with the same leaf names
and layouts as ``repro.models.layers`` so parameters cross between the two
packages unchanged; ``axes_*`` give each leaf's logical dims, as the
reference's.  Under sharding rules that split the model axis
(:mod:`repro_torch.core.sharding`) the MLP is column-parallel ``wg``/``wi``
and row-parallel ``wo`` with one all-reduce, and the embedding is
vocab-parallel.  Initialisers take an explicit ``torch.Generator`` and
``device``; they match the reference in distribution, not in bits (JAX and
PyTorch draw different numbers from the same seed).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import sharding


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape: tuple, dtype, device,
            stddev: float) -> torch.Tensor:
    """Drawn in ``dtype`` itself, so a large bf16 leaf needs no f32
    temporary (deepseek-moe-16b's stacked ``w_in`` would take 19.3 GiB)."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(stddev)


def dense_init(gen, in_dim: int, shape: tuple, dtype, device) -> torch.Tensor:
    """Fan-in scaled normal init (truncation omitted, as in the reference)."""
    return normal(gen, shape, dtype, device, 1.0 / math.sqrt(max(in_dim, 1)))


def init_rmsnorm(shape: tuple, dtype, device) -> dict:
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def init_layernorm(shape: tuple, dtype, device) -> dict:
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def init_mlp(gen, d_model: int, d_ff: int, dtype, device,
             lead: tuple = (), gated: bool = True) -> dict:
    p = {
        "wi": dense_init(gen, d_model, lead + (d_model, d_ff), dtype, device),
        "wo": dense_init(gen, d_ff, lead + (d_ff, d_model), dtype, device),
    }
    if gated:
        p["wg"] = dense_init(gen, d_model, lead + (d_model, d_ff), dtype,
                             device)
    return p


def init_embedding(gen, vocab: int, d_model: int, dtype, device) -> dict:
    # 1/sqrt(d) keeps the embedding output O(1/sqrt(d)); a norm follows it
    return {"table": normal(gen, (vocab, d_model), dtype, device,
                             1.0 / math.sqrt(d_model))}


def init_lm_head(gen, d_model: int, vocab: int, dtype, device) -> dict:
    return {"w": dense_init(gen, d_model, (d_model, vocab), dtype, device)}


def axes_rmsnorm() -> dict:
    return {"scale": ("embed",)}


def axes_layernorm() -> dict:
    return {"scale": ("embed",), "bias": ("embed",)}


def axes_mlp(gated: bool = True) -> dict:
    a = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if gated:
        a["wg"] = ("embed", "mlp")
    return a


def axes_embedding() -> dict:
    return {"table": ("vocab", "embed")}


def axes_lm_head() -> dict:
    return {"w": ("embed", "vocab")}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def make_norm(kind: str):
    """``(init, axes, apply)`` of the norm ``kind``: ``"rms"`` or ``"ln"``
    (the reference's ``make_norm``)."""
    if kind == "rms":
        return init_rmsnorm, axes_rmsnorm, rmsnorm
    if kind == "ln":
        return init_layernorm, axes_layernorm, layernorm
    raise ValueError(f"unknown norm {kind!r}")


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               mrope_sections: tuple | None = None) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, D) by ``positions``: split-halves rotation
    computed in f32.  ``positions`` is (B, S), or (B, 3, S) for M-RoPE
    (qwen2-vl's temporal, height and width components), where the
    frequency bands are partitioned into ``mrope_sections`` (summing to
    D/2) and each band rotates by its own component."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    if mrope_sections is None:
        ang = positions[..., None].float() * inv               # (B, S, d/2)
    else:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE wants (B, 3, S) positions, got "
                             f"{tuple(positions.shape)}")
        bounds = [0]
        for sec in mrope_sections:
            bounds.append(bounds[-1] + sec)
        ang = torch.cat([positions[:, i, :, None].float() * inv[lo:hi]
                         for i, (lo, hi) in enumerate(zip(bounds,
                                                          bounds[1:]))],
                        dim=-1)                                # (B, S, d/2)
    cos = torch.cos(ang)[..., None, :]                         # (B, S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


#: the reference's activation table; its gelu is the tanh approximation
#: (``jax.nn.gelu(approximate=True)``)
ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; the table holds "
                         f"{sorted(ACTS)}")


def mlp(params: dict, x: torch.Tensor, d_ff: int = 0,
        act: str = "silu") -> torch.Tensor:
    """Gated, (act(x·wg) ⊙ x·wi)·wo (SwiGLU, GeGLU), or, without ``wg``,
    act(x·wi)·wo; weights cast to the activation dtype.  Where the rules
    split the ``mlp`` dim of ``d_ff`` columns, the leaves are this rank's
    columns (rows of ``wo``): the input's gradient and the output are
    summed over the split's group."""
    split = sharding.split_of("mlp", d_ff) if d_ff else None
    x = sharding.copy_to(x, split)
    h = x @ params["wi"].to(x.dtype)
    if "wg" in params:
        h = ACTS[act](x @ params["wg"].to(x.dtype)) * h
    else:
        h = ACTS[act](h)
    return sharding.reduce_from(h @ params["wo"].to(x.dtype), split)


def embed(params: dict, tokens: torch.Tensor, vocab: int = 0) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``.  Where the rules split the
    ``vocab`` dim of ``vocab`` rows, ``table`` is this rank's rows: tokens
    outside them look up row 0 and are zeroed, and the sum over the
    split's group gives every token its row."""
    split = sharding.split_of("vocab", vocab) if vocab else None
    if split is None:
        return params["table"][tokens]
    rows = params["table"].shape[0]
    local = tokens - split.index * rows
    inside = (local >= 0) & (local < rows)
    x = params["table"][torch.where(inside, local, 0)]
    return sharding.reduce_from(
        torch.where(inside[..., None], x, torch.zeros_like(x)), split)


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad vocab to a shard-friendly multiple (Megatron-style)."""
    return ((vocab + multiple - 1) // multiple) * multiple
