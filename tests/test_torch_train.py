"""The port's training slice (``repro_torch``) against the reference
(``repro``) on the CPU: the differentiable flash and cross-entropy ops, the
LM loss and every gradient leaf, the optimizers, the data stream, the
checkpoint format, the fault-tolerant loop and the training driver.

Inputs, weights and cotangents are made with numpy (or by the reference,
then carried over as numpy), so both packages see the same values.  Where
the reference reaches a Pallas kernel it runs in interpret mode, as
tests/test_kernels.py runs it.  Tolerances follow the reference's policy
(tests/torch_harness.py): values f32 2e-5 / bf16 2e-2, gradients f32 2e-4
/ bf16 5e-2.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.kernels.flash_attention import ops as jax_flash_ops
from repro.kernels.flash_attention.flash import (
    flash_attention as jax_flash_fwd, flash_attention_bwd as jax_flash_bwd)
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.xent import ops as jax_xent_ops
from repro.kernels.xent.xent import xent_fwd as jax_xent_fwd
from repro.models import lm as jax_lm
from repro.optim import optimizer as jax_opt
from repro.runtime.fault_tolerance import FaultTolerantLoop as JaxLoop
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.data import pipeline
from repro_torch.kernels.flash_attention import flash
from repro_torch.kernels.flash_attention.ops import flash as flash_op
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.kernels.xent import xent
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.optim import optimizer as opt
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.tree import flatten

from torch_harness import TOLS, check_vjp, close, cotangents, np_inputs

ARCH = "tinyllama-1.1b"


def jax_value_and_vjp(fn, args, *, diff_argnums, dtype, cts):
    """The JAX half of a gradient check: ``fn``'s outputs and its VJP for
    the cotangents ``cts`` (the same numpy arrays the port gets)."""
    jargs = [jnp.asarray(a, dtype) if np.issubdtype(a.dtype, np.floating)
             else jnp.asarray(a) for a in args]

    def f(*diff):
        full = list(jargs)
        for i, d in zip(diff_argnums, diff):
            full[i] = d
        out = fn(*full)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    outs, vjp = jax.vjp(f, *(jargs[i] for i in diff_argnums))
    grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cts, outs)))
    return ([np.asarray(o, np.float32) for o in outs],
            [np.asarray(g, np.float32) for g in grads])


def _tree_np(tree) -> dict:
    """A JAX tree → {leaf path: f32 numpy}."""
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


# ---------------------------------------------------------------------------
# the differentiable flash op
# ---------------------------------------------------------------------------

FLASH_CASES = [
    (1, 64, 64, 4, 4, 32, True),       # MHA
    (2, 64, 64, 4, 2, 32, True),       # GQA group 2
    (1, 64, 64, 8, 1, 16, True),       # MQA
    (1, 32, 64, 4, 2, 32, False),      # cross shape: Sq != Sk, no mask
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bwd_remat", [True, False])
def test_flash_op_values_and_vjps_match_reference(B, Sq, Sk, H, K, D, causal,
                                                  dtype, bwd_remat):
    args = np_inputs((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D), seed=Sq + H)
    cts = cotangents([(B, Sq, H, D)], seed=K)
    kw = dict(diff_argnums=(0, 1, 2), dtype=dtype, cts=cts)
    port = lambda q, k, v: flash_op(q, k, v, causal, bwd_remat)
    want_kernel = jax_value_and_vjp(
        lambda q, k, v: jax_flash_ops.flash(q, k, v, causal, 32, 32, True,
                                            bwd_remat), args, **kw)
    want_oracle = jax_value_and_vjp(
        lambda q, k, v: attention_ref(q, k, v, causal=causal), args, **kw)
    check_vjp(port, args, want_kernel, msg="vs reference flash", **kw)
    check_vjp(port, args, want_oracle, msg="vs attention_ref", **kw)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal", FLASH_CASES)
def test_flash_bwd_plain_matches_reference_bwd(B, Sq, Sk, H, K, D, causal):
    """The same (q, k, v, do, lse, δ) into the reference's fused backward
    (interpret mode) and the port's plain version, f32."""
    q, k, v, do = np_inputs((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D),
                            (B, Sq, H, D), seed=3)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jax_flash_fwd(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                           interpret=True, return_lse=True)
    delta = jnp.sum(jdo * o, axis=-1).reshape(B, Sq, K, H // K)
    want = jax_flash_bwd(jq, jk, jv, jdo, lse, delta, causal=causal,
                         block_q=32, block_k=32, interpret=True)
    t = lambda a: torch.tensor(np.asarray(a))
    got = flash.flash_attention_bwd(t(q), t(k), t(v), t(do), t(lse),
                                    t(delta), causal)
    for g, w in zip(got, want):
        close(g, w, TOLS["float32"].grad)


def _bwd_tensor_core_rounding(q, k, v, do, lse, delta, causal):
    """The bf16 backward kernels' rounding points in plain torch: bf16
    inputs; s = q·kᵀ and dp = do·vᵀ in f32; p = exp(τ·s − lse) and
    ds = p∘(dp − δ) in f32, then each rounded to bf16 before the three
    gradient products, which sum in f32; τ on dq and dk at the end, and
    one rounding to bf16 on the way out."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    tau = D ** -0.5
    qf = q.float().reshape(B, Sq, K, G, D)
    dof = do.float().reshape(B, Sq, K, G, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf)
    p = torch.exp(s * tau - lse.permute(0, 2, 3, 1)[..., None])
    if causal:
        p = torch.where(torch.arange(Sq)[:, None] >= torch.arange(Sk), p, 0.)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * tau
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * tau
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return (dq.reshape(B, Sq, H, D).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,block", [
    (1, 256, 256, 16, 2, 64, True, 128),     # G=8, as tinyllama's heads
    (1, 200, 300, 4, 2, 128, False, 100),    # Sq != Sk, G=2, D=128
    (2, 100, 100, 8, 2, 64, True, 50),       # ragged: no multiple of 64
])
def test_flash_bwd_tensor_core_rounding_matches_reference(B, Sq, Sk, H, K, D,
                                                          causal, block):
    """The bf16 kernels' precision design (p and ds rounded to bf16 before
    the products) against the reference's fused backward in bf16
    (interpret mode), at the bf16 gradient tolerance."""
    q, k, v, do = np_inputs((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D),
                            (B, Sq, H, D), seed=Sq + D)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    o, lse = jax_flash_fwd(jq, jk, jv, causal=causal, block_q=block,
                           block_k=block, interpret=True, return_lse=True)
    delta = jnp.sum(jdo.astype(jnp.float32) * o.astype(jnp.float32),
                    axis=-1).reshape(B, Sq, K, H // K)
    want = jax_flash_bwd(jq, jk, jv, jdo, lse, delta, causal=causal,
                         block_q=block, block_k=block, interpret=True)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    got = _bwd_tensor_core_rounding(
        *(t(a).bfloat16() for a in (q, k, v, do)), t(lse), t(delta), causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        close(g.float(), np.asarray(w, np.float32), TOLS["bfloat16"].grad)


def _fwd_tensor_core_rounding(q, k, v, causal, block=64):
    """The bf16 forward kernel's rounding points in plain torch: bf16
    inputs; per tile of ``block`` keys, s = q·kᵀ in f32, then τ·s in f32;
    the running max m, p = exp(τ·s − m) in f32 and l summed from that f32
    p; p rounded to bf16 before P·V, which sums in f32; one rounding of
    o = acc / l to bf16; lse = m + log l in f32."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    tau = D ** -0.5
    qf = q.float().reshape(B, Sq, K, G, D)
    kf, vf = k.float(), v.float()
    m = torch.full((B, K, G, Sq), flash.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, Sq, D))
    for k0 in range(0, Sk, block):
        keys = torch.arange(k0, min(k0 + block, Sk))
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, keys]) * tau
        if causal:
            s = torch.where(torch.arange(Sq)[:, None] >= keys, s,
                            flash.NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - mx[..., None])
        corr = torch.exp(m - mx)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.bfloat16().float(), vf[:, keys])
        m = mx
    o = acc / l.clamp_min(1e-30)[..., None]
    lse = m + torch.log(l.clamp_min(1e-30))
    return (o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).bfloat16(),
            lse.permute(0, 3, 1, 2))


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,block", [
    (1, 256, 256, 16, 2, 64, True, 128),     # G=8, as tinyllama's heads
    (1, 200, 300, 4, 2, 128, False, 100),    # Sq != Sk, G=2, D=128
    (2, 100, 100, 8, 2, 64, True, 50),       # ragged: no multiple of 64
])
def test_flash_fwd_tensor_core_rounding_matches_reference(B, Sq, Sk, H, K, D,
                                                          causal, block):
    """The bf16 forward kernel's precision design (p rounded to bf16 before
    P·V, relative to the running max of 64-key tiles) against the
    reference's forward in bf16 (interpret mode), at the bf16 value
    tolerance, o and lse."""
    q, k, v = np_inputs((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D),
                        seed=Sq + D + 1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want_o, want_lse = jax_flash_fwd(jq, jk, jv, causal=causal,
                                     block_q=block, block_k=block,
                                     interpret=True, return_lse=True)
    t = lambda a: torch.tensor(np.asarray(a, np.float32)).bfloat16()
    o, lse = _fwd_tensor_core_rounding(t(q), t(k), t(v), causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    close(o.float(), np.asarray(want_o, np.float32), TOLS["bfloat16"].fwd)
    close(lse, np.asarray(want_lse), TOLS["bfloat16"].fwd)


def test_flash_bwd_wrappers_count_nothing_on_cpu_and_reject_meta():
    q, k, v, do = (torch.tensor(a) for a in np_inputs(
        (1, 16, 4, 64), (1, 16, 2, 64), (1, 16, 2, 64), (1, 16, 4, 64)))
    o, lse = flash.flash_attention(q, k, v)
    delta = (do * o).sum(-1).reshape(1, 16, 2, 2)
    n0 = (flash.flash_bwd_dq.launches, flash.flash_bwd_dkv.launches)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta)
    want = flash.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    assert (flash.flash_bwd_dq.launches, flash.flash_bwd_dkv.launches) == n0
    meta = [x.to("meta") for x in (q, k, v, do, lse, delta)]
    for fn in (flash.flash_bwd_dq, flash.flash_bwd_dkv):
        with pytest.raises(ValueError):
            fn(*meta)


# ---------------------------------------------------------------------------
# the fused cross-entropy
# ---------------------------------------------------------------------------

def _xent_args(T, E, V, vocab, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, E)).astype(np.float32)
    w = (rng.standard_normal((E, V)) / np.sqrt(E)).astype(np.float32)
    labels = rng.integers(0, vocab, T).astype(np.int32)
    labels[0] = vocab - 1
    return h, w, labels


@pytest.mark.parametrize("T,E,V,vocab", [(64, 32, 512, 512),
                                         (128, 48, 512, 500)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_fwd_plain_matches_reference(T, E, V, vocab, dtype):
    h, w, labels = _xent_args(T, E, V, vocab)
    want = jax_xent_fwd(jnp.asarray(h, dtype), jnp.asarray(w, dtype),
                        jnp.asarray(labels), vocab=vocab, block_t=32,
                        block_v=128, interpret=True)
    tdt = getattr(torch, dtype)
    got = xent.xent_fwd(torch.tensor(h).to(tdt), torch.tensor(w).to(tdt),
                        torch.tensor(labels), vocab)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        close(g, w_, TOLS[dtype].fwd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("tile_bytes", [1 << 27, 64 * 256 * 4])
def test_xent_vjps_match_reference(dtype, with_lse, tile_bytes, monkeypatch):
    """Both VJPs (nll only, and nll with lse) with random cotangents and a
    padded vocab; ``tile_bytes`` 64·256·4 splits the backward into two
    vocab chunks."""
    monkeypatch.setattr(xent, "BWD_TILE_BYTES", tile_bytes)
    T, E, V, vocab = 64, 32, 512, 500
    args = list(_xent_args(T, E, V, vocab, seed=1))
    n_out = 2 if with_lse else 1
    cts = cotangents([(T,)] * n_out, seed=2)
    kw = dict(diff_argnums=(0, 1), dtype=dtype, cts=cts)
    if with_lse:
        ref = lambda h, w, lab: jax_xent_ops.xent_with_lse(
            h, w, lab, vocab, 32, 128, True)
        port = lambda h, w, lab: xent_ops.xent_with_lse(h, w, lab, vocab)
    else:
        ref = lambda h, w, lab: jax_xent_ops.xent(h, w, lab, vocab, 32, 128,
                                                  True)
        port = lambda h, w, lab: xent_ops.xent(h, w, lab, vocab)
    check_vjp(port, args, jax_value_and_vjp(ref, args, **kw), **kw)


def _xent_tensor_core_partition(h, w, labels, vocab, nseg):
    """The bf16 forward kernel's partition of the vocab in plain torch:
    ``nseg`` segments of whole 128-column tiles; in a tile, 2 column warps
    of 64 and in each the 4 lanes of a quad, a lane owning columns
    8n + 2·lane + {0, 1}; each lane keeps its own running (m, l) over its
    segment's tiles, and the label's logit is one lane's c.  Then the
    merges: the quad, the two column warps, the segments."""
    rows, tile, _ = xent.FWD_TILE[torch.bfloat16]
    logits = h.float() @ w.float()
    T, V = logits.shape
    tps = -(-(-(-V // tile)) // nseg)            # tiles per segment
    width = nseg * tps * tile
    col = torch.arange(width)
    x = torch.full((T, width), xent.NEG_INF)
    x[:, :V] = logits
    x = torch.where(col < vocab, x, xent.NEG_INF)
    c = torch.where(col == labels.long()[:, None], x, 0.).sum(-1)
    # column = ((segment·tps + tile)·2 + warp)·64 + n·8 + lane·2 + e
    x = x.reshape(T, nseg, tps, 2, 8, 4, 2).permute(0, 1, 3, 5, 2, 4, 6)
    x = x.reshape(T, nseg, 2, 4, tps, 16)
    m = torch.full((T, nseg, 2, 4), xent.NEG_INF)
    l = torch.zeros_like(m)
    for i in range(tps):
        mx = torch.maximum(m, x[..., i, :].amax(-1))
        l = l * torch.exp(m - mx) + torch.exp(
            x[..., i, :] - mx[..., None]).sum(-1)
        m = mx
    for dim in (3, 2, 1):            # the quad, the column warps, segments
        mm = m.amax(dim, keepdim=True)
        l = (l * torch.exp(m - mm)).sum(dim)
        m = mm.squeeze(dim)
    lse = torch.log(l.clamp_min(1e-30)) + m
    return lse - c, lse


@pytest.mark.parametrize("T,E,V,vocab,nseg", [
    (64, 32, 1024, 1000, 3),    # padded vocab, segments of 3, 3 and 2 tiles
    (96, 48, 640, 600, 4),      # the last segment holds no tile
    (64, 40, 512, 512, 1),      # one segment, E not a multiple of 16
])
def test_xent_fwd_tensor_core_partition_matches_reference(T, E, V, vocab,
                                                          nseg):
    """The bf16 kernel's partial (m, l, c) per lane, column warp and vocab
    segment, merged, against the reference's forward in bf16 (interpret
    mode) at the f32 value tolerance: bf16 products are exact in f32, so
    only the order of the sums differs.  Labels sit on the last real
    column, on both sides of a segment edge and on a column-warp edge."""
    h, w, labels = _xent_args(T, E, V, vocab, seed=T + E)
    edge = -(-(-(-V // 128)) // nseg) * 128
    labels[1:5] = [min(edge, vocab - 1), edge - 1, 64, 63]
    want = jax_xent_fwd(jnp.asarray(h, jnp.bfloat16),
                        jnp.asarray(w, jnp.bfloat16), jnp.asarray(labels),
                        vocab=vocab, block_t=32, block_v=128, interpret=True)
    bf = lambda a: torch.tensor(a).bfloat16()
    got = _xent_tensor_core_partition(bf(h), bf(w), torch.tensor(labels),
                                      vocab, nseg)
    for g, w_ in zip(got, want):
        close(g, w_, TOLS["float32"].fwd)


def test_xent_wrappers_count_nothing_on_cpu_and_reject_meta():
    h, w, labels = (torch.tensor(a) for a in _xent_args(16, 8, 64, 60))
    n0 = (xent.xent_fwd.launches, xent.xent_bwd.launches)
    nll, lse = xent.xent_fwd(h, w, labels, 60)
    logits = h @ w
    xent.xent_bwd(logits, lse, labels, torch.ones(16), torch.ones(16), 0, 60)
    assert (xent.xent_fwd.launches, xent.xent_bwd.launches) == n0
    with pytest.raises(ValueError):
        xent.xent_fwd(h.to("meta"), w.to("meta"), labels.to("meta"), 60)
    with pytest.raises(ValueError):
        xent.xent_bwd(logits.to("meta"), *(x.to("meta") for x in (
            lse, labels, lse, lse)), 0, 60)
    assert xent.bwd_chunk(8188, 32000) == 4096
    assert xent.bwd_chunk(16, 512) == 512
    assert xent.segments(8188, 32000, 132) == 4       # bf16: 128 x 128 tiles
    assert xent.segments(8188, 32000, 132, torch.float32) == 8


@pytest.mark.parametrize("use_mask", [False, True])
def test_loss_heads_match_reference(use_mask):
    """chunked_xent and fused_xent against the reference's (the fused one
    in interpret mode): the three sums and their gradients with respect
    to hidden and head_w."""
    B, T, E, Vp, vocab = 2, 40, 32, 256, 250
    rng = np.random.default_rng(5)
    h = rng.standard_normal((B, T, E)).astype(np.float32)
    w = (rng.standard_normal((E, Vp)) / np.sqrt(E)).astype(np.float32)
    labels = rng.integers(0, vocab, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.3 if use_mask
            else np.ones((B, T))).astype(np.float32)
    cts = cotangents([()] * 3, seed=6)
    kw = dict(diff_argnums=(0, 1), dtype="float32", cts=cts)
    args = [h, w, labels, mask]
    want_chunked = jax_value_and_vjp(
        lambda h, w, lab, m: jax_lm.chunked_xent(
            h, w, lab, m, vocab=vocab, chunk=16, z_loss_coef=1e-3),
        args, **kw)
    want_fused = jax_value_and_vjp(
        lambda h, w, lab, m: jax_lm.fused_xent(
            h, w, lab, m, vocab=vocab, block_t=16, block_v=128,
            z_loss_coef=1e-3, interpret=True), args, **kw)
    chunked = lambda h, w, lab, m: lm.chunked_xent(
        h, w, lab, m, vocab=vocab, chunk=16, z_loss_coef=1e-3)
    fused = lambda h, w, lab, m: lm.fused_xent(
        h, w, lab, m, vocab=vocab, z_loss_coef=1e-3)
    for port in (chunked, fused):
        for want in (want_chunked, want_fused):
            check_vjp(port, args, want, **kw)


# ---------------------------------------------------------------------------
# the model's loss and every gradient leaf
# ---------------------------------------------------------------------------

_REF_LOSS: dict = {}


def _ref_loss(impl: str, use_mask: bool):
    """(params numpy tree, batch, loss, nll, grads numpy tree) of the
    reference's ``value_and_grad(Model.loss_fn)`` at the smoke config."""
    key = (impl, use_mask)
    if key not in _REF_LOSS:
        jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                                   attn_impl=impl, xent_impl=impl,
                                   attn_block_q=11, attn_block_k=11,
                                   xent_block_t=16, xent_block_v=128)
        jm = jax_lm.build(jcfg)
        jp = jm.init(jax.random.key(0))
        rng = np.random.default_rng(7)
        batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 33)).astype(
            np.int32)}
        if use_mask:
            batch["loss_mask"] = (rng.random((2, 33)) > 0.25).astype(
                np.float32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, met), g = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
        _REF_LOSS[key] = (_tree_np(jp), batch, float(loss),
                          float(met["nll"]), _tree_np(g))
    return _REF_LOSS[key]


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_fn_and_every_gradient_leaf_match_reference(impl, use_mask,
                                                         remat):
    ptree, batch, loss, nll, grads = _ref_loss(impl, use_mask)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), remat=remat)
    model = lm.Model(cfg, "cpu")
    params = params_from_numpy(cfg, ptree, "cpu")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    got_loss, metrics, got = planner.loss_and_grads(model, params, tb)
    tol = TOLS["float32"]
    close(got_loss, loss, tol.fwd)
    close(metrics["nll"], nll, tol.fwd)
    assert float(metrics["moe_lb"]) == float(metrics["moe_z"]) == 0.0
    paths, leaves = flatten(got)
    assert set(paths) == set(grads)
    for path, g in zip(paths, leaves):
        np.testing.assert_allclose(g.numpy(), grads[path], atol=tol.grad,
                                   rtol=tol.grad, err_msg=path)


def test_stack_rejects_an_unknown_remat_mode():
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), remat="some")
    model = lm.Model(cfg, "cpu")
    with pytest.raises(ValueError, match="remat"):
        model.loss_fn(model.init(0), {"tokens": torch.zeros((1, 8),
                                                            dtype=torch.long)})


def test_param_count_matches_reference():
    cfg = get_config(ARCH)
    shapes = jax_lm.build(jax_get_config(ARCH)).param_shapes()
    assert lm.param_count(lm.Model(cfg, "meta").init(0)) == \
        jax_lm.param_count(shapes)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "b": {"x": rng.standard_normal((7,)).astype(np.float32),
                  "m": rng.standard_normal((6, 2)).astype(np.float32)}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"weight_decay": 0.1}),
    ("adafactor", {}), ("sgd", {"lr": 1e-2})])
def test_optimizers_match_reference_over_three_steps(name, kw):
    if name != "sgd":
        kw = dict(kw, lr=jax_opt.Schedule(base_lr=1e-2, warmup=2,
                                          decay_steps=3))
        port_kw = dict(kw, lr=opt.Schedule(base_lr=1e-2, warmup=2,
                                           decay_steps=3))
    else:
        port_kw = kw
    jo = jax_opt.get_optimizer(name, **kw)
    to = opt.get_optimizer(name, **port_kw)
    p0 = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = _to_torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = _opt_tree(step + 1)
        jp, js = jo.apply(jax.tree.map(jnp.asarray, g), js, jp, step)
        tp, ts = to.apply(_to_torch(g), ts, tp, step)
        for want, got in ((jp, tp), (js, ts)):
            w_np = _tree_np(want)
            g_paths, g_leaves = flatten(got)
            assert g_paths == list(w_np), (g_paths, list(w_np))
            for path, leaf in zip(g_paths, g_leaves):
                close(leaf, w_np[path], TOLS["float32"].fwd)


def test_schedule_and_clipping_match_reference():
    js = jax_opt.Schedule(base_lr=3e-4, warmup=5, decay_steps=20)
    ts = opt.Schedule(base_lr=3e-4, warmup=5, decay_steps=20)
    for step in (0, 1, 4, 5, 6, 12, 19, 20, 30):
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-6, abs=0)
    tree = _opt_tree(3)
    jt, tt = jax.tree.map(jnp.asarray, tree), _to_torch(tree)
    close(opt.global_norm(tt), jax_opt.global_norm(jt), 1e-6)
    for max_norm in (0.5, 1e6):
        want, wn = jax_opt.clip_by_global_norm(jt, max_norm)
        got, gn = opt.clip_by_global_norm(tt, max_norm)
        close(gn, wn, 1e-6)
        w_np = _tree_np(want)
        for path, leaf in zip(*flatten(got)):
            close(leaf, w_np[path], 1e-6)


# ---------------------------------------------------------------------------
# data, checkpoint, fault-tolerant loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["synthetic", "tokens_file"])
def test_token_pipeline_is_byte_identical_with_state_and_reshard(source,
                                                                 tmp_path):
    path = None
    if source == "tokens_file":
        path = str(tmp_path / "toks.bin")
        toks = np.random.default_rng(0).integers(0, 500, 40 * 16)
        pipeline.write_token_file(path, toks)
        assert np.array_equal(np.fromfile(path, np.int32), toks)
    mk = lambda mod: mod.DataCfg(global_batch=4, seq_len=16, vocab=500,
                                 seed=3, source=source, path=path,
                                 steps_per_epoch=3)
    ours = pipeline.TokenPipeline(mk(pipeline), host_id=0, n_hosts=1)
    ref = jax_pipeline.TokenPipeline(mk(jax_pipeline), host_id=0, n_hosts=1)
    for _ in range(4):
        a, b = ours.next_batch()["tokens"], ref.next_batch()["tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ours.state_dict() == ref.state_dict() == {"epoch": 1, "step": 1,
                                                     "seed": 3}
    resumed = pipeline.TokenPipeline(mk(pipeline), host_id=0, n_hosts=1)
    resumed.load_state_dict(ours.state_dict())
    halves = [ours.reshard(host_id=h, n_hosts=2) for h in (0, 1)]
    ref_halves = [ref.reshard(host_id=h, n_hosts=2) for h in (0, 1)]
    whole = resumed.next_batch()["tokens"]
    got = np.concatenate([p.next_batch()["tokens"] for p in halves])
    want = np.concatenate([p.next_batch()["tokens"] for p in ref_halves])
    assert got.tobytes() == want.tobytes() == whole.tobytes()
    with pytest.raises(ValueError):
        pipeline.TokenPipeline(mk(pipeline), host_id=0, n_hosts=3)


def _state_tree(seed=0):
    rng = np.random.default_rng(seed)
    p = {"embed": {"table": rng.standard_normal((5, 3)).astype(np.float32)},
         "blocks": {"p0": {"w": rng.standard_normal((2, 3, 4)).astype(
             np.float32)}}}
    return {"params": p, "opt": {"mu": p, "nu": p}}


def test_checkpoints_cross_between_the_packages(tmp_path):
    tree = _state_tree()
    # the port writes, the reference restores
    ours = CheckpointManager(str(tmp_path / "a"), keep=2)
    ours.save(3, _to_torch(tree), extra={"data": {"epoch": 0, "step": 3,
                                                  "seed": 0}})
    ref = JaxCheckpointManager(str(tmp_path / "a"), keep=2)
    target = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, tree))
    step, got, extra = ref.restore_latest(target)
    assert step == 3 and extra == {"data": {"epoch": 0, "step": 3,
                                            "seed": 0}}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the reference writes, the port restores (and carries it as state)
    ref2 = JaxCheckpointManager(str(tmp_path / "b"))
    ref2.save(7, jax.tree.map(jnp.asarray, _state_tree(1)))
    step, back, _ = CheckpointManager(str(tmp_path / "b")).restore_latest(
        _to_torch(tree))
    want = _state_tree(1)
    assert step == 7
    assert flatten(back)[0] == _leaf_paths(jax.tree.map(jnp.asarray, want))
    for a, b in zip(flatten(back)[1], flatten(want)[1]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_checkpoint_leaf_mismatch_retention_and_commit_marker(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    tree = _to_torch(_state_tree())
    for s in (1, 2, 3):
        ck.save_async(s, tree)
    ck.wait()
    assert ck.all_steps() == [2, 3]
    assert not (tmp_path / "step_00000001").exists()
    # a step without its COMMITTED marker is never read
    os.remove(tmp_path / "step_00000003.COMMITTED")
    assert ck.latest_step() == 2
    other = {"params": tree["params"],
             "opt": {"mu": tree["opt"]["mu"], "v": tree["opt"]["nu"]}}
    with pytest.raises(ValueError, match="does not match"):
        ck.restore(2, other)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(2, {"params": tree["params"]})
    bad = _to_torch(_state_tree())
    bad["params"]["embed"]["table"] = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(2, bad)


def _loop_pair(tmp_path, name):
    ours = FaultTolerantLoop(CheckpointManager(str(tmp_path / f"o{name}")),
                             save_every=2, max_retries=2, async_save=False)
    ref = JaxLoop(JaxCheckpointManager(str(tmp_path / f"r{name}")),
                  save_every=2, max_retries=2, async_save=False)
    return ours, ref


def test_fault_tolerant_loop_retries_saves_stops_and_aborts_as_reference(
        tmp_path):
    def run(loop, fail_times, stop_at=None, abort_at=None, n=5):
        calls = {"n": 0}

        def step_fn(step, state):
            if step == 1 and calls["n"] < fail_times:
                calls["n"] += 1
                raise RuntimeError("CUDA launch failed")
            return {"x": state["x"] + 1}

        def on_step(step, state, dt):
            if step == stop_at:
                loop.request_stop()
            if step == abort_at:
                loop.request_abort()

        tensor = isinstance(loop, FaultTolerantLoop)
        x0 = torch.zeros(()) if tensor else jnp.zeros(())
        try:
            out = loop.run(state={"x": x0}, step_fn=step_fn, n_steps=n,
                           extra_fn=lambda st, s: {"at": s},
                           on_step=on_step)
        except RuntimeError:
            out = ("raised", None)
        return out[0], loop.ckpt.all_steps(), calls["n"], loop.aborted

    for i, kw in enumerate([{"fail_times": 2}, {"fail_times": 3},
                            {"fail_times": 0, "stop_at": 2},
                            {"fail_times": 0, "abort_at": 2}]):
        ours, ref = _loop_pair(tmp_path, i)
        assert run(ours, **kw) == run(ref, **kw), kw
    # retries exhausted: the final save commits the failed step
    ours, _ = _loop_pair(tmp_path, "x")
    assert run(ours, fail_times=5)[:2] == ("raised", [1])
    assert ours.ckpt.restore(1, {"x": torch.zeros(())})[1] == {"at": 1}


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

def _reference_run(steps: int, micro_batches: int, batch=2, seq=32):
    """(initial params, initial opt state, data state, losses) of a
    reference loop from the unmeshed pieces: value_and_grad(loss_fn),
    micro-batch averaging as ``train_step_fn`` does, adamw.apply and the
    TokenPipeline, with the driver's schedule."""
    jcfg = jax_get_config(ARCH, smoke=True)
    jm = jax_lm.build(jcfg)
    params = jm.init(jax.random.key(0))
    sched = jax_opt.Schedule(base_lr=3e-4, warmup=min(100, steps // 10 + 1),
                             decay_steps=steps)
    o = jax_opt.adamw(lr=sched)
    state = o.init(params)
    data = jax_pipeline.TokenPipeline(
        jax_pipeline.DataCfg(global_batch=batch, seq_len=seq,
                             vocab=jcfg.vocab, seed=0), host_id=0, n_hosts=1)
    init = (params, state, data.state_dict())
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    losses = []
    for i in range(steps):
        toks = jnp.asarray(data.next_batch()["tokens"])
        parts = jnp.split(toks, micro_batches)
        outs = [grad_fn(params, {"tokens": t}) for t in parts]
        loss = sum(l for (l, _), _ in outs) / micro_batches
        g = jax.tree.map(lambda *x: sum(x) / micro_batches,
                         *(g for _, g in outs))
        params, state = o.apply(g, state, params, i)
        losses.append(float(loss))
    return init, losses


@pytest.fixture(scope="module")
def reference_runs():
    return {m: _reference_run(3, m) for m in (1, 2)}


def _seed_ckpt(directory, init):
    """Step 0 of the reference's state, written by the reference: the port's
    driver resumes from it, so both start from the same weights."""
    params, state, data_state = init
    JaxCheckpointManager(str(directory)).save(
        0, {"params": params, "opt": state}, extra={"data": data_state})


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_train_driver_losses_match_reference_loop(micro_batches, tmp_path,
                                                  reference_runs):
    init, want = reference_runs[micro_batches]
    _seed_ckpt(tmp_path, init)
    out = train.main(["--smoke", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "32", "--micro-batches",
                      str(micro_batches), "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and len(out["step_seconds"]) == 3
    np.testing.assert_allclose(out["losses"], want,
                               atol=TOLS["float32"].grad,
                               rtol=TOLS["float32"].grad)


def test_train_driver_resumes_where_it_stopped(tmp_path, reference_runs):
    init, want = reference_runs[1]
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32"]
    _seed_ckpt(tmp_path / "a", init)
    straight = train.main(argv + ["--steps", "3", "--ckpt-dir",
                                  str(tmp_path / "a")])["losses"]
    _seed_ckpt(tmp_path / "b", init)
    first = train.main(argv + ["--steps", "2", "--ckpt-dir",
                               str(tmp_path / "b")])
    assert first["final_step"] == 2
    rest = train.main(argv + ["--steps", "3", "--ckpt-dir",
                              str(tmp_path / "b")])
    assert rest["final_step"] == 3 and len(rest["losses"]) == 1
    # bit-equal on the card; the CPU's threaded sums may differ in the last
    # bits from run to run
    np.testing.assert_allclose(first["losses"] + rest["losses"], straight,
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(straight, want, atol=TOLS["float32"].grad,
                               rtol=TOLS["float32"].grad)


def test_train_driver_refuses_meshed_flags_and_ragged_micro_batches(
        tmp_path):
    # a meshed flag a world of one cannot hold: refused, naming torchrun
    with pytest.raises(SystemExit, match="needs 2 ranks: run it under "
                                         "torchrun"):
        train.main(["--smoke", "--device", "cpu", "--mesh", "1x2",
                    "--ckpt-dir", str(tmp_path)])
    # a pipeline needs a world the stage count divides
    with pytest.raises(SystemExit, match="needs a device count divisible "
                                         "by the stage count; have 1"):
        train.main(["--smoke", "--device", "cpu", "--pp", "2",
                    "--ckpt-dir", str(tmp_path)])
    # the elastic runtime needs a world --hosts divides: the reference's
    # words
    with pytest.raises(SystemExit, match=r"--hosts 2 must divide the device "
                                         r"count \(1\)"):
        train.main(["--smoke", "--device", "cpu", "--hosts", "2",
                    "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit):                # --ckpt-dir is required
        train.parse_args(["--smoke"])
    with pytest.raises(ValueError, match="divisible"):
        train.main(["--smoke", "--device", "cpu", "--steps", "1", "--batch",
                    "3", "--seq", "16", "--micro-batches", "2",
                    "--ckpt-dir", str(tmp_path)])


def test_state_from_numpy_carries_params_and_moments(reference_runs):
    (params, state, _), _ = reference_runs[1]
    cfg = get_config(ARCH, smoke=True)
    tree = _tree_np({"params": params, "opt": state})
    got = state_from_numpy(cfg, tree, "cpu")
    assert set(got) == {"params", "opt"} and set(got["opt"]) == {"mu", "nu"}
    for path, leaf in zip(*flatten(got)):
        np.testing.assert_array_equal(leaf.numpy(), tree[path])
    with pytest.raises(ValueError, match="missing"):
        state_from_numpy(cfg, {k: v for k, v in tree.items()
                               if not k.startswith("opt/nu")}, "cpu")
