"""The multimodal families in the port — qwen2-vl-2b (the vlm: a stub
vision prefix adapted into a dense decoder, M-RoPE) and seamless-m4t-medium
(encdec: two towers, cross-attention) — against the reference
(``repro.models``) on the CPU.

Each ``SMOKE`` config in f32 with remat none, its weights drawn by the
reference and carried across by ``params_from_numpy``; the tokens, patch
embeddings and frames are seeded numpy.  Lengths are ones the reference's
blocked attention takes at the smoke's 64-row blocks (at most 64).
Tolerances (tests/torch_harness.py): f32 values 2e-5, gradients and the
drivers' losses 2e-4.

- the configs as the reference has them, and ``shrink``;
- ``apply_rope`` with M-RoPE, ``mrope_positions`` (0 and 16 patches; a
  sequence shorter than the prefix refused), ``adapt``;
- ``encode``, ``decode_train`` and ``cross_attention`` (Sq ≠ Sk) values
  and VJPs; ``init_dec_state`` and ``decode_step``;
- ``Model.loss_fn`` of both (the vlm with ``patch_embeds`` and its prefix
  mask): the loss and every gradient leaf, both loss heads, remat none
  and full;
- ``prefill`` and greedy ``serve_step`` logits and tokens against the
  reference's loop (the vlm with ragged ``last_idx``, its M-RoPE decode
  jump included; the encdec from frames), the vlm's paged decode equal
  to its dense one, and the ``Server``'s tokens, paged and dense, against
  the reference's prefill/serve_step loop per request;
- ``MultimodalPipeline`` byte for byte, ``reshard`` included;
- ``launch/train.py`` on the CPU resumed from the reference's step-0
  checkpoint against the reference's AdamW loop, and the refusals (vlm
  ``--pp``, ``serve --arch seamless-m4t-medium``, a split or ZeRO plan);
- one spawn of 2 gloo ranks: the two-tower pipeline at M = 1 and 2
  (loss and every gradient leaf) and one AdamW step against the
  reference's ``loss_fn`` and optimizer, a stage axis of 3 and
  ``--stage-layers`` refused; and one ``torchrun`` job of ``train --pp
  2`` on seamless against the reference's loop.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.models import attention as ref_attn
from repro.models import encdec as ref_encdec
from repro.models import frontends as ref_frontends
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.optim import optimizer as jax_opt
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import planner
from repro_torch.core.cost_model import StrategySpec
from repro_torch.data import pipeline as port_pipeline
from repro_torch.launch import serve, train
from repro_torch.models import attention, encdec, frontends, layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro_torch.serving.server import Request, Server, prompt_bucket
from repro_torch.tree import flatten

from torch_harness import TOLS, cotangents

ROOT = Path(__file__).resolve().parents[1]
TOL = TOLS["float32"]
VLM, ENCDEC = "qwen2-vl-2b", "seamless-m4t-medium"
ARCHS = (VLM, ENCDEC)
B, T = 2, 32                       # the loss batch (tokens)
SRC = 24                           # the encdec's source frames
STEPS = 3                          # the drivers' AdamW steps


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


def _close(got, want, tol=TOL.fwd, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _batch(cfg, seed: int = 0, rows: int = B) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (rows, T)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (rows, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    else:
        batch["frames"] = rng.standard_normal(
            (rows, SRC, cfg.d_model)).astype(np.float32)
    return batch


def _driver_reference(jm, grad_fn, batch: int = B, seq: int = T):
    """(initial params, opt state, data state) and the losses of the
    reference's AdamW loop with the driver's schedule and its
    ``MultimodalPipeline``; ``grad_fn`` is ``jm.loss_fn``'s value and
    gradient."""
    jcfg = jm.cfg
    params = jm.init(jax.random.key(0))
    sched = jax_opt.Schedule(base_lr=3e-4, warmup=min(100, STEPS // 10 + 1),
                             decay_steps=STEPS)
    o = jax_opt.adamw(lr=sched)
    state = o.init(params)
    data = jax_pipeline.MultimodalPipeline(
        jax_pipeline.DataCfg(global_batch=batch, seq_len=seq,
                             vocab=jcfg.vocab, seed=0),
        modality=jcfg.family, d_model=jcfg.d_model,
        frontend_len=jcfg.frontend_len if jcfg.family == "vlm" else 0,
        src_len=SRC if jcfg.family == "encdec" else 0, host_id=0, n_hosts=1)
    init = (params, state, data.state_dict())
    apply = jax.jit(o.apply)
    losses = []
    for i in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in data.next_batch().items()}
        (loss, _), g = grad_fn(params, b)
        params, state = apply(g, state, params, i)
        losses.append(float(loss))
    return init, losses


def _reference(arch: str) -> dict:
    """One arch's reference: smoke weights (numpy and JAX), a batch, the
    unmeshed loss, metrics and gradients, and the driver's loop."""
    jcfg = jax_get_config(arch, smoke=True)
    assert jcfg.remat == "none"          # the smoke's, and the driver's
    jm = ref_lm.build(jcfg)
    params = jax.jit(jm.init)(jax.random.key(0))
    batch = _batch(jcfg)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    (loss, m), g = grad_fn(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    return {"arch": arch, "jm": jm, "jp": params, "params": _np(params),
            "batch": batch, "grad_fn": grad_fn,
            "whole": (float(loss), {k: float(v) for k, v in m.items()},
                      _np(g)),
            "driver": _driver_reference(jm, grad_fn)}


@pytest.fixture(scope="module")
def vlm_ref():
    return _reference(VLM)


@pytest.fixture(scope="module")
def encdec_ref():
    return _reference(ENCDEC)


@pytest.fixture(params=ARCHS)
def smoke(request):
    return request.getfixturevalue(
        "vlm_ref" if request.param == VLM else "encdec_ref")


def _port(smoke, remat="none", **kw):
    cfg = dataclasses.replace(get_config(smoke["arch"], smoke=True),
                              remat=remat)
    return (Model(cfg, "cpu", **kw),
            params_from_numpy(cfg, smoke["params"], "cpu"))


def _tensors(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs and the layers alone
# ---------------------------------------------------------------------------

def test_the_configs_are_registered_as_the_reference_has_them():
    for arch in ARCHS:
        assert arch in ARCH_NAMES
        for smoke in (False, True):
            ours, ref = get_config(arch, smoke), jax_get_config(arch, smoke)
            for f in dataclasses.fields(ours):
                assert getattr(ours, f.name) == getattr(ref, f.name), \
                    (arch, smoke, f.name)
    s = get_config(ENCDEC, smoke=True)
    assert (s.n_enc_layers, s.n_dec_layers, s.frontend_len) == (2, 2, 0)
    assert get_config(VLM, smoke=True).frontend_len == 16
    assert get_config(VLM).attn_cfg().mrope_sections == (16, 24, 24)
    assert not get_config(ENCDEC).attn_cfg(False).causal


@pytest.mark.parametrize("n_patches", [0, 16])
def test_mrope_positions_and_apply_rope_match_reference(n_patches):
    for grid in (None, 2):
        want = np.asarray(ref_frontends.mrope_positions(2, 40, n_patches,
                                                        grid))
        got = frontends.mrope_positions(2, 40, n_patches, grid)
        assert np.array_equal(got.numpy(), want)
    pos = frontends.mrope_positions(2, 40, n_patches)
    (x,) = [np.random.default_rng(n_patches).standard_normal(
        (2, 40, 3, 32)).astype(np.float32)]
    sections = (4, 6, 6)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos.numpy()),
                                 10000.0, sections)
    got = layers.apply_rope(torch.tensor(x), pos, 10000.0, sections)
    _close(got, want)
    # at 0 patches every section sees the same position: plain RoPE
    if n_patches == 0:
        _close(got, layers.apply_rope(torch.tensor(x), pos[:, 0]))
    with pytest.raises(ValueError, match="M-RoPE wants"):
        layers.apply_rope(torch.tensor(x), pos[:, 0], 10000.0, sections)


def test_mrope_refuses_a_sequence_shorter_than_the_prefix():
    with pytest.raises(ValueError, match="shorter than the 16-position"):
        frontends.mrope_positions(1, 8, 16)
    cfg = get_config(VLM, smoke=True)
    model = Model(cfg, "cpu")
    params = model.init(0)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="frontend_len"):
        model.prefill(params, {"tokens": tokens}, gen_budget=4)
    with pytest.raises(ValueError, match="frontend_len"):
        model.loss_fn(params, {"tokens": tokens})


def test_adapt_matches_reference():
    rng = np.random.default_rng(3)
    w, b, x = (rng.standard_normal(s).astype(np.float32)
               for s in ((32, 32), (32,), (2, 5, 32)))
    want = ref_frontends.adapt({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x))
    got = frontends.adapt({"w": torch.tensor(w), "b": torch.tensor(b)},
                          torch.tensor(x))
    _close(got, want)
    p = frontends.init_adapter(torch.Generator().manual_seed(0), 32,
                               torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {"w": (32, 32), "b": (32,)}
    assert frontends.axes_adapter() == ref_frontends.axes_adapter()


def _encdec_parts(smoke):
    cfg = get_config(ENCDEC, smoke=True)
    jp = smoke["jp"]["encdec"]
    tp = params_from_numpy(cfg, smoke["params"], "cpu")["encdec"]
    return cfg, jp, tp


def _vjp_pair(ref_fn, port_fn, args: list, seed: int):
    """The reference's value and VJP against the port's, both taking the
    same numpy ``args`` (every one differentiated) and cotangent."""
    jout, vjp = jax.vjp(jax.jit(ref_fn), *(jnp.asarray(a) for a in args))
    (ct,) = cotangents([jout.shape], seed)
    jgrads = vjp(jnp.asarray(ct))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = port_fn(*targs)
    _close(tout, jout)
    tout.backward(torch.tensor(ct))
    for i, (t, g) in enumerate(zip(targs, jgrads)):
        _close(t.grad, g, TOL.grad, f"argument {i}")


def test_encoder_decoder_towers_match_reference(encdec_ref):
    """``encode`` (non-causal, S_src 24), ``decode_train`` (causal at 31,
    cross-attention over the memory) and ``cross_attention`` alone at
    Sq 24 ≠ Sk 40: values and the VJP of their inputs."""
    cfg, jp, tp = _encdec_parts(encdec_ref)
    ecfg, jecfg = cfg.encdec_cfg(), encdec_ref["jm"].ecfg
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((B, SRC, cfg.d_model)).astype(np.float32)
    tgt = rng.standard_normal((B, T - 1, cfg.d_model)).astype(np.float32)
    _vjp_pair(lambda f: ref_encdec.encode(jp, f, jecfg),
              lambda f: encdec.encode(tp, f, ecfg), [frames], 1)
    _vjp_pair(lambda x, m: ref_encdec.decode_train(jp, x, m, jecfg),
              lambda x, m: encdec.decode_train(tp, x, m, ecfg),
              [tgt, frames], 2)
    lp_j = jax.tree.map(lambda a: a[0], jp["decoder"]["cross_attn"])
    lp_t = {k: v[0] for k, v in tp["decoder"]["cross_attn"].items()}
    x = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 40, cfg.d_model)).astype(np.float32)
    _vjp_pair(lambda a, m: ref_attn.cross_attention(
                  lp_j, a, m, jecfg.attn_cfg(False), block_q=64,
                  block_k=64),
              lambda a, m: attention.cross_attention(
                  lp_t, a, m, ecfg.attn_cfg(False)), [x, mem], 3)


def test_decode_state_and_steps_match_reference(encdec_ref):
    """``init_dec_state`` (the cross K/V of a 24-frame memory) and three
    ``decode_step``s: outputs and every state leaf."""
    cfg, jp, tp = _encdec_parts(encdec_ref)
    ecfg, jecfg = cfg.encdec_cfg(), encdec_ref["jm"].ecfg
    rng = np.random.default_rng(6)
    mem = rng.standard_normal((B, SRC, cfg.d_model)).astype(np.float32)
    jst = ref_encdec.init_dec_state(jp, jnp.asarray(mem), jecfg, B, 8,
                                    jnp.float32)
    with torch.no_grad():
        st = encdec.init_dec_state(tp, torch.tensor(mem), ecfg, B, 8,
                                   torch.float32)
        assert sorted(st) == sorted(jst)
        for k in st:
            _close(st[k], jst[k], msg=k)
        step = jax.jit(lambda x, s, p: ref_encdec.decode_step(jp, x, s, p,
                                                              jecfg))
        for t in range(3):
            x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
            pos = np.array([t, t + 1], np.int32)
            jy, jst = step(jnp.asarray(x), jst, jnp.asarray(pos))
            y, st = encdec.decode_step(tp, torch.tensor(x), st,
                                       torch.tensor(pos), ecfg)
            _close(y, jy, msg=f"step {t}")
        for k in st:
            _close(st[k], jst[k], msg=k)
    assert encdec.axes_dec_state() == ref_encdec.axes_dec_state()
    assert encdec.axes_encdec(ecfg) == ref_encdec.axes_encdec(jecfg)


# ---------------------------------------------------------------------------
# the model: loss and gradients, serving
# ---------------------------------------------------------------------------

def test_params_cross_leaf_for_leaf(smoke):
    model, params = _port(smoke)
    got = dict(zip(*flatten(params)))
    assert sorted(got) == sorted(smoke["params"])
    for path, w in smoke["params"].items():
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)
    shapes = {p: (tuple(t.shape), t.dtype) for p, t in
              zip(*flatten(model.init(1)))}
    assert shapes == {p: (tuple(t.shape), t.dtype) for p, t in got.items()}
    assert model.axes() == smoke["jm"].axes()
    assert model.supports_paged == (smoke["arch"] == VLM)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("xent_impl", ["chunked", "fused"])
def test_loss_and_every_gradient_leaf_match_reference(smoke, xent_impl,
                                                      remat):
    model, params = _port(smoke, remat, xent_impl=xent_impl)
    for v in flatten(params)[1]:
        v.requires_grad_(True)
    loss, m = model.loss_fn(params, _tensors(smoke["batch"]))
    want_loss, want_m, want_g = smoke["whole"]
    np.testing.assert_allclose(loss.item(), want_loss, atol=TOL.fwd,
                               rtol=TOL.fwd)
    for k, v in want_m.items():
        np.testing.assert_allclose(m[k].item(), v, atol=TOL.fwd,
                                   rtol=TOL.fwd, err_msg=k)
    if smoke["arch"] == VLM:         # the targets inside the prefix: masked
        assert m["tokens"].item() == B * (T - model.cfg.frontend_len)
    loss.backward()
    got = dict(zip(*flatten(params)))
    assert sorted(got) == sorted(want_g)
    for path, w in want_g.items():
        _close(got[path].grad, w, TOL.grad, path)


def _greedy(logits, vocab: int) -> np.ndarray:
    return np.asarray(logits)[:, :vocab].argmax(-1).astype(np.int32)


def test_vlm_prefill_and_decode_match_reference(vlm_ref):
    """Prefill with patch embeddings and ragged ``last_idx``: logits and
    the M-RoPE-roped KV cache; then 4 greedy ``serve_step``s, each at
    ``pos`` in every section (the reference's jump past the prefix's
    compressed positions), logits and tokens equal; then 3 paged steps
    over pools built from the same prefill equal to the dense ones."""
    jm, jp = vlm_ref["jm"], vlm_ref["jp"]
    tm, tp = _port(vlm_ref)
    batch = {k: v for k, v in vlm_ref["batch"].items()}
    last = np.array([20, T - 1], np.int32)
    # the last prompt token ropes at S-1 - P + P // g in the text, the
    # first generated one at S: the jump the reference makes
    pos3 = frontends.mrope_positions(1, T, 16)
    assert int(pos3[0, 0, -1]) == T - 1 - 16 + 4
    jl, jst = jax.jit(jm.prefill, static_argnames="gen_budget")(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, gen_budget=8,
        last_idx=jnp.asarray(last))
    step = jax.jit(jm.serve_step)
    vocab = tm.cfg.vocab
    with torch.no_grad():
        tl, st = tm.prefill(tp, _tensors(batch), gen_budget=8,
                            last_idx=torch.tensor(last))
        _close(tl, jl)
        assert st["pos"].tolist() == (last + 1).tolist()
        for key in ("k", "v"):
            _close(st["cache"]["p0"][key], jst["cache"]["p0"][key])
        dense = {k: v.clone() for k, v in st["cache"]["p0"].items()}
        toks = []
        for _ in range(4):
            nxt = _greedy(jl, vocab)
            assert np.array_equal(_greedy(tl, vocab), nxt)
            toks.append(nxt)
            tl, st = tm.serve_step(tp, torch.tensor(nxt).long(), st)
            jl, jst = step(jp, jnp.asarray(nxt), jst)
            _close(tl, jl)
        # the paged decode over pools holding the same prefill, step by
        # step against the dense decode from it
        ps, mp = 8, (T + 8) // 8
        pools = tm.paged_pools(1 + B * mp, ps)
        table = torch.zeros((B, mp), dtype=torch.int32)
        for b in range(B):
            table[b] = torch.arange(1 + b * mp, 1 + (b + 1) * mp)
            for key in ("k", "v"):
                rows = dense[key][:, b]
                pools["p0"][key][:, 1 + b * mp:1 + (b + 1) * mp] = \
                    rows.reshape(rows.shape[0], mp, ps, *rows.shape[2:])
        pst = {"pools": pools, "block_table": table,
               "pos": torch.tensor(last + 1)}
        _, st2 = tm.prefill(tp, _tensors(batch), gen_budget=8,
                            last_idx=torch.tensor(last))
        for nxt in toks[:3]:
            pl, pst = tm.serve_step_paged(tp, torch.tensor(nxt).long(), pst)
            dl, st2 = tm.serve_step(tp, torch.tensor(nxt).long(), st2)
            _close(pl, dl)


def test_encdec_prefill_and_decode_match_reference(encdec_ref):
    """``prefill({"frames"})`` (encode, the decode state, BOS at 0) and 6
    greedy ``serve_step``s: logits, tokens and the state; ``last_idx``
    refused as the reference refuses it."""
    jm, jp = encdec_ref["jm"], encdec_ref["jp"]
    tm, tp = _port(encdec_ref)
    frames = encdec_ref["batch"]["frames"]
    jl, jst = jax.jit(jm.prefill, static_argnames="gen_budget")(
        jp, {"frames": jnp.asarray(frames)}, gen_budget=8)
    step = jax.jit(jm.serve_step)
    with torch.no_grad():
        tl, st = tm.prefill(tp, {"frames": torch.tensor(frames)},
                            gen_budget=8)
        _close(tl, jl)
        assert st["pos"].tolist() == [1] * B
        for _ in range(6):
            nxt = _greedy(jl, tm.cfg.vocab)
            assert np.array_equal(_greedy(tl, tm.cfg.vocab), nxt)
            tl, st = tm.serve_step(tp, torch.tensor(nxt).long(), st)
            jl, jst = step(jp, jnp.asarray(nxt), jst)
            _close(tl, jl)
        for k in ("k", "v", "ck", "cv"):
            _close(st["cache"][k], jst["cache"][k], msg=k)
        with pytest.raises(ValueError, match="last_idx is not supported"):
            tm.prefill(tp, {"frames": torch.tensor(frames)},
                       last_idx=torch.tensor([3, 4]))
        shapes = tm.decode_state_shapes(B, 8)
        assert {k: tuple(v[0]) for k, v in shapes["cache"].items()} == \
            {k: tuple(v.shape) for k, v in
             jm.decode_state_shapes(B, 8)["cache"].items()}


PROMPTS = ((11, 6), (30, 9), (17, 1), (24, 7))   # (prompt length, max_new)


def test_vlm_server_tokens_match_reference_loop(vlm_ref):
    """The ``Server`` (2 slots, max_len 64), paged and dense, against the
    reference's prefill/serve_step loop per request: each prompt padded
    to its bucket, prefilled with ``last_idx``, then greedy to
    ``max_new`` or EOS; text prompts at M-RoPE positions, no patch
    embeddings, as both servers run them."""
    jm, jp = vlm_ref["jm"], vlm_ref["jp"]
    tm, tp = _port(vlm_ref)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, tm.cfg.vocab, n).astype(np.int32)
               for n, _ in PROMPTS]
    prefill = jax.jit(jm.prefill, static_argnames="gen_budget")
    step = jax.jit(jm.serve_step)
    want = {}
    for rid, (p, (n, g)) in enumerate(zip(prompts, PROMPTS)):
        bucket = prompt_bucket(n, 64)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = p
        lg, st = prefill(jp, {"tokens": jnp.asarray(toks)},
                         gen_budget=64 - bucket,
                         last_idx=jnp.asarray([n - 1]))
        out = []
        while True:
            tok = _greedy(lg, tm.cfg.vocab)
            out.append(int(tok[0]))
            if out[-1] == 1 or len(out) >= g:
                break
            lg, st = step(jp, jnp.asarray(tok), st)
        want[rid] = out
    for cache in ("paged", "dense"):
        server = Server(tm, batch_slots=2, max_len=64, cache=cache,
                        page_size=8)
        pending = [Request(i, p, max_new=g)
                   for i, (p, (_, g)) in enumerate(zip(prompts, PROMPTS))]
        done = []
        for _ in range(100):
            if not (pending or server.active):
                break
            while pending and (slot := server.free_slot()) is not None:
                req = pending.pop(0)
                server.admit(tp, req, slot)
                if req.done:
                    done.append(req)
            done.extend(server.step(tp))
        assert {r.rid: r.out_tokens for r in done} == want, cache


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_multimodal_pipeline_is_byte_identical():
    for modality, kw in (("vlm", {"frontend_len": 16}),
                         ("encdec", {"src_len": 24})):
        kw = dict(modality=modality, d_model=32, **kw)
        for host, hosts in ((0, 1), (1, 2)):
            dcfg = dict(global_batch=4, seq_len=16, vocab=100, seed=3)
            ref = jax_pipeline.MultimodalPipeline(
                jax_pipeline.DataCfg(**dcfg), host_id=host, n_hosts=hosts,
                **kw)
            ours = port_pipeline.MultimodalPipeline(
                port_pipeline.DataCfg(**dcfg), host_id=host, n_hosts=hosts,
                **kw)
            for _ in range(3):
                a, b = ref.next_batch(), ours.next_batch()
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    assert a[k].tobytes() == b[k].tobytes(), k
            assert ours.state_dict() == ref.state_dict()
            ref2, ours2 = (p.reshard(host_id=0, n_hosts=2)
                           for p in (ref, ours))
            assert isinstance(ours2, port_pipeline.MultimodalPipeline)
            a, b = ref2.next_batch(), ours2.next_batch()
            assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    with pytest.raises(ValueError, match="modality"):
        port_pipeline.MultimodalPipeline(
            port_pipeline.DataCfg(global_batch=2, seq_len=8, vocab=10),
            modality="audio", d_model=4)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def _driver_argv(arch: str) -> list:
    return (["--arch", arch, "--smoke", "--device", "cpu", "--steps",
             str(STEPS), "--batch", str(B), "--seq", str(T), "--log-every",
             "1"] + (["--src-seq", str(SRC)] if arch == ENCDEC else []))


def _write_reference_ckpt(smoke, path) -> None:
    (params, state, data_state), _ = smoke["driver"]
    JaxCheckpointManager(str(path)).save(
        0, {"params": params, "opt": state}, extra={"data": data_state})


def test_train_driver_three_adamw_steps_match_reference(smoke, tmp_path):
    """``launch/train.py`` resumed from the reference's step-0 checkpoint
    (its data stream the reference's ``MultimodalPipeline``): its three
    AdamW losses against the reference's loop."""
    _write_reference_ckpt(smoke, tmp_path)
    out = train.main(_driver_argv(smoke["arch"])
                     + ["--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == STEPS
    np.testing.assert_allclose(out["losses"], smoke["driver"][1],
                               atol=TOL.grad, rtol=TOL.grad)


def test_drivers_refuse_what_the_reference_refuses(tmp_path):
    argv = _driver_argv(VLM)
    with pytest.raises(SystemExit, match="does not apply to vlm"):
        train.main(argv + ["--pp", "2", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="not served through the Server"):
        serve.main(["--arch", ENCDEC, "--smoke", "--device", "cpu"])
    for arch in ARCHS:
        model = Model(get_config(arch, smoke=True), "meta")
        for strat in (StrategySpec(tp=2), StrategySpec(dp=2, zero=1)):
            with pytest.raises(NotImplementedError, match="queue A item 7"):
                planner.compile_plan(model, None, strat)


# ---------------------------------------------------------------------------
# the two-tower pipeline on 2 gloo ranks, and the driver under torchrun
# ---------------------------------------------------------------------------

def _rank_main(rank: int, store: str, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    import importlib
    pipe = importlib.import_module("repro_torch.core.pipeline")
    d = dict(np.load(inputs))
    cfg = get_config(ENCDEC, smoke=True)
    model = Model(cfg, "cpu")
    full = params_from_numpy(
        cfg, {k[2:]: v for k, v in d.items() if k.startswith("p/")}, "cpu")
    res, meta = {}, {}
    for M in (1, 2):
        strat = StrategySpec(pp=2, micro_batches=M)
        plan = planner.compile_plan(
            model, planner.mesh_for_strategy(strat, device_type="cpu"),
            strat)
        assert plan.stage_layers() == (2, 2)
        params = plan.init_pipeline_params(0)
        meta["replicated"] = sorted(flatten(params)[0]) == \
            sorted(flatten(full)[0])
        fn = pipe.make_encdec_pipeline_loss(model, plan.rules,
                                            micro_batches=M)
        loss, grads = fn(full, torch.tensor(d["frames"]),
                         torch.tensor(d["tokens"]))
        meta[f"loss{M}"] = float(loss)
        for path, g in zip(*flatten(grads)):
            res[f"m{M}/{path}"] = g.numpy()
    opt = adamw(lr=1e-3)
    step = plan.pipeline_train_step_fn(opt)
    state = opt.init(full)
    new, _, m = step(full, state, torch.tensor(d["frames"]),
                     torch.tensor(d["tokens"]), 0)
    meta["step_loss"] = float(m["loss"])
    for path, p in zip(*flatten(new)):
        res[f"adamw/{path}"] = p.detach().numpy()
    # a stage axis of 3, and --stage-layers, refused
    with mock.patch.object(pipe.dist, "get_world_size", lambda g=None: 3):
        try:
            pipe.make_encdec_pipeline_loss(model, plan.rules,
                                           micro_batches=1)
        except ValueError as e:
            meta["three"] = str(e)
    try:
        train.main(_driver_argv(ENCDEC) + [
            "--pp", "2", "--stage-layers", "1,3", "--ckpt-dir",
            os.path.join(out_dir, f"sl{rank}")])
    except SystemExit as e:
        meta["stage_layers"] = str(e)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_towers(encdec_ref, tmp_path_factory):
    """The reference's inputs and results, and what each rank saw."""
    import torch.multiprocessing as mp
    jp = encdec_ref["jp"]
    batch = _batch(encdec_ref["jm"].cfg, seed=4, rows=4)
    (loss, _), g = encdec_ref["grad_fn"](
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    o = jax_opt.adamw(lr=1e-3)
    new, _ = o.apply(g, o.init(jp), jp, 0)
    d = tmp_path_factory.mktemp("two_towers")
    np.savez(d / "inputs.npz", **batch,
             **{f"p/{k}": v for k, v in _np(jp).items()})
    ctx = mp.start_processes(
        _rank_main, args=(str(d / "store"), str(d / "inputs.npz"), str(d)),
        nprocs=2, join=False, start_method="spawn")
    for p in ctx.processes:
        p.join(300)
    alive = [p for p in ctx.processes if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank did not finish within 300 s"
    assert ctx.join(), "the ranks did not exit"
    ranks = []
    for r in range(2):
        with open(d / f"rank{r}.json") as f:
            ranks.append((json.load(f), dict(np.load(d / f"rank{r}.npz"))))
    return {"loss": float(loss), "grads": _np(g), "adamw": _np(new),
            "ranks": ranks}


@pytest.mark.parametrize("M", [1, 2])
def test_two_tower_pipeline_matches_reference_loss_fn(two_towers, M):
    """Stage 0 the adapter and the encoder, stage 1 the decoder and the
    loss, M micro-batches in M + 1 ticks: the loss and every gradient
    leaf, the same on both ranks, against the reference's unmeshed
    ``loss_fn`` on the whole batch."""
    for meta, res in two_towers["ranks"]:
        assert meta["replicated"]
        np.testing.assert_allclose(meta[f"loss{M}"], two_towers["loss"],
                                   atol=TOL.fwd, rtol=TOL.fwd)
        got = {k[3:]: v for k, v in res.items() if k.startswith(f"m{M}/")}
        assert sorted(got) == sorted(two_towers["grads"])
        for path, w in two_towers["grads"].items():
            _close(got[path], w, TOL.grad, path)


def test_two_tower_train_step_and_refusals(two_towers):
    """One AdamW step through ``pipeline_train_step_fn`` (the plan routes
    the encdec to the two-tower engine) against the reference's apply;
    a stage axis of 3 and ``--stage-layers`` refused."""
    for meta, res in two_towers["ranks"]:
        np.testing.assert_allclose(meta["step_loss"], two_towers["loss"],
                                   atol=TOL.fwd, rtol=TOL.fwd)
        for path, w in two_towers["adamw"].items():
            _close(res[f"adamw/{path}"], w, TOL.grad, path)
        assert "strict 2-stage engine" in meta["three"]
        assert "got a stage axis of size 3" in meta["three"]
        assert "--stage-layers does not apply to encdec" in \
            meta["stage_layers"]


def test_train_driver_pipelines_encdec_under_torchrun(encdec_ref,
                                                      tmp_path):
    """``torchrun … train --arch seamless-m4t-medium --pp 2
    --micro-batches 2`` resumed from the reference's step-0 checkpoint
    (the two-tower engine, its state replicated): the losses it prints
    against the reference's unpipelined AdamW loop."""
    _write_reference_ckpt(encdec_ref, tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "repro_torch.launch.train"]
        + _driver_argv(ENCDEC) + ["--pp", "2", "--micro-batches", "2",
                                  "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    assert "stage_layers (2, 2)" in p.stdout
    assert "[resume] from step 0" in p.stdout
    losses = [float(line.split()[3]) for line in p.stdout.splitlines()
              if line.strip().startswith("step ")]
    np.testing.assert_allclose(losses, encdec_ref["driver"][1],
                               atol=TOL.grad + 5e-5, rtol=0)
