"""The hybrid family (jamba-v0.1-52b) in the port against the reference
(``repro.models``) on the CPU.

The model is the reference's jamba ``SMOKE``: one period of 4 blocks
(SSD + dense MLP, SSD + 8 experts, attention + dense MLP, SSD + experts;
4 q heads over 1 kv head of 32, 8 SSD heads of 32, state 16, chunk 32),
in f32, its weights drawn by the reference's ``Model.init`` and carried
across by ``params_from_numpy``; the tokens are seeded numpy.

- the config and ``shrink`` field for field; the pattern; ``model_graph``
  at ``SMOKE`` and ``CONFIG`` with ``==``; the tree leaf for leaf;
- prefill logits and the KV cache, at full length and at a ragged
  ``last_idx``; the prefill's SSD states against the reference's
  ``serve_step`` run over each prompt token by token from zero (the
  reference's hybrid ``prefill`` returns zero SSD states); decode steps
  and the ``Server``'s greedy tokens against a reference loop of
  ``serve_step``; ``--cache paged`` refused;
- the loss, ``moe_lb``, ``moe_z`` and every gradient leaf under remat
  none, full and dots, with and without a ``loss_mask``, the SSD mixers
  through the differentiable scan and attention through ``ops.flash``;
  three steps of AdamW and of Adafactor; the train driver's losses
  against the reference's loop.

Tolerances (tests/torch_harness.py): f32 values 2e-5, gradients and the
driver's losses 2e-4; logits after a prefill 1e-4, and the state against
token-by-token decode 2e-3, as the ssm family's tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import base as ref_base
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.models import lm as ref_lm
from repro.models import transformer as jax_tfm
from repro.optim import optimizer as jax_opt
from repro_torch.configs import ARCH_NAMES, base, get_config
from repro_torch.core import planner
from repro_torch.launch import serve, train
from repro_torch.models import attention, lm, mamba2
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim import optimizer as torch_opt
from repro_torch.serving.server import Request, Server
from repro_torch.tree import flatten

from torch_harness import TOLS, close, data

ARCH = "jamba-v0.1-52b"
TOL = TOLS["float32"]
LOGIT_TOL = 1e-4
STATE_TOL = 2e-3
B, T = 2, 64                      # the loss batch: two chunks of 32 a row
LR = 1e-3
STEPS = 3
MAX_LEN = 64


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke jamba: weights, tokens and a mask, the
    unmeshed loss, metrics and gradients with and without the mask, and
    three steps of each optimizer."""
    jcfg = jax_get_config(ARCH, smoke=True)
    jm = ref_lm.build(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    out = {"jm": jm, "jp": jp, "params": _np(jp), "tokens": tokens,
           "mask": mask}
    for masked in (False, True):
        batch = {"tokens": jnp.asarray(tokens)}
        if masked:
            batch["loss_mask"] = jnp.asarray(mask)
        (loss, m), g = grad_fn(jp, batch)
        out[masked] = (float(loss), {k: float(v) for k, v in m.items()},
                       _np(g))
    for name in ("adamw", "adafactor"):
        o = getattr(jax_opt, name)(lr=LR)
        p, st, losses = jp, o.init(jp), []
        apply = jax.jit(o.apply)
        for i in range(STEPS):
            (loss, _), g = grad_fn(p, {"tokens": jnp.asarray(tokens)})
            p, st = apply(g, st, p, i)
            losses.append(float(loss))
        out[name] = losses
    return out


def _port(ref, remat="none", **kw):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), remat=remat,
                              **kw)
    return Model(cfg, "cpu"), params_from_numpy(cfg, ref["params"], "cpu")


def _reference_state(jm, jp, prompt):
    """The reference's exact route to a prompt's decode state: its
    ``serve_step`` over the prompt token by token from a zero state (at
    batch 1, a cache of MAX_LEN rows).  Returns (the last step's logits,
    the state)."""
    state = {"cache": jax_tfm.init_stack_state(jm.stack, 1, MAX_LEN,
                                               jm.cfg.adtype),
             "pos": jnp.zeros((1,), jnp.int32)}
    step = jax.jit(jm.serve_step)
    for tok in prompt:
        logits, state = step(jp, jnp.asarray([tok], jnp.int32), state)
    return logits, state


# ---------------------------------------------------------------------------
# the config, the pattern, the graph and the tree
# ---------------------------------------------------------------------------

def test_config_and_shrink_match_reference():
    """Every field of ``CONFIG`` and ``SMOKE`` has the reference's value,
    and ``shrink`` keeps one period of ``attn_period`` layers as the
    reference's does."""
    assert ARCH in ARCH_NAMES
    for smoke in (False, True):
        ours, want = get_config(ARCH, smoke), jax_get_config(ARCH, smoke)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(want, f.name), \
                (smoke, f.name)
        assert ours.padded_vocab == want.padded_vocab
    ours = base.shrink(get_config(ARCH))
    want = ref_base.shrink(jax_get_config(ARCH))
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(want, f.name), f.name
    assert ours.n_layers == 8 and get_config(ARCH, smoke=True).n_layers == 4
    full = get_config(ARCH)
    assert full.has_experts and full.ssd_cfg().n_heads == 128
    assert not get_config("mamba2-1.3b").has_experts
    assert not dataclasses.replace(full, n_experts=0).has_experts


@pytest.mark.parametrize("smoke", (False, True), ids=("full", "smoke"))
def test_pattern_matches_reference(smoke):
    """Attention at ``attn_offset`` of each period, SSD elsewhere; experts
    on the odd blocks, a dense MLP on the even; ``n_rep`` periods."""
    ours = lm.build_stack_cfg(get_config(ARCH, smoke))
    want = ref_lm.build_stack_cfg(jax_get_config(ARCH, smoke))
    assert ours.n_rep == want.n_rep and ours.remat == want.remat
    assert [(b.mixer, b.mlp) for b in ours.pattern] == \
        [(b.mixer, b.mlp) for b in want.pattern]
    for o, w in zip(ours.pattern, want.pattern):
        assert (o.attn is None) == (w.attn is None)
        assert (o.ssd is None) == (w.ssd is None)
        for sub in ("ssd", "moe"):          # the fields the port keeps
            mine = getattr(o, sub)
            if mine is not None:
                for f in dataclasses.fields(mine):
                    assert getattr(mine, f.name) == getattr(
                        getattr(w, sub), f.name), (sub, f.name)
    if not smoke:
        assert [b.mixer for b in ours.pattern].index("attn") == 4
        assert ours.n_rep == 4 and len(ours.pattern) == 8


@pytest.mark.parametrize("smoke", (False, True), ids=("full", "smoke"))
@pytest.mark.parametrize("batch,seq", [(4, 2048), (1, 256), (16, 4096)])
def test_model_graph_equals_reference(smoke, batch, seq):
    """``model_graph`` bit for bit: n_attn = L // attn_period attention
    layers, n_moe = L // 2 expert layers."""
    ours = lm.model_graph(get_config(ARCH, smoke), batch, seq)
    want = ref_lm.model_graph(jax_get_config(ARCH, smoke), batch, seq)
    assert data(ours) == data(want)
    assert data(ours.workload_meta()) == data(want.workload_meta())
    seg = ours.segments[0]
    L = get_config(ARCH, smoke).n_layers
    assert seg.n_moe_layers == L // 2


def test_params_cross_leaf_for_leaf(ref):
    model, params = _port(ref)
    got = dict(zip(*flatten(params)))
    assert sorted(got) == sorted(ref["params"])
    for path, w in ref["params"].items():
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)
    blocks = params["blocks"]
    assert sorted(blocks["p0"]) == ["mlp", "norm1", "norm2", "ssd"]
    assert sorted(blocks["p1"]) == ["moe", "norm1", "norm2", "ssd"]
    assert sorted(blocks["p2"]) == ["attn", "mlp", "norm1", "norm2"]
    shapes = {p: (tuple(t.shape), t.dtype) for p, t in
              zip(*flatten(model.init(1)))}
    assert shapes == {p: (tuple(t.shape), t.dtype) for p, t in got.items()}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,last", [(64, None), (64, [40, 63]),
                                    (16, [4, 15])])
def test_prefill_logits_and_kv_match_reference(ref, S, last):
    """Logits and the attention block's KV at full length and at a ragged
    ``last_idx``; the SSD blocks' states are not KV and stay unpadded."""
    jm, jp = ref["jm"], ref["jp"]
    tm, tp = _port(ref)
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, S))
    jl = None if last is None else jnp.asarray(last)
    tl = None if last is None else torch.tensor(last)
    want, jst = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, gen_budget=8,
                           last_idx=jl)
    with torch.no_grad():
        got, st = tm.prefill(tp, {"tokens": torch.tensor(tokens)},
                             gen_budget=8, last_idx=tl)
    close(got, want, LOGIT_TOL)
    np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(jst["pos"]))
    for key in ("k", "v"):
        close(st["cache"]["p2"][key], jst["cache"]["p2"][key], LOGIT_TOL)
    H, P, N = 8, 32, 16
    for i in (0, 1, 3):
        assert st["cache"][f"p{i}"]["h"].shape == (1, 2, H, P, N)
        assert st["cache"][f"p{i}"]["conv"].shape == (1, 2, 3, H, P)


def test_prefill_ssd_states_match_reference_token_by_token(ref):
    """Each SSD block's ``h`` and ``conv`` after a ragged batch-2 prefill
    against the reference's ``serve_step`` over each prompt from zero
    (the reference's hybrid ``prefill`` returns zero SSD states)."""
    jm, jp = ref["jm"], ref["jp"]
    tm, tp = _port(ref)
    tokens = np.random.default_rng(2).integers(0, tm.cfg.vocab, (2, 64))
    last = [37, 63]
    with torch.no_grad():
        logits, st = tm.prefill(tp, {"tokens": torch.tensor(tokens)},
                                last_idx=torch.tensor(last))
    for b, n in enumerate(last):
        jlogits, jst = _reference_state(jm, jp, tokens[b, :n + 1])
        close(logits[b], jlogits[0], STATE_TOL)
        for i in (0, 1, 3):
            for key in ("h", "conv"):
                close(st["cache"][f"p{i}"][key][:, b],
                      jst["cache"][f"p{i}"][key][:, 0], STATE_TOL)
        close(st["cache"]["p2"]["k"][:, b, :n + 1],
              jst["cache"]["p2"]["k"][:, 0, :n + 1], STATE_TOL)


def test_serve_step_matches_reference(ref):
    """Decode steps from one state (the reference's token-by-token state,
    copied to the port): logits and every block's state agree."""
    jm, jp = ref["jm"], ref["jp"]
    tm, tp = _port(ref)
    prompt = np.random.default_rng(3).integers(0, tm.cfg.vocab, (11,))
    _, jst = _reference_state(jm, jp, prompt)
    st = {"cache": {p: {k: torch.tensor(np.asarray(v)) for k, v in c.items()}
                    for p, c in jst["cache"].items()},
          "pos": torch.tensor(np.asarray(jst["pos"]))}
    step = jax.jit(jm.serve_step)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for _ in range(4):
            nxt = rng.integers(0, tm.cfg.vocab, (1,))
            logits, st = tm.serve_step(tp, torch.tensor(nxt), st)
            jlogits, jst = step(jp, jnp.asarray(nxt, jnp.int32), jst)
            close(logits, jlogits, LOGIT_TOL)
    for p, c in jst["cache"].items():
        for k, v in c.items():
            close(st["cache"][p][k], v, LOGIT_TOL)
    np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(jst["pos"]))


SPEC = [(6, 10), (9, 10), (40, 8), (5, 10)]       # (prompt length, max_new)


def test_server_tokens_match_reference_loop(ref):
    """A dense Server with 3 slots and mixed prompt lengths gives each
    request the greedy tokens of a reference loop built from
    ``serve_step`` alone (its exact SSD states)."""
    jm, jp = ref["jm"], ref["jp"]
    tm, tp = _port(ref)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tm.cfg.vocab, (n,)) for n, _ in SPEC]
    step = jax.jit(jm.serve_step)
    want = []
    for prompt, (_, max_new) in zip(prompts, SPEC):
        logits, st = _reference_state(jm, jp, prompt)
        toks = [int(jnp.argmax(logits[0, :jm.cfg.vocab]))]
        while toks[-1] != 1 and len(toks) < max_new:
            logits, st = step(jp, jnp.asarray(toks[-1:], jnp.int32), st)
            toks.append(int(jnp.argmax(logits[0, :jm.cfg.vocab])))
        want.append(toks)
    server = Server(tm, batch_slots=3, max_len=MAX_LEN, cache="dense")
    pending = [Request(i, p.astype(np.int32), max_new=g)
               for i, (p, (_, g)) in enumerate(zip(prompts, SPEC))]
    done = {}
    for _ in range(200):
        if not (pending or server.active):
            break
        while pending and (slot := server.free_slot()) is not None:
            req = pending.pop(0)
            server.admit(tp, req, slot)
            if req.done:
                done[req.rid] = req
        done.update((r.rid, r) for r in server.step(tp))
    assert sorted(done) == list(range(len(SPEC)))
    for rid, toks in enumerate(want):
        assert done[rid].out_tokens == toks, f"request {rid} diverged"


def test_paged_cache_raises(ref):
    tm, _ = _port(ref)
    assert not tm.supports_paged
    with pytest.raises(ValueError, match="paged"):
        Server(tm, batch_slots=2, max_len=32, cache="paged", page_size=8)
    with pytest.raises(ValueError, match="paged"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--cache",
                    "paged"])


def test_serve_driver_completes_every_request():
    s = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--cache",
                    "dense", "--requests", "5", "--batch-slots", "3",
                    "--prompt-len", "40", "--gen", "5", "--max-len", "64"])
    assert s["completed"] == 5
    assert s["tokens"] >= 5 and s["steps"] > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_aux_and_every_gradient_match_reference(ref, remat, masked):
    """``Model.loss_fn`` over the mixed period: the loss, ``nll``,
    ``moe_lb``, ``moe_z`` and every gradient leaf against the reference's
    at f32 2e-5 / 2e-4."""
    model, params = _port(ref, remat)
    for v in flatten(params)[1]:
        v.requires_grad_(True)
    batch = {"tokens": torch.tensor(ref["tokens"])}
    if masked:
        batch["loss_mask"] = torch.tensor(ref["mask"])
    loss, m = model.loss_fn(params, batch)
    want_loss, want_m, want_g = ref[masked]
    np.testing.assert_allclose(loss.item(), want_loss, atol=TOL.fwd,
                               rtol=TOL.fwd)
    for k, v in want_m.items():
        np.testing.assert_allclose(m[k].item(), v, atol=TOL.fwd,
                                   rtol=TOL.fwd, err_msg=k)
    assert m["moe_lb"].item() > 0 and m["moe_z"].item() > 0
    loss.backward()
    got = dict(zip(*flatten(params)))
    assert sorted(got) == sorted(want_g)
    for path, w in want_g.items():
        np.testing.assert_allclose(got[path].grad.numpy(), w, atol=TOL.grad,
                                   rtol=TOL.grad, err_msg=path)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_training_scans_the_ssd_mixers_and_runs_flash(ref, remat,
                                                      monkeypatch):
    """``apply_stack`` with ``train=True`` over the mixed period: each SSD
    block through the differentiable ``ssd_scan`` (again in a remat's
    recompute), never the forward-only kernel wrapper; the attention
    block through ``ops.flash``; prefill through the kernel wrapper."""
    model, params = _port(ref, remat)
    for v in flatten(params)[1]:
        v.requires_grad_(True)
    calls = {"scan": 0, "kernel": 0, "flash": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(mamba2, "ssd_scan", count("scan", mamba2.ssd_scan))
    monkeypatch.setattr(mamba2, "ssd_kernel",
                        count("kernel", mamba2.ssd_kernel))
    monkeypatch.setattr(attention, "flash", count("flash", attention.flash))
    tokens = torch.tensor(ref["tokens"])
    model.loss_fn(params, {"tokens": tokens})[0].backward()
    runs = 1 if remat == "none" else 2          # the recompute
    assert calls == {"scan": 3 * runs, "kernel": 0, "flash": runs}
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens})
    assert calls["kernel"] == 3


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_three_optimizer_steps_match_reference(ref, name):
    model, params = _port(ref, "full")
    o = getattr(torch_opt, name)(lr=LR)
    state = o.init(params)
    step = planner.compile_plan(model, None).train_step_fn(o)
    batch = {"tokens": torch.tensor(ref["tokens"])}
    losses = []
    for i in range(STEPS):
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref[name], atol=TOL.fwd,
                               rtol=TOL.fwd)


def test_train_driver_losses_match_reference_loop(tmp_path):
    """``train --arch jamba-v0.1-52b --smoke --device cpu --optimizer
    adafactor`` (the reference's recipe for jamba) from the reference's
    step 0 against the reference's loop of its unmeshed pieces (the
    driver's schedule and token stream); ``moe_lb``/``moe_z`` reported."""
    steps, batch, seq = 3, 2, 64
    jm = ref_lm.build(jax_get_config(ARCH, smoke=True))
    params = jm.init(jax.random.key(0))
    sched = jax_opt.Schedule(base_lr=3e-4, warmup=min(100, steps // 10 + 1),
                             decay_steps=steps)
    o = jax_opt.adafactor(lr=sched)
    state = o.init(params)
    data_ = jax_pipeline.TokenPipeline(
        jax_pipeline.DataCfg(global_batch=batch, seq_len=seq,
                             vocab=jm.cfg.vocab, seed=0), host_id=0,
        n_hosts=1)
    JaxCheckpointManager(str(tmp_path)).save(
        0, {"params": params, "opt": state},
        extra={"data": data_.state_dict()})
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    want, want_lb = [], []
    for i in range(steps):
        (loss, m), g = grad_fn(params, {"tokens": jnp.asarray(
            data_.next_batch()["tokens"])})
        params, state = o.apply(g, state, params, i)
        want.append(float(loss))
        want_lb.append(float(m["moe_lb"]))
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--optimizer", "adafactor", "--steps", str(steps),
                      "--batch", str(batch), "--seq", str(seq),
                      "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == steps
    np.testing.assert_allclose(out["losses"], want, atol=TOL.grad,
                               rtol=TOL.grad)
    np.testing.assert_allclose(out["moe_lb"], want_lb, atol=TOL.grad,
                               rtol=TOL.grad)


def test_train_driver_auto_plans_jamba(tmp_path):
    """``train --auto`` prices jamba's graph and trains the plan it picks
    (one device: no split), with the losses of the run without it."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "64"]
    plain = train.main(argv + ["--ckpt-dir", str(tmp_path / "plain")])
    auto = train.main(argv + ["--auto", "--ckpt-dir", str(tmp_path / "a")])
    assert auto["strategy"] == plain["strategy"]
    np.testing.assert_allclose(auto["losses"], plain["losses"], atol=0,
                               rtol=0)
